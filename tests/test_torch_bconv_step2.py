"""The port's two-step base conversion (ops/bconv.py) vs the JAX package,
bit for bit (tolerance 0): `bconv_step2_plain`, the plain version of
kernel B5, against JAX `bconv_step2` (Montgomery graph form) and
`bconv_step2_pallas(..., interpret=True)` (the TPU kernel B5 replaces), at
nd from 2 to 29 input rows whose last row is the centering count v, as
tests/test_pallas_kernels.py builds the inputs; output primes sit above
and below the input primes, so inputs may exceed an output prime."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homulator_tpu import numtheory as nt
from homulator_tpu.ops.bconv import bconv_step1 as jax_step1
from homulator_tpu.ops.bconv import bconv_step2 as jax_step2
from homulator_tpu.ops.bconv_pallas import bconv_step2_pallas
from homulator_tpu_torch.ops.bconv import (
    bconv_step1, bconv_step2, bconv_step2_plain,
)
from homulator_tpu_torch.ops.bconv_fused import build_bf16_tables, mma_table

N = 1024
M_OUT = 5


def _t(a):
    """uint32-range numpy -> int32 CPU tensor with the same bits."""
    return torch.from_numpy(np.asarray(a, dtype=np.uint64).astype(np.uint32)
                            .view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


def _mont(w, q):
    return ((w.astype(np.uint64) << np.uint64(32)) % q).astype(np.uint32)


def _qinv_neg(q):
    return np.array([(-pow(int(x), -1, 1 << 32)) % (1 << 32) for x in q],
                    dtype=np.uint32)


@pytest.fixture(scope="module")
def primes():
    """29 input primes of the band's low end, output primes at its top."""
    in_q = np.array(nt.gen_ntt_primes(2 * N, 29), dtype=np.uint64)
    out_q = np.array(nt.gen_ntt_primes(2 * N, M_OUT, start_bits=29),
                     dtype=np.uint64)
    return in_q, out_q


@pytest.mark.parametrize("nd", [2, 3, 8, 16, 17, 29])
def test_step2_plain_matches_jax_and_pallas(primes, nd):
    """nd rows in all: nd - 1 scaled residues and the count row v."""
    in_q, out_q = primes
    rng = np.random.default_rng(nd)
    xs = [rng.integers(0, q, size=N, dtype=np.uint64) for q in in_q[:nd - 1]]
    thr = (in_q[:nd - 1, None] >> np.uint64(1)) + np.uint64(1)
    v = (np.stack(xs) >= thr).sum(axis=0).astype(np.uint64)
    xhat = np.stack(xs + [v]).astype(np.uint32)
    mat = (rng.integers(0, 1 << 30, size=(M_OUT, nd)).astype(np.uint64)
           % out_q[:, None])
    mat_sh = ((mat << np.uint64(32)) // out_q[:, None]).astype(np.uint32)
    q = jnp.asarray(out_q.astype(np.uint32))
    want = np.asarray(jax_step2(
        jnp.asarray(xhat), jnp.asarray(_mont(mat, out_q[:, None])), q,
        jnp.asarray(_qinv_neg(out_q))))
    pallas = np.asarray(bconv_step2_pallas(
        jnp.asarray(xhat), jnp.asarray(mat.astype(np.uint32)),
        jnp.asarray(mat_sh), q, interpret=True))
    assert np.array_equal(want, pallas)
    got = bconv_step2_plain(_t(xhat), _t(mat), _t(out_q))
    assert got.dtype == torch.int32
    assert np.array_equal(_u32(got), want)
    # the wrapper takes the plain version for a CPU tensor, on any rank,
    # given the kernel's tables as the context builds them
    mbig, hsh = build_bf16_tables(mat, out_q)
    tiles = bconv_step2(_t(xhat).view(nd, 32, 32), _t(mat), mma_table(mbig),
                        hsh, _t(out_q))
    assert np.array_equal(_u32(tiles).reshape(M_OUT, N), want)


def test_step1_matches_jax(primes):
    in_q, _ = primes
    nd = 6
    rng = np.random.default_rng(0)
    x = np.stack([rng.integers(0, q, size=(32, 32), dtype=np.uint64)
                  for q in in_q[:nd]]).astype(np.uint32)
    s = rng.integers(1, in_q[:nd]).astype(np.uint64)
    s_sh = (s << np.uint64(32)) // in_q[:nd]
    want = np.asarray(jax_step1(
        jnp.asarray(x), jnp.asarray(_mont(s, in_q[:nd])),
        jnp.asarray(in_q[:nd].astype(np.uint32)),
        jnp.asarray(_qinv_neg(in_q[:nd]))))
    got = bconv_step1(_t(x), _t(s), _t(s_sh), _t(in_q[:nd]))
    assert np.array_equal(got.numpy().astype(np.uint32), want)


def test_plain_rejects_mismatched_matrix(primes):
    _, out_q = primes
    with pytest.raises(ValueError, match="input rows"):
        bconv_step2_plain(torch.zeros((3, 8), dtype=torch.int32),
                          torch.zeros((M_OUT, 4), dtype=torch.int32),
                          _t(out_q))
