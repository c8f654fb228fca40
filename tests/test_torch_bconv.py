"""Port base conversion (plain PyTorch version of kernel B3) vs the JAX
package's `bconv_fused` in interpret mode, bit for bit (tolerance 0): a
centered ModUp digit (full and partial), the fused-tail shape, and the
nd = 31 range stress of test_pallas_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homulator_tpu import numtheory as nt
from homulator_tpu.context import DeviceContext as JaxContext
from homulator_tpu.ops.bconv_fused import bconv_fused as jax_bconv
from homulator_tpu.ops.bconv_fused import build_bf16_tables
from homulator_tpu.params import get_params
from homulator_tpu_torch.context import DeviceContext
from homulator_tpu_torch.ops.bconv_fused import bconv_fused, bconv_plain

LEVEL = 5  # alpha 2: digits (0,2) (2,4) (4,5) -- the last one partial


@pytest.fixture(scope="module")
def tables():
    p = get_params(n=256, max_level=6, alpha=2)
    return (p, JaxContext(p, ntt_mode="interpret").keyswitch_tables(LEVEL),
            DeviceContext(p, "cpu").keyswitch_tables(LEVEL))


def _u32(t):
    return t.numpy().view(np.uint32)


def _rows(q, shape, seed):
    rng = np.random.default_rng(seed)
    q = np.asarray(q, dtype=np.int64)
    return rng.integers(0, q[:, None, None], size=(len(q),) + shape,
                        dtype=np.int64).astype(np.uint32)


@pytest.mark.parametrize("d", [0, 1, 2])
def test_modup_digit_matches_jax(tables, d):
    p, jkt, kt = tables
    jd, dt = jkt.digits[d], kt.digits[d]
    assert (dt.lo, dt.hi) == (jd.lo, jd.hi)
    for ours, theirs in ((dt.step1, jd.step1_pl), (dt.step1_sh, jd.step1_sh),
                         (dt.other_nt.q, jd.other_nt.q)):
        assert np.array_equal(_u32(ours), np.asarray(theirs))
    t = p.ntt
    x = _rows(p.q_arr[dt.lo:dt.hi], (t.n1, t.n2), seed=d)
    want = np.asarray(jax_bconv(
        jnp.asarray(x), jd.step1_pl, jd.step1_sh, jkt.main_nt.q[dt.lo:dt.hi],
        jd.mat_bf16, jd.horner_sh, jd.other_nt.q, interpret=True,
        center=True))
    got = bconv_fused(torch.from_numpy(x.view(np.int32)), dt.step1,
                      dt.step1_sh, dt.in_q, dt.mat, dt.mat_mma, dt.horner_sh,
                      dt.other_nt.q, center=True)
    assert np.array_equal(_u32(got), want)


def test_tail_matches_jax(tables):
    """The fused ModDown + rescale conversion: identity step 1, explicit
    v_b / w / indicator rows, no in-kernel centering."""
    p, jkt, kt = tables
    jt, tt = jkt.tail, kt.tail
    for ours, theirs in ((tt.in_q, jt.in_q), (tt.one_sh, jt.one_sh),
                         (tt.out_nt.q, jt.out_nt.q), (tt.p_modq, jt.p_pl),
                         (tt.pq_inv, jt.pq_inv_pl),
                         (tt.md2_last, jt.md2_last_pl)):
        assert np.array_equal(_u32(ours), np.asarray(theirs))
    t = p.ntt
    x = _rows(_u32(tt.in_q), (t.n1, t.n2), seed=7)
    want = np.asarray(jax_bconv(
        jnp.asarray(x), jt.one_pl, jt.one_sh, jt.in_q, jt.bf16, jt.horner_sh,
        jt.out_nt.q, interpret=True))
    got = bconv_fused(torch.from_numpy(x.view(np.int32)), tt.one, tt.one_sh,
                      tt.in_q, tt.mat, tt.mma, tt.horner_sh, tt.out_nt.q)
    assert np.array_equal(_u32(got), want)


def test_max_digit_stress_nd31():
    """nd = 31 inputs (the bf16 kernel's largest: set A's tail) over primes
    from both ends of the band, against bconv_fused and exact integers."""
    rng = np.random.default_rng(123)
    n1 = n2 = 16
    nd, m_out = 31, 8
    in_q = np.array(nt.gen_ntt_primes(64, nd), dtype=np.uint64)
    out_q = np.array(nt.gen_ntt_primes(64, m_out, start_bits=29),
                     dtype=np.uint64)
    mat = rng.integers(0, out_q.min(), size=(m_out, nd)).astype(np.uint64)
    s = rng.integers(1, in_q, size=nd).astype(np.uint64)
    x = np.stack([rng.integers(0, q, size=(n1, n2), dtype=np.uint64)
                  for q in in_q]).astype(np.uint32)
    bf16, hsh = build_bf16_tables(mat, out_q)
    s_sh = ((s << np.uint64(32)) // in_q).astype(np.uint32)
    want = np.asarray(jax_bconv(
        jnp.asarray(x), jnp.asarray(s.astype(np.uint32)), jnp.asarray(s_sh),
        jnp.asarray(in_q.astype(np.uint32)), bf16, hsh,
        jnp.asarray(out_q.astype(np.uint32)), interpret=True))

    def t(a):
        return torch.from_numpy(np.asarray(a, dtype=np.uint64)
                                .astype(np.uint32).view(np.int32))

    got = _u32(bconv_plain(t(x), t(s), t(s_sh), t(in_q), t(mat), t(out_q),
                           False))
    assert np.array_equal(got, want)
    xh = (x.astype(object) * s[:, None, None].astype(object)) % in_q[
        :, None, None].astype(object)
    for j in range(m_out):
        acc = sum(int(mat[j, i]) * xh[i] for i in range(nd))
        assert np.array_equal(got[j].astype(object), acc % int(out_q[j])), j


def test_plain_rejects_mismatched_matrix(tables):
    _, _, kt = tables
    dt = kt.digits[0]
    x = torch.zeros((dt.hi - dt.lo, 4, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="center"):
        bconv_plain(x, dt.step1, dt.step1_sh, dt.in_q, dt.mat,
                    dt.other_nt.q, False)
