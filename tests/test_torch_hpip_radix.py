"""Kernel B4 (csrc/hpip.cu on csrc/ntt_reg.cuh's register passes) around
what the CPU can run: a plain int64 model of its two launches, built on
the radix-pass model of tests/test_torch_ntt_radix.py (B1's phase A on
each converted row with the tables of the ext row it lifts to; then, for
every ext row, the digit loop of phase B: the strided and contiguous CT
passes of radix_ct_rows on a converted row, or the digit's own row from
d_eval, and the lazy Montgomery accumulate of both key components), held
bit for bit (tolerance 0) against the plain version `hpip_plain` and the
JAX `hpip_acc` (its Pallas kernel `hpip_fused` in interpret mode, as
tests/test_torch_hpip.py runs it), with every lazy margin asserted: each
CT output below 4q, each Montgomery product below 2q, each running sum
below 4q < 2^32. The worst case (every piece, own-row and key word q - 1)
is among the cases; the primes are the parameters' own, all just below
numtheory.PRIME_CAP (2^32/6). The model does the operations that
chip_smoke's bound counts (benchlib.hpip_ops), and the tile widths of
`ops/hpip.py::hpip_phases` fit a block."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homulator_tpu.api import CkksEngine as JaxEngine
from homulator_tpu.ops import keyswitch as jks
from homulator_tpu.params import get_params
from homulator_tpu_torch import benchlib
from homulator_tpu_torch import numtheory as nt
from homulator_tpu_torch.context import DeviceContext, from_jax_state
from homulator_tpu_torch.ops import keyswitch as ks
from homulator_tpu_torch.ops.hpip import hpip_phases, hpip_plain
from homulator_tpu_torch.ops.ntt_kernels import MIN_BLOCKS

from .conftest import random_limbs
from .test_torch_ntt_radix import (
    _COUNT, MASK32, _bound, _count, _csub, _ct_rows, _geometry_ok, _phase,
    _rows, _split,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# n1 = 16 (an even axis: R = U = 4), n2 = 32 (an odd one: R = 8, U = 4,
# two contiguous units a thread); digits of alpha = 2 rows
PARAMS = dict(n=512, max_level=6, alpha=2)
# level 6: three full digits; 5: (0,2) (2,4) (4,5), a last digit of one
# row; 3: (0,2) (2,3)
LEVELS = (6, 5, 3)


def _ext_row(l, own_lo, nd):
    """csrc/hpip.cu::ext_row: the ext row of conv-local row l."""
    return l if l < own_lo else l + nd


def _mont_acc(acc, v, b, q, qinv):
    """csub(acc + mont_mul_lazy(v, b), 2q) on exact integers, each margin
    asserted: v < 4q (a CT output or an own row), b < q, acc < 2q; the
    product (v*b + m*q) / 2^32 < 2q, the sum < 4q < 2^32. The low-word
    product m is split at 16 bits so that no int64 product wraps."""
    _bound(v, 4 * q)
    _bound(b, q)
    _bound(acc, 2 * q)
    assert bool((4 * q < 1 << 32).all())
    t = v * b  # < 4q^2 < 2^61
    lo = t & MASK32
    m = (lo * (qinv & 0xFFFF) + (((lo * (qinv >> 16)) & 0xFFFF) << 16)) \
        & MASK32
    s = t + m * q  # < 2^61 + 2^62
    assert not bool((s & MASK32).any()), "Montgomery low word not zero"
    p = s >> 32
    _bound(p, 2 * q)
    acc = acc + p
    _bound(acc, 4 * q)
    _count("lazy_mont_mac", v)
    return _csub(acc, 2 * q)


def hpip_model(convs, d_eval, key, kt):
    """B4 as its two launches: the phase-A scratch, then phase B on every
    ext row at once. Same arguments and result as hpip_plain."""
    nb = kt.ext_nt
    alpha = kt.special_nt.q.shape[0]
    level = kt.level
    K = alpha + level
    n1, n2 = nb.n1, nb.n2
    L1, L2 = n1.bit_length() - 1, n2.bit_length() - 1
    q = nb.q.long()
    qinv = kt.ext_qinv.long() & MASK32

    def tab(rows, *names):
        return tuple((getattr(nb, k).long() & MASK32)[rows].reshape(
            len(rows), -1) for k in names)

    # phase A: row l of digit d's pieces through B1's phase A with the
    # tables of its ext row -> the digit's scratch rows [n2, n1]
    scratch = []
    for conv, dt in zip(convs, kt.digits):
        rs = torch.tensor([_ext_row(l, alpha + dt.lo, dt.hi - dt.lo)
                           for l in range(conv.shape[0])])
        scratch.append(_phase(conv.long().reshape(len(rs), -1), L1, n2,
                              q[rs], tab(rs, "tw1", "tw1_sh"),
                              tab(rs, "mid", "mid_sh"), True, True))
    # phase B: ext row r, the digits in order
    _, _, R, U = _split(L2)
    strided, contig = _rows(L2)
    col = torch.arange(n1)[None, :]
    r = torch.arange(K)
    qb, qib = q[:, None, None], qinv[:, None, None]
    acc = [[torch.zeros((K, U, n1), dtype=torch.int64) for _ in range(R)]
           for _ in range(2)]
    d_rows = d_eval.long().reshape(level, -1) & MASK32
    for d, dt in enumerate(kt.digits):
        own_lo, own_hi = alpha + dt.lo, alpha + dt.hi
        own = (r >= own_lo) & (r < own_hi)
        rc = r[~own]
        l = torch.where(rc < own_lo, rc, rc - (own_hi - own_lo))
        x = scratch[d][l]
        _bound(x, q[rc][:, None])
        vc = _ct_rows([x[:, i * n1 + col] for i in strided], L2, n1,
                      tab(rc, "tw2", "tw2_sh"), qb[rc])
        xo = d_rows[r[own] - alpha]
        v = []
        for t, i in enumerate(contig):
            vt = torch.empty((K, U, n1), dtype=torch.int64)
            vt[rc] = vc[t]
            vt[own] = xo[:, i * n1 + col]
            v.append(vt)
        for k in range(2):
            kk = key[d, k, :K].long().reshape(K, -1) & MASK32
            for t, i in enumerate(contig):
                acc[k][t] = _mont_acc(acc[k][t], v[t], kk[:, i * n1 + col],
                                      qb, qib)
    out = torch.empty((2, K, n2 * n1), dtype=torch.int64)
    for k in range(2):
        for t, i in enumerate(contig):
            out[k][:, i * n1 + col] = _csub(acc[k][t], qb)
            _count("csub", acc[k][t])
    _bound(out, q[None, :, None])
    return out.view(2, K, n2, n1).to(torch.int32)


@pytest.fixture(scope="module")
def ctx():
    """The JAX engine on its Pallas kernels in interpret mode, and the
    port's CPU context with the JAX engine's relinearisation key."""
    p = get_params(**PARAMS)
    assert int(p.q_arr.min()) > nt.PRIME_CAP - (1 << 24)
    ep = JaxEngine(p, seed=17, ntt_mode="interpret")
    ep.keygen()
    dc = DeviceContext(p, "cpu")
    key = from_jax_state({"k": np.asarray(ep.relin_key)}, dc)["k"]
    return ep, dc, key


def _u32(t):
    return t.numpy().view(np.uint32)


def _check(ep, dc, level, convs, d_np, key_np):
    """The model, hpip_plain and the JAX hpip_acc on the same pieces, own
    rows and key: equal bits. Returns the model's result."""
    kt = dc.keyswitch_tables(level)
    d_eval, key = (from_jax_state({"d": d_np, "k": key_np}, dc)[k]
                   for k in ("d", "k"))
    got = hpip_model(convs, d_eval, key, kt)
    want = hpip_plain(convs, d_eval, key, kt)
    assert torch.equal(got, want)
    jax_out = jks.hpip_acc([jnp.asarray(_u32(c)) for c in convs],
                           jnp.asarray(d_np), jnp.asarray(key_np),
                           ep.dc.keyswitch_tables(level))
    assert np.array_equal(_u32(got), np.asarray(jax_out))
    return got


@pytest.mark.parametrize("level", LEVELS)
def test_model_matches_plain_and_jax(ctx, level):
    """The ModUp pieces of random limbs and the JAX engine's key."""
    ep, dc, key = ctx
    p, t = ep.params, ep.params.ntt
    rng = np.random.default_rng(level)
    d_np = random_limbs(p, np.arange(level), rng).astype(np.uint32).reshape(
        level, t.n2, t.n1)
    kt = dc.keyswitch_tables(level)
    convs = ks.modup_convs_coeff(from_jax_state({"d": d_np}, dc)["d"], kt)
    assert [c.shape[0] for c in convs] == [
        p.alpha + level - (dt.hi - dt.lo) for dt in kt.digits]
    _check(ep, dc, level, convs, d_np, np.asarray(ep.relin_key))


@pytest.mark.parametrize("level", LEVELS)
def test_model_worst_case(ctx, level):
    """Every piece, own-row and key word q - 1: the largest terms and
    products; the margins hold and the bits still agree."""
    ep, dc, _ = ctx
    p, t = ep.params, ep.params.ntt
    kt = dc.keyswitch_tables(level)
    convs = [(dt.other_nt.q - 1).view(-1, 1, 1).expand(
        -1, t.n1, t.n2).contiguous() for dt in kt.digits]
    d_np = np.broadcast_to((p.q_arr[:level] - 1).astype(np.uint32)[
        :, None, None], (level, t.n2, t.n1)).copy()
    key_q = np.concatenate([p.q_arr[p.max_level:], p.q_arr[:p.max_level]])
    key_np = np.broadcast_to((key_q - 1).astype(np.uint32)[
        None, None, :, None, None], np.asarray(ep.relin_key).shape).copy()
    _check(ep, dc, level, convs, d_np, key_np)


def _load_root_module(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("level", LEVELS)
def test_model_does_the_operations_the_bound_counts(ctx, level):
    """chip_smoke's B4 bound counts what the schedule does: the model's
    Harvey butterflies, lazy products, Montgomery accumulates and
    conditional subtracts, at benchlib.OPS each, are benchlib.hpip_ops,
    the operations of chip_smoke.hpip_bound."""
    ep, dc, key = ctx
    p, t = ep.params, ep.params.ntt
    n = t.n1 * t.n2
    kt = dc.keyswitch_tables(level)
    K, beta = p.alpha + level, len(kt.digits)
    conv_rows = sum(K - (dt.hi - dt.lo) for dt in kt.digits)
    d_eval = torch.zeros((level, t.n2, t.n1), dtype=torch.int32)
    convs = ks.modup_convs_coeff(d_eval, kt)
    _COUNT.clear()
    hpip_model(convs, d_eval, key, kt)
    assert _COUNT["lazy_butterfly"] == conv_rows * n // 2 * (
        n.bit_length() - 1)
    assert _COUNT["lazy_mont_mac"] == beta * 2 * K * n
    ops = sum(benchlib.OPS[k] * c for k, c in _COUNT.items())
    assert ops == benchlib.hpip_ops(conv_rows, K, beta, n)
    nbytes = 4 * (conv_rows * n + level * n + beta * 2 * K * n + 2 * K * n
                  + 2 * K * (t.n1 + t.n2) + 2 * K + 2 * K * n)
    chip_smoke = _load_root_module("chip_smoke")
    assert chip_smoke.hpip_bound(kt) == benchlib.bound(nbytes, ops)


@pytest.mark.parametrize("logn", (8, 9, 13, 15, 16))
def test_phases_fit_a_block(logn):
    """hpip_phases' tile widths at every level of a ring up to N = 2^16
    (both axes at most 256, csrc/hpip.cu kMaxLog): both launches fit a
    block of at most 256 threads (phase B's register cap of 128 at two
    blocks an SM), and at set B (N = 2^16, alpha 15) both fill the card
    at levels 35, 31 and 20."""
    from homulator_tpu_torch.params import get_params as port_params

    pp = port_params(n=1 << logn, max_level=45, alpha=15)
    n1, n2 = pp.ntt.n1, pp.ntt.n2
    assert max(n1, n2) <= 256
    for level in range(1, 46):
        K = 15 + level
        digits = [(lo, min(lo + 15, level)) for lo in range(0, level, 15)]
        conv_rows = sum(K - (hi - lo) for lo, hi in digits)
        tc_a, tc_b = hpip_phases(conv_rows, K, n1, n2)
        blocks_a = _geometry_ok(conv_rows, n1, n2, tc_a)
        blocks_b = _geometry_ok(K, n2, n1, tc_b)
        assert tc_b << ((n2.bit_length() - 1) // 2) <= 256
        if logn == 16 and level in (35, 31, 20):
            assert min(blocks_a, blocks_b) >= MIN_BLOCKS
