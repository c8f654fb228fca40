"""Kernels B1 and B2 (csrc/ntt.cu on csrc/ntt_reg.cuh's register passes)
around what the CPU can run: the tile width that
`ops/ntt_kernels.py::radix_phases` picks and the launch geometry the
kernel derives from it, the shared-memory tile layout of `tile_at`, and a
plain int64 model of the kernels' schedule (the two register passes with
their row sets and twiddle indices, the exchange, Harvey's lazy ranges
asserted after every butterfly and product, one reduction before each
store), bit for bit (tolerance 0) against the plain versions `ntt_plain` /
`intt_plain`, which tests/test_torch_ntt.py holds against the JAX package,
and operation for operation against the count the bound divides
(`benchlib.radix_ntt_ops`). The primes are the parameters' own, the
largest below numtheory.PRIME_CAP (2^32/6), where 4q comes closest to
2^32."""

import collections
import os
import re

import numpy as np
import pytest
import torch

from homulator_tpu_torch import benchlib
from homulator_tpu_torch import numtheory as nt
from homulator_tpu_torch.context import DeviceContext
from homulator_tpu_torch.ops.ntt import intt_plain, ntt_plain
from homulator_tpu_torch.ops.ntt_kernels import (
    MIN_BLOCKS, TILE_COLS, radix_phases, radix_tile_cols,
)
from homulator_tpu_torch.params import get_params

SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block can take
MASK32 = 0xFFFFFFFF
NTT_REG = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "homulator_tpu_torch", "csrc", "ntt_reg.cuh")

# the rows a set-B (N = 2^16) B1 / B2 launch takes on the main path (45,
# 35, 15): label -> (rows, forward?, at least this many blocks a phase)
MAIN_PATH = {
    "B1 main M=35 rep=2": (70, True, MIN_BLOCKS),
    "B1 ext M=50 rep=2": (100, True, MIN_BLOCKS),
    "B1 special M=15 rep=2": (30, True, MIN_BLOCKS),
    "B1 digit0 other M=35 rep=1": (35, True, MIN_BLOCKS),
    "B1 digit2 other M=45 rep=1": (45, True, MIN_BLOCKS),
    "B1 tail out M=34 rep=2": (68, True, MIN_BLOCKS),
    "B2 main M=35 rep=2": (70, False, MIN_BLOCKS),
    "B2 ext M=50 rep=2": (100, False, MIN_BLOCKS),
    "B2 special M=15 rep=2": (30, False, MIN_BLOCKS),
    "B2 main M=35 rep=1": (35, False, MIN_BLOCKS),
    "B2 tail last M=1 rep=2": (2, False, 128),
}
# ring degrees of the configs (tiny.cfg, n15.cfg, n16.cfg), chip_smoke's
# oracle (2^13) and 2^14
CONFIG_LOGN = (8, 13, 14, 15, 16)


def _max_tile_cols():
    """RadixSplit's kMaxTileCols, which launch_radix enforces."""
    with open(NTT_REG) as f:
        return int(re.search(r"kMaxTileCols = (\d+);", f.read()).group(1))


def _smem_bytes(n, tc):
    """csrc/ntt_reg.cuh::radix_smem_words<L>(tc) in bytes: the twiddle pair
    (2n words) and the tile, padded by a row after every 2^LA rows."""
    _, _, _, U = _split(n.bit_length() - 1)
    return 4 * (2 * n + (n + U) * tc)


def _geometry_ok(rows, n, ncols, tc):
    """The launch that launch_radix makes of TC fits a block: threads,
    shared memory, whole tiles; returns its block count."""
    _, lb, _, _ = _split(n.bit_length() - 1)
    assert (tc << lb) <= 1024
    assert tc <= max(TILE_COLS) <= _max_tile_cols()
    assert _smem_bytes(n, tc) <= SMEM_LIMIT
    assert ncols % tc == 0 and tc & (tc - 1) == 0
    return rows * (ncols // tc)


@pytest.mark.parametrize("label", list(MAIN_PATH))
def test_geometry_fills_the_card_on_the_main_path(label):
    rows, fwd, least = MAIN_PATH[label]
    for n, ncols, tc in radix_phases(rows, 256, 256, fwd):
        assert _geometry_ok(rows, n, ncols, tc) >= least


@pytest.mark.parametrize("logn", CONFIG_LOGN)
def test_geometry_fits_a_block_at_the_configs_sizes(logn):
    p = get_params(n=1 << logn, max_level=2, alpha=1)
    n1, n2 = p.ntt.n1, p.ntt.n2
    for rows in (1, 2, 3, 15, 30, 35, 45, 68, 100, 200):
        for fwd in (True, False):
            (na, ca, _), (nb, cb, _) = phases = radix_phases(rows, n1, n2,
                                                             fwd)
            assert (na, ca, nb, cb) == ((n1, n2, n2, n1) if fwd
                                        else (n2, n1, n1, n2))
            for n, ncols, tc in phases:
                _geometry_ok(rows, n, ncols, tc)


@pytest.mark.parametrize("L", range(1, 11))
def test_geometry_and_tile_layout_at_every_axis_length(L):
    """At every n = 2^L the kernels take: the geometry fits a block for
    any row count and column count, and the tile layout of
    csrc/ntt_reg.cuh::tile_at is one to one into the tile's words of
    _smem_bytes, with no bank conflict in either row set of a warp."""
    n = 1 << L
    la, lb, R, U = _split(L)
    for ncols in (2, 4, 16, 32, 256, 1024):
        for rows in (1, 2, 35, 200):
            _geometry_ok(rows, n, ncols, radix_tile_cols(rows, n, ncols))
    for logtc in range(6):
        tc = 1 << logtc
        addr = _tile_at(torch.arange(n)[:, None], torch.arange(tc)[None, :],
                        la, logtc)
        assert addr.unique().numel() == n * tc
        assert 4 * (2 * n + int(addr.max()) + 1) <= _smem_bytes(n, tc)
        tid = torch.arange(tc * U)
        cc, u = tid & (tc - 1), tid >> logtc
        for rows_of in (lambda t: u + U * t, lambda t: u * R + t):
            for t in range(R):
                a = _tile_at(rows_of(t), cc, la, logtc)
                for w0 in range(0, tc * U, 32):
                    banks = a[w0: w0 + 32] % 32
                    assert banks.unique().numel() == banks.numel()


# ---- the plain model of the kernels' schedule ------------------------------
def _split(L):
    """RadixSplit<L>: strided-pass bits LA, unit bits LB, R = 2^LA values a
    thread, U = 2^LB threads a column."""
    la, lb = (L + 1) // 2, L // 2
    return la, lb, 1 << la, 1 << lb


def _tile_at(i, c, la, logtc):
    return ((i + (i >> la)) << logtc) + c


# the primitives the model ran since the last clear(), by benchlib.OPS key
_COUNT = collections.Counter()


def _count(kind, v, times=1):
    _COUNT[kind] += times * v.numel()


def _bound(v, hi):
    assert bool(((v >= 0) & (v < hi)).all()), "lazy range left"


def _csub(a, m):
    return torch.where(a >= m, a - m, a)


def _lazy(a, w, w_sh, q):
    """shoup_mul_lazy on exact integers: a*w - floor(a*w_sh / 2^32)*q for
    any uint32 a, in [0, 2q) (the high word split at 16 bits, so no int64
    product wraps); uint32 arithmetic gives the same value mod 2^32."""
    _bound(a, 1 << 32)
    hi = ((a >> 16) * w_sh + (((a & 0xFFFF) * w_sh) >> 16)) >> 16
    r = a * w - hi * q
    _bound(r, 2 * q)
    return r


def _ct(x, y, w, w_sh, q, mul=_lazy):
    """ct_lazy; mul: the form of the lazy Shoup product (ct_lazy's Mul),
    in [0, 2q) for any uint32."""
    _bound(x, 4 * q)
    _count("lazy_butterfly", x)
    a = _csub(x, 2 * q)
    t = mul(y, w, w_sh, q)
    x, y = a + t, a - t + 2 * q
    _bound(x, 4 * q)
    _bound(y, 4 * q)
    return x, y


def _gs(x, y, w, w_sh, q):
    _bound(x, 2 * q)
    _bound(y, 2 * q)
    _count("lazy_butterfly", x)
    x, y = _csub(x + y, 2 * q), _lazy(x - y + 2 * q, w, w_sh, q)
    _bound(x, 2 * q)
    return x, y


def _pass(v, off, lr, s0, g, tw, q, fwd, mul=_lazy):
    """ct_pass (fwd) / gs_pass on the values v[off: off + 2^lr], each
    [rows, U, ncols]; g [U, 1]: the index bits above the pass, a thread's
    own; tw: the stage row and its Shoup row, [rows, n] each; mul: the CT
    butterflies' product form (ct_pass's Mul)."""
    stages = range(lr) if fwd else range(lr - 1, -1, -1)
    for s in stages:
        h = 1 << (lr - 1 - s)
        for b in range(1 << s):
            k = ((1 << (s0 + s)) + (g << s) + b)[:, 0]
            w, w_sh = tw[0][:, k, None], tw[1][:, k, None]
            for j in range(h):
                i0 = off + 2 * b * h + j
                v[i0], v[i0 + h] = (
                    _ct(v[i0], v[i0 + h], w, w_sh, q, mul) if fwd
                    else _gs(v[i0], v[i0 + h], w, w_sh, q))


def _rows(L):
    """A thread's row sets at axis 2^L, each [U, 1] by value t < R: the
    strided rows u + U*t and the contiguous rows u*R + t."""
    _, _, R, U = _split(L)
    u = torch.arange(U)[:, None]
    return [u + U * t for t in range(R)], [u * R + t for t in range(R)]


def _ct_rows(v, L, ncols, tw, q, mul=_lazy):
    """csrc/ntt_reg.cuh::radix_ct_rows<L, Mul> on every column at once: v,
    the values of the strided rows (each [rows, U, ncols], below 4q) -> the
    values of the contiguous rows after all L CT stages, in [0, 4q); mul:
    the product form (Mul, default ShoupLazy)."""
    la, lb, R, U = _split(L)
    n, sub = 1 << L, R >> lb
    u = torch.arange(U)[:, None]
    strided, contig = _rows(L)
    _pass(v, 0, la, 0, torch.zeros_like(u), tw, q, True, mul)
    tile = torch.empty((v[0].shape[0], n, ncols), dtype=torch.int64)
    for t, i in enumerate(strided):
        tile[:, i[:, 0]] = v[t]
    v = [tile[:, i[:, 0]] for i in contig]
    for k in range(sub):
        _pass(v, k << lb, lb, la, u * sub + k, tw, q, True, mul)
    return v


def _gs_rows(v, L, ncols, tw, q):
    """csrc/ntt_reg.cuh::radix_gs_rows<L> on every column at once: v, the
    values of the contiguous rows (each [rows, U, ncols], below 2q) -> the
    values of the strided rows after all L GS stages, in [0, 2q)."""
    la, lb, R, U = _split(L)
    n, sub = 1 << L, R >> lb
    u = torch.arange(U)[:, None]
    strided, contig = _rows(L)
    for k in range(sub):
        _pass(v, k << lb, lb, la, u * sub + k, tw, q, False)
    tile = torch.empty((v[0].shape[0], n, ncols), dtype=torch.int64)
    for t, i in enumerate(contig):
        tile[:, i[:, 0]] = v[t]
    v = [tile[:, i[:, 0]] for i in strided]
    _pass(v, 0, la, 0, torch.zeros_like(u), tw, q, False)
    return v


def _phase(x, L, ncols, q, tw, mid, fwd, transposed):
    """radix_phase<L, fwd, transposed> on every column tile at once: x
    int64 [rows, 2^L * ncols] -> y, the same size, in [0, q)."""
    n = 1 << L
    col = torch.arange(ncols)[None, :]
    q = q[:, None, None]
    strided, contig = _rows(L)

    def at(i):  # flat index on the untransposed side, [U, ncols]
        return i * ncols + col

    if fwd:
        v = _ct_rows([x[:, at(i)] for i in strided], L, ncols, tw, q)
    else:
        if not transposed:
            v = [x[:, at(i)] for i in contig]
        else:
            v = [_lazy(x[:, col * n + i], mid[0][:, at(i)],
                       mid[1][:, at(i)], q) for i in contig]
            _count("lazy_shoup", x)
        v = _gs_rows(v, L, ncols, tw, q)
    second = contig if fwd else strided
    y = torch.empty_like(x)
    if fwd and transposed:
        _count("lazy_shoup", y)
    _count("csub", y, 2 if fwd and not transposed else 1)
    for t, i in enumerate(second):
        if fwd and transposed:
            y[:, col * n + i] = _csub(
                _lazy(v[t], mid[0][:, at(i)], mid[1][:, at(i)], q), q)
        elif fwd:
            y[:, at(i)] = _csub(_csub(v[t], 2 * q), q)
        else:
            y[:, at(i)] = _csub(v[t], q)
    _bound(y, q[:, 0])
    return y


def _tables(nb, rep):
    M = nb.q.shape[0]
    m = torch.arange(rep * M) % M

    def tab(*names):
        return tuple((getattr(nb, k).long() & MASK32)[m].reshape(rep * M, -1)
                     for k in names)
    return nb.q.long()[m], tab


def ntt_model(x, nb, rep):
    """B1 as its two launches: [rep*M, n1, n2] -> [rep*M, n2, n1]."""
    q, tab = _tables(nb, rep)
    L1, L2 = nb.n1.bit_length() - 1, nb.n2.bit_length() - 1
    s = _phase(x.long().reshape(q.shape[0], -1), L1, nb.n2, q,
               tab("tw1", "tw1_sh"), tab("mid", "mid_sh"), True, True)
    y = _phase(s, L2, nb.n1, q, tab("tw2", "tw2_sh"), None, True, False)
    return y.view(-1, nb.n2, nb.n1).to(torch.int32)


def intt_model(x, nb, rep):
    """B2 as its two launches: [rep*M, n2, n1] -> [rep*M, n1, n2]."""
    q, tab = _tables(nb, rep)
    L1, L2 = nb.n1.bit_length() - 1, nb.n2.bit_length() - 1
    s = _phase(x.long().reshape(q.shape[0], -1), L2, nb.n1, q,
               tab("itw2", "itw2_sh"), None, False, False)
    y = _phase(s, L1, nb.n2, q, tab("itw1", "itw1_sh"),
               tab("mid_inv", "mid_inv_sh"), False, True)
    return y.view(-1, nb.n1, nb.n2).to(torch.int32)


# (log2 N, rep): every axis length 2^1 .. 2^10 once (n1 = 2^floor(logN/2),
# n2 = N / n1), and rep 2 at the configs' n = 16 x 16, the oracle's 64 x 128
# and set B's 256 x 256
CASES = [(logn, 1) for logn in range(2, 21)] + [(8, 2), (13, 2), (16, 2)]


def _basis(logn):
    """M = 2: the largest prime (the first special) and the largest main."""
    p = get_params(n=1 << logn, max_level=2, alpha=1)
    nb = DeviceContext(p, "cpu").ntt_basis((p.max_level, 0))
    assert int(nb.q.min()) > nt.PRIME_CAP - (1 << 24)
    return nb


def _inputs(nb, rep, shape, seed):
    """Residues in [0, q), the first row of each copy all q - 1."""
    q = np.tile(nb.q.numpy().astype(np.int64), rep)
    x = np.random.default_rng(seed).integers(0, q[:, None, None],
                                             size=(len(q),) + shape)
    x[:: nb.q.shape[0]] = q[0] - 1
    return torch.from_numpy(x).to(torch.int32)


@pytest.mark.parametrize("logn,rep", CASES)
def test_ntt_model_matches_plain(logn, rep):
    nb = _basis(logn)
    x = _inputs(nb, rep, (nb.n1, nb.n2), seed=logn)
    assert torch.equal(ntt_model(x, nb, rep), ntt_plain(x, nb, rep))


@pytest.mark.parametrize("logn,rep", CASES)
def test_intt_model_matches_plain(logn, rep):
    nb = _basis(logn)
    x = _inputs(nb, rep, (nb.n2, nb.n1), seed=100 + logn)
    assert torch.equal(intt_model(x, nb, rep), intt_plain(x, nb, rep))


@pytest.mark.parametrize("logn", (2, 7, 13))
@pytest.mark.parametrize("fwd", (True, False), ids=("B1", "B2"))
def test_model_does_the_operations_the_bound_counts(logn, fwd):
    """chip_smoke's B1/B2 bound counts what the schedule does: the
    model's butterflies, lazy products and conditional subtracts, at
    benchlib.OPS each, are benchlib.radix_ntt_ops."""
    nb = _basis(logn)
    shape = (nb.n1, nb.n2) if fwd else (nb.n2, nb.n1)
    x = _inputs(nb, 1, shape, seed=logn)
    _COUNT.clear()
    (ntt_model if fwd else intt_model)(x, nb, 1)
    n, rows = 1 << logn, nb.q.shape[0]
    assert _COUNT["lazy_butterfly"] == rows * n // 2 * logn
    assert (sum(benchlib.OPS[k] * c for k, c in _COUNT.items())
            == benchlib.radix_ntt_ops(rows, n, fwd))
