"""The stage kernels of the NTT anatomy (csrc/anatomy.cu::stages_radix<L,
Mul, kRuns, kT>, on csrc/ntt_reg.cuh's register passes: B14's stages1 and
stages2x, B15's three Shoup forms, B16's stages1) around what the CPU can
run: a plain int64 model of their schedule, for one run or two, with the
transposed or the row-major store, and in each of the three forms of the
lazy Shoup product (csrc/modarith.cuh: ShoupLazy, ShoupNatmul,
ShoupApprox), bit for bit (tolerance 0) against `ntt_anatomy_plain`,
`ntt_components_plain` and `ntt_shoup_forms_plain`, and B15 against the
JAX `scripts/microbench_ntt2.py` kernels in interpret mode: its base
variant on the JAX context's tables, and its natmul variant on unswapped
tables.

The schedule: the strided rows, radix_ct_rows (tests/test_torch_ntt_radix
.py's model, with the form as its product); for a second run the
contiguous rows given back to the tile, the strided rows read again and
radix_ct_rows once more with no reduction between the runs; one reduction
from [0, 4q) to [0, q); the transposed store (column c, row i at c * n1 +
i) or the row-major one (row i, column c at i * n2 + c). The model runs
every column at once: a block's tile width TC only picks which columns
one block holds, and each column's values are the same at every TC, so
TC enters the geometry test alone. Every margin is asserted as it is
used: each form's product in [0, 2q) for any uint32 input; natmul's high
word the exact one; approx's short by at most 1, its product in [0, 3q)
(3q < 2^32) before the subtract of 2q, which the run must reach; every CT
value in [0, 4q). The primes are the largest below numtheory.PRIME_CAP
(2^32/6), where 4q comes closest to 2^32. The re-exchange takes one
barrier: the words a thread writes back are the ones it alone read."""

import numpy as np
import pytest
import torch

from homulator_tpu_torch import benchlib
from homulator_tpu_torch.ops import anatomy
from homulator_tpu_torch.ops.ntt_kernels import radix_phases

from .test_torch_anatomy import (  # noqa: F401 (ctx, mb2, b15_base: fixtures)
    _b15, _unswapped, b15_base, ctx, mb2,
)
from .test_torch_ntt_radix import (
    _COUNT, _basis, _bound, _count, _csub, _ct_rows, _geometry_ok, _inputs,
    _lazy, _rows, _split, _tables, _tile_at,
)

MASK32 = 0xFFFFFFFF
# the largest approx product seen, in units of q: the run must reach
# [2q, 3q), where its conditional subtract of 2q acts
_APPROX_MAX = [0.0]


def _halves(a, w_sh):
    return a & 0xFFFF, a >> 16, w_sh & 0xFFFF, w_sh >> 16


def _exact_hi(a, w_sh):
    """floor(a * w_sh / 2^32) without an int64 product that wraps."""
    return ((a >> 16) * w_sh + (((a & 0xFFFF) * w_sh) >> 16)) >> 16


def _natmul(a, w, w_sh, q):
    """ShoupNatmul::mul in uint32 arithmetic: the high word from four
    16-bit partial products and their carries, equal to the exact one,
    so the product lies in [0, 2q) for any uint32 a."""
    _bound(a, 1 << 32)
    a0, a1, b0, b1 = _halves(a, w_sh)
    ll, lh, hl, hh = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = (lh + hl) & MASK32
    carry_mid = (mid < lh).long()
    lo = (ll + (mid << 16)) & MASK32
    carry_lo = (lo < ll).long()
    hi = (hh + (mid >> 16) + (carry_mid << 16) + carry_lo) & MASK32
    assert torch.equal(hi, _exact_hi(a, w_sh))
    r = a * w - hi * q
    _bound(r, 2 * q)
    return r


def _approx(a, w, w_sh, q):
    """ShoupApprox::mul in uint32 arithmetic: three partial products, the
    high word short by at most 1, so a * w - hi * q lies in [0, 3q) (below
    2^32); one conditional subtract of 2q, to [0, 2q)."""
    _bound(a, 1 << 32)
    a0, a1, b0, b1 = _halves(a, w_sh)
    lh, hl, hh = a0 * b1, a1 * b0, a1 * b1
    mid = (lh + hl) & MASK32
    carry_mid = (mid < lh).long()
    hi = (hh + (mid >> 16) + (carry_mid << 16)) & MASK32
    short = _exact_hi(a, w_sh) - hi
    assert bool(((short == 0) | (short == 1)).all())
    r = a * w - hi * q
    _bound(r, 3 * q)
    assert bool((3 * q < 1 << 32).all())
    _APPROX_MAX[0] = max(_APPROX_MAX[0], float((r / q).max()))
    r = _csub(r, 2 * q)
    _bound(r, 2 * q)
    return r


MULS = {"production": _lazy, "natmul": _natmul, "approx": _approx}


def stages_model(x, nb, form="production", runs=2, transposed=True):
    """stages_radix<L, Mul, runs, transposed> on every column tile at
    once: x int32 [M, n1, n2] -> [M, n2, n1] (transposed) or [M, n1, n2]
    in [0, q)."""
    q, tab = _tables(nb, 1)
    M, n1, n2 = x.shape
    L = n1.bit_length() - 1
    col = torch.arange(n2)[None, :]
    q3 = q[:, None, None]
    tw = tab("tw1", "tw1_sh")
    strided, contig = _rows(L)
    xs = x.long().reshape(M, -1)
    mul = MULS[form]
    v = _ct_rows([xs[:, i * n2 + col] for i in strided], L, n2, tw, q3, mul)
    for _ in range(runs - 1):
        tile = torch.empty((M, n1, n2), dtype=torch.int64)  # back to strided
        for t, i in enumerate(contig):
            tile[:, i[:, 0]] = v[t]
        v = _ct_rows([tile[:, i[:, 0]] for i in strided], L, n2, tw, q3,
                     mul)
    y = torch.empty((M, n2 * n1), dtype=torch.int64)
    _count("csub", y, 2)
    for t, i in enumerate(contig):
        y[:, col * n1 + i if transposed else i * n2 + col] = _csub(
            _csub(v[t], 2 * q3), q3)
    _bound(y, q[:, None])
    return y.view(M, *((n2, n1) if transposed else (n1, n2))).to(torch.int32)


# the stage variants of B14 and B16 (production form): label -> (runs,
# transposed, plain version, the bound's operation count)
STAGE_VARIANTS = {
    "B14 stages1": (1, True, lambda x, nb: anatomy.ntt_anatomy_plain(
        x, nb, "stages1"), benchlib.radix_phase2_ops),
    "B14 stages2x": (2, True, lambda x, nb: anatomy.ntt_anatomy_plain(
        x, nb, "stages2x"), benchlib.shoup_forms_ops),
    "B16 stages1": (1, False, lambda x, nb: anatomy.ntt_components_plain(
        x, nb, "stages1"), benchlib.radix_phase2_ops),
}


def _wrapper(label, x, nb):
    """The wrapper's own CPU path of a stage variant."""
    kind, v = label.split()
    if kind == "B14":
        return anatomy.ntt_anatomy(x, nb, v)
    return anatomy.ntt_components(x, nb, v)


@pytest.mark.parametrize("label", list(STAGE_VARIANTS))
@pytest.mark.parametrize("L", range(3, 11))
def test_stages_model_matches_plain(L, label):
    """At n1 = n2 = 2^L (M = 2, the first row of each limb all q - 1):
    each stage variant's model equals its plain version and the wrapper's
    CPU path, the runs and the store as anatomy.py's table names them, and
    does the operations its bound counts."""
    runs, transposed, plain, ops = STAGE_VARIANTS[label]
    name, v = label.split()
    table = anatomy.B14_VARIANTS if name == "B14" else anatomy.B16_PARTS
    assert table[v] == (runs, False, transposed)
    nb = _basis(2 * L)
    assert nb.n1 == nb.n2 == 1 << L
    x = _inputs(nb, 1, (nb.n1, nb.n2), seed=L)
    _COUNT.clear()
    got = stages_model(x, nb, "production", runs, transposed)
    assert torch.equal(got, plain(x, nb))
    assert torch.equal(got, _wrapper(label, x, nb))
    assert (sum(benchlib.OPS[k] * c for k, c in _COUNT.items())
            == ops(2, nb.n1, nb.n2))


@pytest.mark.parametrize("label", list(STAGE_VARIANTS))
def test_stages_worst_case_margins(label):
    """Every input q - 1 at n1 = 1024 (the largest axis the production
    kernels take), q the largest primes below 2^32/6: the model's lazy
    margins hold (asserted at every butterfly) and it equals the plain
    version."""
    runs, transposed, plain, _ = STAGE_VARIANTS[label]
    nb = _basis(20)
    assert nb.n1 == 1 << 10
    assert bool((6 * nb.q.long() < 1 << 32).all())
    q = nb.q.long()[:, None, None]
    x = (q - 1).expand(-1, nb.n1, nb.n2).to(torch.int32).contiguous()
    got = stages_model(x, nb, "production", runs, transposed)
    assert torch.equal(got, plain(x, nb))


@pytest.mark.parametrize("form", anatomy.FORMS)
@pytest.mark.parametrize("L", range(3, 9))
def test_forms_model_matches_plain(L, form):
    """At n1 = n2 = 2^L (M = 2, the first row of each limb all q - 1):
    the model equals the plain version of every form, the wrapper's CPU
    path, and it does the operations the bound counts."""
    nb = _basis(2 * L)
    assert nb.n1 == nb.n2 == 1 << L
    x = _inputs(nb, 1, (nb.n1, nb.n2), seed=L)
    _COUNT.clear()
    got = stages_model(x, nb, form)
    assert torch.equal(got, anatomy.ntt_shoup_forms_plain(x, nb, form))
    assert torch.equal(got, anatomy.ntt_shoup_forms(x, nb, form))
    assert (sum(benchlib.OPS[k] * c for k, c in _COUNT.items())
            == benchlib.shoup_forms_ops(2, nb.n1, nb.n2))


def test_approx_reaches_its_subtract():
    """On the worst input (every word q - 1, n1 = 256) approx's product
    reaches [2q, 3q) before its conditional subtract, and the model still
    equals the plain version."""
    nb = _basis(16)
    q = nb.q.long()[:, None, None]
    x = (q - 1).expand(-1, nb.n1, nb.n2).to(torch.int32).contiguous()
    _APPROX_MAX[0] = 0.0
    got = stages_model(x, nb, "approx")
    assert 2 <= _APPROX_MAX[0] < 3
    assert torch.equal(got, anatomy.ntt_shoup_forms_plain(x, nb, "approx"))


@pytest.mark.parametrize("form", anatomy.FORMS)
def test_forms_model_matches_microbench_ntt2(ctx, mb2, b15_base, form):
    """At N = 2^12 (n1 = n2 = 64, three primes of the top band): each
    form's model equals microbench_ntt2's base variant on the JAX
    context's tables and its natmul variant on unswapped tables, tolerance
    0."""
    got = stages_model(ctx.tx, ctx.tnb, form).numpy().astype(np.int64)
    np.testing.assert_array_equal(b15_base.astype(np.int64), got)
    natmul = _b15(ctx, mb2, "natmul", _unswapped(ctx))
    np.testing.assert_array_equal(natmul % ctx.q[:, None, None], got)


@pytest.mark.parametrize("L", range(3, 11))
def test_forms_geometry_and_one_barrier_reexchange(L):
    """Every tile width TC = 1..16 at n1 = 2^L fits a block (threads,
    shared memory, whole tiles), the wrapper's own width (B1 phase A's) at
    M = 35 among them; and the words each thread writes back to the tile
    between the runs (its contiguous rows) are the ones it read at the
    end of the first run and no other thread's, so no barrier is needed
    before those writes."""
    n = 1 << L
    la, _, R, U = _split(L)
    assert radix_phases(35, n, n, True)[0][2] <= 16
    for logtc in range(5):
        tc = 1 << logtc
        _geometry_ok(35, n, max(n, tc), tc)
        tid = torch.arange(tc * U)
        c, u = tid & (tc - 1), tid >> logtc
        words = torch.stack([_tile_at(u * R + t, c, la, logtc)
                             for t in range(R)], dim=1)  # [threads, R]
        assert words.unique().numel() == words.numel() == n * tc
