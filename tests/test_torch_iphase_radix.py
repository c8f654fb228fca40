"""Kernels B12 and B13, the lane-packed inverse phases of the
coefficient-sharded NTT (csrc/ntt.cu's packed_iphase2_radix /
packed_iphase1_radix: B12 on B2's phase A, csrc/ntt_reg.cuh::radix_phase<L,
false, false>; B13 on radix_iphase1), around what the CPU can run: a plain
int64 model of their schedule, lane to lane (the block geometry of the
forward phases, tests/test_torch_phase_radix.py's `_blocks`: a block per
[n, TC] tile of one limb, TC within one limb's c lanes, the block's limb
min((g mod G)*k + lane0 / c, M - 1), so the padding lanes of a copy's last
group compute limb M - 1's copy; for B13 the lazy mid_inv product at the
contiguous rows, read at column lane0 mod c of the limb's [n1, c] slice;
the contiguous and strided GS passes of `radix_gs_rows`,
tests/test_torch_ntt_radix.py's `_gs_rows`; one conditional subtract from
[0, 2q) to [0, q) at the strided rows, stored in the input's layout), held
bit for bit (tolerance 0) against the plain versions
`intt_phase2_packed_plain` / `intt_phase1_packed_plain` and the JAX
`intt_phase2_packed_pallas` / `intt_phase1_packed_pallas` in interpret
mode (whose lazy ranges differ: B12 reduces from [0, 3q) by two
conditional subtracts, B13 starts with a product into [0, 3q); both
outputs are canonical, so equal to the bit), with every lazy margin
asserted (each GS output below 2q, each lazy product below 2q, each store
below q). The cases: n = 4096 (n1 = n2 = 64) at c = 8, 16 and 32 lanes a
limb (k = 16, 8, 4; 8, 4 and 2 shards), rep 2, the primes of the
parameters just below numtheory.PRIME_CAP (2^32/6), random inputs and the
worst case (every input q - 1), each copy's 5 rows padded to a multiple of
k (a padded last group), one limb padded to a whole group, and an odd
axis (n = 128: two contiguous units a thread). The model does the
operations that chip_smoke's bound counts (benchlib.radix_phase2_ops
inverse, radix_phase1_ops), and the tile widths the wrappers pick fit a
block at every shape chip_smoke checks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homulator_tpu.ops.ntt import _pack_pad as jax_pack_pad
from homulator_tpu.ops.ntt_pallas import (
    intt_phase1_packed_pallas, intt_phase2_packed_pallas,
)
from homulator_tpu.params import get_params
from homulator_tpu_torch import benchlib
from homulator_tpu_torch.context import DeviceContext
from homulator_tpu_torch.ops.ntt import (
    _pack_pad, intt_phase1_packed_plain, intt_phase2_packed_plain,
)
from homulator_tpu_torch.ops.ntt_kernels import (
    PHASE_MIN_BLOCKS, phase_tile_cols,
)

from .test_torch_hpip_radix import _load_root_module
from .test_torch_ntt_radix import (
    _COUNT, MASK32, _bound, _count, _csub, _geometry_ok, _gs_rows, _lazy,
    _rows,
)
from .test_torch_phase_radix import (  # noqa: F401 (ctx: a fixture)
    B10_SHAPES, ROWS, _blocks, _inputs, _tiles, _u32, ctx,
)

PACKED_COLS = (8, 16, 32)  # c at n = 64: 8, 4 and 2 shards
PHASES = {"B12": (intt_phase2_packed_plain, False),
          "B13": (intt_phase1_packed_plain, True)}


def iphase_model(x, nb, rep, tc, k, phase1):
    """csrc/ntt.cu's B13 (phase1) or B12 on x int32 [rep*G, n, k*c] with
    tiles of tc lanes: every block at once, each a row of the model's
    batch. Same result as the plain version."""
    blk, l0, cols, limb, q = _blocks(x, nb, rep, tc, k)
    c = x.shape[2] // k
    L = x.shape[1].bit_length() - 1
    names = ("itw1", "itw1_sh") if phase1 else ("itw2", "itw2_sh")
    tw = tuple(getattr(nb, t).long()[limb] & MASK32 for t in names)
    xl = x.long() & MASK32
    strided, contig = _rows(L)
    v = [xl[blk[:, None, None], i[None], cols] for i in contig]
    for t in v:
        _bound(t, q)
    if phase1:  # times mid_inv at the contiguous rows: [0, 2q)
        mcols = (l0 % c)[:, None, None] + torch.arange(tc)
        b = torch.arange(limb.numel())[:, None, None]
        mid, mid_sh = (getattr(nb, t).long()[limb] & MASK32
                       for t in ("mid_inv", "mid_inv_sh"))
        v = [_lazy(t, mid[b, i[None], mcols], mid_sh[b, i[None], mcols], q)
             for t, i in zip(v, contig)]
        for t in v:
            _count("lazy_shoup", t)
    v = _gs_rows(v, L, tc, tw, q)  # [0, 2q)
    y = torch.full_like(xl, -1)
    for t, i in enumerate(strided):
        _bound(v[t], 2 * q)
        yt = _csub(v[t], q)
        _count("csub", yt)
        _bound(yt, q)
        y[blk[:, None, None], i[None], cols] = yt
    assert bool((y >= 0).all()), "a lane left unwritten"
    return y.to(torch.int32)


def _jax_phase(jdc, x, k, ns, n, phase1, reps):
    """The JAX packed kernel in interpret mode on each copy of x [reps*M,
    n, c], padded and packed on the JAX side, concatenated."""
    jnb = jdc.ntt_basis(ROWS, shard_axis="coeff", pack_ns=ns)
    qrow, ip2p, ip2sp, midip, midisp, ip1p, ip1sp = jnb.pinv_packed
    M = len(ROWS)
    out = []
    for r in range(reps):
        jx = jax_pack_pad(jnp.asarray(_u32(x[r * M:(r + 1) * M])), k)
        out.append(np.asarray(
            intt_phase1_packed_pallas(jx, qrow, midip[ns - 1],
                                      midisp[ns - 1], ip1p, ip1sp, n1=n,
                                      interpret=True) if phase1 else
            intt_phase2_packed_pallas(jx, qrow, ip2p, ip2sp, n2=n,
                                      interpret=True)))
    return np.concatenate(out)


@pytest.mark.parametrize("worst", [False, True], ids=["random", "worst"])
@pytest.mark.parametrize("c", PACKED_COLS)
@pytest.mark.parametrize("phase", list(PHASES))
def test_model_matches_plain_and_jax(ctx, phase, c, worst):
    """B12 (on [n2, k*c]) or B13 (on [n1, k*c]) on the last rank's lane
    groups (k = 128/c, each copy's 5 rows padded to a multiple of k, so the
    last group has padding lanes), rep 2, at every tile width: the model
    equals the plain version and the JAX packed kernel (one call a copy)
    bit for bit."""
    p, jdc, dc = ctx
    plain, phase1 = PHASES[phase]
    n, other = (p.ntt.n1, p.ntt.n2) if phase1 else (p.ntt.n2, p.ntt.n1)
    ns = other // c
    nb = dc.ntt_basis(ROWS, shard=(ns - 1, ns), packed=True)
    k = nb.pack
    assert k == 128 // c and len(ROWS) % k
    x = _inputs(p.q_arr[list(ROWS)], 2, (n, c), 40 + c + 7 * phase1, worst)
    xp = _pack_pad(x, k, 2)
    want = plain(xp, nb, 2)
    for tc in _tiles(xp.shape[0], c, k * c):
        assert torch.equal(iphase_model(xp, nb, 2, tc, k, phase1), want)
    assert np.array_equal(_u32(want),
                          _jax_phase(jdc, x, k, ns, n, phase1, 2))


@pytest.mark.parametrize("phase", list(PHASES))
def test_model_on_one_limb(ctx, phase):
    """One limb (the tail's last, chip_smoke's M = 1 rep 2) at c = 32, k =
    4: each copy is one group of a real limb and three padding lanes
    blocks, all limb 0's; the worst case; model == plain."""
    p, _, dc = ctx
    plain, phase1 = PHASES[phase]
    nb = dc.ntt_basis((ROWS[0],), shard=(1, 2), packed=True)
    assert nb.pack == 4
    x = _pack_pad(_inputs(p.q_arr[[ROWS[0]]], 2, (64, 32), 0, True), 4, 2)
    assert x.shape[0] == 2
    want = plain(x, nb, 2)
    for tc in (8, 16):
        assert torch.equal(iphase_model(x, nb, 2, tc, 4, phase1), want)


@pytest.mark.parametrize("phase", list(PHASES))
def test_model_on_an_odd_axis(phase):
    """n = 128 (L = 7: R = 16 values a thread in two contiguous units of
    8), c = 16 on 8 shards, rep 2, the worst case: model == plain."""
    p = get_params(n=1 << 14, max_level=4, alpha=1)
    dc = DeviceContext(p, "cpu")
    rows = (4, 0, 1, 2)
    nb = dc.ntt_basis(rows, shard=(7, 8), packed=True)
    plain, phase1 = PHASES[phase]
    assert nb.pack == 8 and p.ntt.n1 == p.ntt.n2 == 128
    x = _pack_pad(_inputs(p.q_arr[list(rows)], 2, (128, 16), 0, True), 8, 2)
    want = plain(x, nb, 2)
    for tc in (4, 16):
        assert torch.equal(iphase_model(x, nb, 2, tc, 8, phase1), want)


@pytest.mark.parametrize("c", (8, 32))
@pytest.mark.parametrize("phase", list(PHASES))
def test_model_does_the_operations_the_bound_counts(ctx, phase, c):
    """chip_smoke's B12/B13 bound counts what the schedule does: the
    model's butterflies, lazy products and conditional subtracts, at
    benchlib.OPS each, are benchlib.radix_phase2_ops (inverse: one
    conditional subtract an element) for B12 and radix_phase1_ops for B13
    on every limb slice the launch computes (the padding rows included),
    the operations of chip_smoke.phase_bound."""
    p, _, dc = ctx
    plain, phase1 = PHASES[phase]
    n = p.ntt.n1 if phase1 else p.ntt.n2
    ns = 64 // c
    nb = dc.ntt_basis(ROWS, shard=(ns - 1, ns), packed=True)
    k = nb.pack
    x = _pack_pad(_inputs(p.q_arr[list(ROWS)], 1, (n, c), 9, False), k, 1)
    _COUNT.clear()
    iphase_model(x, nb, 1, min(c, 4), k, phase1)
    rows = x.shape[0] * k
    assert _COUNT["lazy_butterfly"] == rows * c * n // 2 * 6
    assert set(_COUNT) == ({"lazy_butterfly", "lazy_shoup", "csub"}
                           if phase1 else {"lazy_butterfly", "csub"})
    ops = sum(benchlib.OPS[t] * v for t, v in _COUNT.items())
    assert ops == (benchlib.radix_phase1_ops(rows, n, c) if phase1 else
                   benchlib.radix_phase2_ops(rows, n, c, fwd=False))
    chip_smoke = _load_root_module("chip_smoke")
    name = "intt_phase1_packed" if phase1 else "intt_phase2_packed"
    M = len(ROWS)
    nbytes = 4 * (2 * rows * n * c + int(phase1) * 2 * M * n * c
                  + 2 * M * n + M)
    assert (chip_smoke.phase_bound(nb, rows, n, c, name)
            == benchlib.bound(nbytes, ops))


# chip_smoke.phase_cases gives B12 and B13 B10's shapes: at set B n1 = n2 =
# 256, so the inverse phases' groups [n, k*c] are the forward ones'
B12_SHAPES = B13_SHAPES = B10_SHAPES


@pytest.mark.parametrize("label", list(B12_SHAPES))
def test_geometry_at_chip_smokes_shapes(label):
    """B12's and B13's tile width at chip_smoke's shapes (phase_tile_cols,
    the rule of B6, B7, B10 and B11): within one limb's c lanes, never the
    4-column tile, a block that fits, and on the main rows at 8 shards a
    block for half the SMs or more."""
    for groups, c, k in B12_SHAPES[label]:
        tc = phase_tile_cols(groups, c, k * c)
        assert tc <= c and c % tc == 0 and tc in (8, 16)
        blocks = _geometry_ok(groups, 256, k * c, tc)
        if (groups, c) == (9, 32):
            assert blocks >= PHASE_MIN_BLOCKS
