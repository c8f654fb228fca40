"""Kernels B6 and B10, the forward phase 1 of the coefficient-sharded NTT
(csrc/ntt.cu's ntt_phase1_radix / packed_phase1_radix on
csrc/ntt_reg.cuh::radix_phase1), around what the CPU can run: a plain int64
model of their schedule, lane to lane (a block per [n1, TC] tile of one
limb, TC within one limb's c lanes; the block's limb min((g mod G)*k +
lane0 / c, M - 1), so the padding lanes of a copy's last group compute
limb M - 1's copy; the strided and contiguous CT passes of B1's
`radix_ct_rows`, modelled by tests/test_torch_ntt_radix.py; then the mid
product at the contiguous rows, reduced to [0, q), stored in the input's
layout), held bit for bit (tolerance 0) against the plain versions
`ntt_phase1_plain` / `ntt_phase1_packed_plain` and the JAX
`ntt_phase1_pallas` / `ntt_phase1_packed_pallas` in interpret mode (as
tests/test_torch_coeff_ntt.py and test_torch_coeff_packed.py run them),
with every lazy margin asserted (each CT output below 4q, each lazy
product below 2q, each store below q). B6 is B10 with k = 1 and G = M. The
cases: n = 4096 (n1 = n2 = 64) at c = 1, 8, 16 and 32 columns a shard,
rep 2, the primes of the parameters just below numtheory.PRIME_CAP
(2^32/6), random inputs and the worst case (every input q - 1), and an
odd axis (n1 = 128: two contiguous units a thread). The model does the
operations that chip_smoke's bound counts (benchlib.radix_phase1_ops),
and the tile widths the wrappers pick (`phase_tile_cols`) fit a block at
every axis length and at every shape chip_smoke checks. The block
geometry (`_blocks`) is shared with B7 and B11, whose model is in
tests/test_torch_phase2_radix.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homulator_tpu.context import DeviceContext as JaxContext
from homulator_tpu.ops.ntt import _pack_pad as jax_pack_pad
from homulator_tpu.ops.ntt_pallas import (
    ntt_phase1_packed_pallas, ntt_phase1_pallas,
)
from homulator_tpu.params import get_params
from homulator_tpu_torch import benchlib
from homulator_tpu_torch import numtheory as nt
from homulator_tpu_torch.context import DeviceContext
from homulator_tpu_torch.ops.ntt import (
    _pack_pad, ntt_phase1_packed_plain, ntt_phase1_plain,
)
from homulator_tpu_torch.ops.ntt_kernels import (
    PHASE_MIN_BLOCKS, TILE_COLS, phase_tile_cols,
)

from .test_torch_ntt_radix import (
    _COUNT, MASK32, _bound, _count, _csub, _ct_rows, _geometry_ok, _lazy,
    _rows, _split,
)

ROWS = (9, 0, 2, 3, 4)  # a special prime first; 5 rows pad at k = 4 .. 128
SHARD_COLS = (1, 8, 16, 32)  # c at n2 = 64: 64, 8, 4 and 2 shards


def _blocks(x, nb, rep, tc, k):
    """csrc/ntt.cu's launch of a forward phase (B6, B7: k = 1; B10, B11) on
    x [rep*G, n, k*c] with tiles of tc lanes, a block a row of the model's
    batch: each block's group, first lane, [B, 1, tc] lanes, limb (min((g
    mod G)*k + lane0 / c, M - 1)) and q [B, 1, 1]."""
    M = nb.q.shape[0]
    G = -(-M // k)
    groups, _, m = x.shape
    c = m // k
    assert groups == rep * G and m % tc == 0 and c % tc == 0
    g = torch.arange(groups)[:, None]
    lane0 = (torch.arange(m // tc) * tc)[None, :]
    # a tile lies in one limb's c lanes
    assert torch.equal(lane0 // c, (lane0 + tc - 1) // c)
    limb = ((g % G) * k + lane0 // c).clamp(max=M - 1).reshape(-1)
    blk = g.expand(-1, lane0.shape[1]).reshape(-1)
    l0 = lane0.expand(groups, -1).reshape(-1)
    cols = l0[:, None, None] + torch.arange(tc)
    return blk, l0, cols, limb, nb.q.long()[limb][:, None, None]


def phase1_model(x, nb, rep, tc, k):
    """csrc/ntt.cu's B6 (k = 1) or B10 on x int32 [rep*G, n1, k*c] with
    tiles of tc lanes: every block at once, each a row of the model's
    batch. Same result as the plain version."""
    blk, l0, cols, limb, q = _blocks(x, nb, rep, tc, k)
    c = x.shape[2] // k
    L = x.shape[1].bit_length() - 1
    mcols = (l0 % c)[:, None, None] + torch.arange(tc)
    b = torch.arange(limb.numel())[:, None, None]
    tw = tuple(getattr(nb, t).long()[limb] & MASK32
               for t in ("tw1", "tw1_sh"))
    mid, mid_sh = (getattr(nb, t).long()[limb] & MASK32
                   for t in ("mid", "mid_sh"))
    xl = x.long() & MASK32
    strided, contig = _rows(L)
    v = [xl[blk[:, None, None], i[None], cols] for i in strided]
    for t in v:
        _bound(t, q)
    v = _ct_rows(v, L, tc, tw, q)  # [0, 4q)
    y = torch.full_like(xl, -1)
    for t, i in enumerate(contig):
        w, w_sh = mid[b, i[None], mcols], mid_sh[b, i[None], mcols]
        yt = _csub(_lazy(v[t], w, w_sh, q), q)
        _count("lazy_shoup", yt)
        _count("csub", yt)
        _bound(yt, q)
        y[blk[:, None, None], i[None], cols] = yt
    assert bool((y >= 0).all()), "a lane left unwritten"
    return y.to(torch.int32)


@pytest.fixture(scope="module")
def ctx():
    p = get_params(n=4096, max_level=8, alpha=2)
    assert int(p.q_arr[list(ROWS)].min()) > nt.PRIME_CAP - (1 << 24)
    return p, JaxContext(p, ntt_mode="interpret"), DeviceContext(p, "cpu")


def _inputs(q, rep, shape, seed, worst):
    """[rep*M, *shape] residues of rep copies (every one q - 1 if worst)."""
    q = np.tile(np.asarray(q, dtype=np.int64), rep)[:, None, None]
    x = (np.broadcast_to(q - 1, (len(q),) + shape) if worst else
         np.random.default_rng(seed).integers(0, q, size=(len(q),) + shape))
    return torch.from_numpy(x.astype(np.uint32).view(np.int32))


def _tiles(groups, c, lanes):
    """Every tile width the kernel takes here (powers of two up to min(16,
    c)), the wrapper's choice among them."""
    tcs = [t for t in (1, 2, 4, 8, 16) if t <= c]
    assert phase_tile_cols(groups, c, lanes) in tcs
    return tcs


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("worst", [False, True], ids=["random", "worst"])
@pytest.mark.parametrize("c", SHARD_COLS)
def test_b6_model_matches_plain_and_jax(ctx, c, worst):
    """B6 on the last rank's column slice, rep 2, at every tile width: the
    model equals ntt_phase1_plain and the JAX ntt_phase1_pallas (one call
    a copy) bit for bit."""
    p, jdc, dc = ctx
    ns = p.ntt.n2 // c
    nb = dc.ntt_basis(ROWS, shard=(ns - 1, ns))
    x = _inputs(p.q_arr[list(ROWS)], 2, (p.ntt.n1, c), c, worst)
    want = ntt_phase1_plain(x, nb, 2)
    for tc in _tiles(x.shape[0], c, c):
        assert torch.equal(phase1_model(x, nb, 2, tc, 1), want)
    jnb = jdc.ntt_basis(ROWS)
    p1, p1s, mid, mids, _, _ = jnb.pfwd
    cols = slice((ns - 1) * c, ns * c)
    M = len(ROWS)
    jax_out = np.concatenate([np.asarray(ntt_phase1_pallas(
        jnp.asarray(_u32(x[r * M:(r + 1) * M])), jnb.q, p1, p1s,
        mid[:, :, cols], mids[:, :, cols], n1=p.ntt.n1, c=c,
        interpret=True)) for r in range(2)])
    assert np.array_equal(_u32(want), jax_out)


@pytest.mark.parametrize("worst", [False, True], ids=["random", "worst"])
@pytest.mark.parametrize("c", SHARD_COLS)
def test_b10_model_matches_plain_and_jax(ctx, c, worst):
    """B10 on the last rank's lane groups (k = 128/c, each copy's 5 rows
    padded to a multiple of k), rep 2, at every tile width: the model
    equals ntt_phase1_packed_plain and the JAX ntt_phase1_packed_pallas
    (one call a copy) bit for bit."""
    p, jdc, dc = ctx
    ns = p.ntt.n2 // c
    nb = dc.ntt_basis(ROWS, shard=(ns - 1, ns), packed=True)
    k = nb.pack
    assert k == 128 // c
    x = _inputs(p.q_arr[list(ROWS)], 2, (p.ntt.n1, c), 10 + c, worst)
    xp = _pack_pad(x, k, 2)
    want = ntt_phase1_packed_plain(xp, nb, 2)
    for tc in _tiles(xp.shape[0], c, k * c):
        assert torch.equal(phase1_model(xp, nb, 2, tc, k), want)
    jnb = jdc.ntt_basis(ROWS, shard_axis="coeff", pack_ns=ns)
    qrow, p1p, p1sp, midp, midsp, _, _ = jnb.pfwd_packed
    M = len(ROWS)
    jax_out = np.concatenate([np.asarray(ntt_phase1_packed_pallas(
        jax_pack_pad(jnp.asarray(_u32(x[r * M:(r + 1) * M])), k), qrow, p1p,
        p1sp, midp[ns - 1], midsp[ns - 1], n1=p.ntt.n1, interpret=True))
        for r in range(2)])
    assert np.array_equal(_u32(want), jax_out)


@pytest.mark.parametrize("packed", [False, True], ids=["B6", "B10"])
def test_model_on_an_odd_axis(packed):
    """n1 = 128 (L = 7: R = 16 values a thread in two contiguous units of
    8), c = 16 on 8 shards, rep 2, the worst case: model == plain."""
    p = get_params(n=1 << 14, max_level=4, alpha=1)
    dc = DeviceContext(p, "cpu")
    rows = (4, 0, 1, 2)
    nb = dc.ntt_basis(rows, shard=(7, 8), packed=packed)
    k = nb.pack if packed else 1
    assert k == (8 if packed else 1)
    x = _inputs(p.q_arr[list(rows)], 2, (p.ntt.n1, 16), 0, True)
    if packed:
        x = _pack_pad(x, k, 2)
    plain = ntt_phase1_packed_plain if packed else ntt_phase1_plain
    want = plain(x, nb, 2)
    for tc in (4, 16):
        assert torch.equal(phase1_model(x, nb, 2, tc, k), want)


@pytest.mark.parametrize("packed", [False, True], ids=["B6", "B10"])
@pytest.mark.parametrize("c", (1, 32))
def test_model_does_the_operations_the_bound_counts(ctx, c, packed):
    """chip_smoke's B6/B10 bound counts what the schedule does: the
    model's butterflies, lazy products and conditional subtracts, at
    benchlib.OPS each, are benchlib.radix_phase1_ops on every limb slice
    the launch computes (the padding rows included)."""
    p, _, dc = ctx
    ns = p.ntt.n2 // c
    nb = dc.ntt_basis(ROWS, shard=(ns - 1, ns), packed=packed)
    k = nb.pack if packed else 1
    x = _inputs(p.q_arr[list(ROWS)], 1, (p.ntt.n1, c), 3, False)
    if packed:
        x = _pack_pad(x, k, 1)
    _COUNT.clear()
    phase1_model(x, nb, 1, min(c, 4), k)
    n, rows = p.ntt.n1, x.shape[0] * k
    assert _COUNT["lazy_butterfly"] == rows * c * n // 2 * 6
    assert (sum(benchlib.OPS[t] * v for t, v in _COUNT.items())
            == benchlib.radix_phase1_ops(rows, n, c))


@pytest.mark.parametrize("L", range(1, 11))
def test_every_tile_fits_a_block(L):
    """At every axis length 2^L the kernels are instantiated for, each tile
    width the launch takes (1 .. 16, csrc/ntt_reg.cuh's kMaxTileCols)
    fits a block: threads within the instantiation's launch bound,
    shared memory within Hopper's 227 KB."""
    _, lb, _, _ = _split(L)
    for tc in (1, 2, 4, 8, 16):
        _geometry_ok(1, 1 << L, 16, tc)
        assert tc << lb <= max(TILE_COLS) << lb


# the shapes chip_smoke.phase_cases gives B6 and B10 at set B (n1 = 256),
# as (groups, c, k): B6 at rows = rep*M, k = 1; B10 at rep*ceil(M/k)
# groups of k = 128/c limbs
B6_SHAPES = {"ns=4 main/digit2/special/tail": [(35, 64, 1), (45, 64, 1),
                                               (30, 64, 1), (68, 64, 1)],
             "ns=2, 8, 16, 32 main": [(35, 128, 1), (35, 32, 1),
                                      (35, 16, 1), (35, 8, 1)]}
B10_SHAPES = {"ns=8 main/special/tail": [(9, 32, 4), (8, 32, 4),
                                         (2, 32, 4)],
              "ns=16, 32 main": [(5, 16, 8), (3, 8, 16)]}


@pytest.mark.parametrize("label", list(B6_SHAPES) + list(B10_SHAPES))
def test_geometry_at_chip_smokes_shapes(label):
    """The wrappers' tile width at chip_smoke's shapes: within one limb's
    c lanes, never the 4-column tile (16-byte row segments), a block that
    fits, and at 4 shards (B6) and 8 shards (B10) on the main rows a
    block for half the SMs or more."""
    for groups, c, k in (B6_SHAPES | B10_SHAPES)[label]:
        tc = phase_tile_cols(groups, c, k * c)
        assert tc <= c and c % tc == 0 and tc in (8, 16)
        blocks = _geometry_ok(groups, 256, k * c, tc)
        if (groups, c) in ((35, 64), (9, 32)):
            assert blocks >= PHASE_MIN_BLOCKS
