"""Kernels B7 and B11, the forward phase 2 of the coefficient-sharded NTT
(csrc/ntt.cu's ntt_phase2_radix / packed_phase2_radix on B1's phase B,
csrc/ntt_reg.cuh::radix_phase<L, true, false>), around what the CPU can
run: a plain int64 model of their schedule, lane to lane (the block
geometry of B6 and B10, tests/test_torch_phase_radix.py's `_blocks`: a
block per [n2, TC] tile of one limb, TC within one limb's c lanes, the
block's limb min((g mod G)*k + lane0 / c, M - 1), so the padding lanes of a
copy's last group compute limb M - 1's copy; the strided and contiguous CT
passes of `radix_ct_rows`, modelled by tests/test_torch_ntt_radix.py; then
two conditional subtracts from [0, 4q) to [0, q) at the contiguous rows,
stored in the input's layout), held bit for bit (tolerance 0) against the
plain versions `ntt_phase2_plain` / `ntt_phase2_packed_plain` and the JAX
`ntt_phase2_pallas` / `ntt_phase2_packed_pallas` in interpret mode, with
every lazy margin asserted (each CT output below 4q, each lazy product
below 2q, each store below q). B7 is B11 with k = 1 and G = M. The cases
are B6's and B10's: n = 4096 (n1 = n2 = 64) at c = 1, 8, 16 and 32 columns
a shard, rep 2, the primes just below numtheory.PRIME_CAP (2^32/6),
random inputs and the worst case (every input q - 1), and an odd axis
(n2 = 128: two contiguous units a thread). The model does the operations
that chip_smoke's bound counts (benchlib.radix_phase2_ops), and the tile
widths the wrappers pick fit a block at every shape chip_smoke checks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homulator_tpu.ops.ntt import _pack_pad as jax_pack_pad
from homulator_tpu.ops.ntt_pallas import (
    ntt_phase2_packed_pallas, ntt_phase2_pallas,
)
from homulator_tpu.params import get_params
from homulator_tpu_torch import benchlib
from homulator_tpu_torch.context import DeviceContext
from homulator_tpu_torch.ops.ntt import (
    _pack_pad, ntt_phase2_packed_plain, ntt_phase2_plain,
)
from homulator_tpu_torch.ops.ntt_kernels import (
    PHASE_MIN_BLOCKS, phase_tile_cols,
)

from .test_torch_ntt_radix import (
    _COUNT, MASK32, _bound, _count, _csub, _ct_rows, _geometry_ok, _rows,
)
from .test_torch_phase_radix import (  # noqa: F401 (ctx: a fixture)
    B6_SHAPES, B10_SHAPES, ROWS, SHARD_COLS, _blocks, _inputs, _tiles, _u32,
    ctx,
)


def phase2_model(x, nb, rep, tc, k):
    """csrc/ntt.cu's B7 (k = 1) or B11 on x int32 [rep*G, n2, k*c] with
    tiles of tc lanes: every block at once, each a row of the model's
    batch. Same result as the plain version."""
    blk, _, cols, limb, q = _blocks(x, nb, rep, tc, k)
    L = x.shape[1].bit_length() - 1
    tw = tuple(getattr(nb, t).long()[limb] & MASK32
               for t in ("tw2", "tw2_sh"))
    xl = x.long() & MASK32
    strided, contig = _rows(L)
    v = [xl[blk[:, None, None], i[None], cols] for i in strided]
    for t in v:
        _bound(t, q)
    v = _ct_rows(v, L, tc, tw, q)  # [0, 4q)
    y = torch.full_like(xl, -1)
    for t, i in enumerate(contig):
        _bound(v[t], 4 * q)
        yt = _csub(_csub(v[t], 2 * q), q)
        _count("csub", yt, 2)
        _bound(yt, q)
        y[blk[:, None, None], i[None], cols] = yt
    assert bool((y >= 0).all()), "a lane left unwritten"
    return y.to(torch.int32)


@pytest.mark.parametrize("worst", [False, True], ids=["random", "worst"])
@pytest.mark.parametrize("c", SHARD_COLS)
def test_b7_model_matches_plain_and_jax(ctx, c, worst):
    """B7 on the last rank's column slice [n2, n1/ns], rep 2, at every tile
    width: the model equals ntt_phase2_plain and the JAX ntt_phase2_pallas
    (one call a copy) bit for bit."""
    p, jdc, dc = ctx
    ns = p.ntt.n1 // c
    nb = dc.ntt_basis(ROWS, shard=(ns - 1, ns))
    x = _inputs(p.q_arr[list(ROWS)], 2, (p.ntt.n2, c), 20 + c, worst)
    want = ntt_phase2_plain(x, nb, 2)
    for tc in _tiles(x.shape[0], c, c):
        assert torch.equal(phase2_model(x, nb, 2, tc, 1), want)
    jnb = jdc.ntt_basis(ROWS)
    _, _, _, _, p2, p2s = jnb.pfwd
    M = len(ROWS)
    jax_out = np.concatenate([np.asarray(ntt_phase2_pallas(
        jnp.asarray(_u32(x[r * M:(r + 1) * M])), jnb.q, p2, p2s,
        n2=p.ntt.n2, c=c, interpret=True)) for r in range(2)])
    assert np.array_equal(_u32(want), jax_out)


@pytest.mark.parametrize("worst", [False, True], ids=["random", "worst"])
@pytest.mark.parametrize("c", SHARD_COLS)
def test_b11_model_matches_plain_and_jax(ctx, c, worst):
    """B11 on the last rank's lane groups (k = 128/c, each copy's 5 rows
    padded to a multiple of k), rep 2, at every tile width: the model
    equals ntt_phase2_packed_plain and the JAX ntt_phase2_packed_pallas
    (one call a copy) bit for bit."""
    p, jdc, dc = ctx
    ns = p.ntt.n1 // c
    nb = dc.ntt_basis(ROWS, shard=(ns - 1, ns), packed=True)
    k = nb.pack
    assert k == 128 // c
    x = _inputs(p.q_arr[list(ROWS)], 2, (p.ntt.n2, c), 30 + c, worst)
    xp = _pack_pad(x, k, 2)
    want = ntt_phase2_packed_plain(xp, nb, 2)
    for tc in _tiles(xp.shape[0], c, k * c):
        assert torch.equal(phase2_model(xp, nb, 2, tc, k), want)
    jnb = jdc.ntt_basis(ROWS, shard_axis="coeff", pack_ns=ns)
    qrow, _, _, _, _, p2p, p2sp = jnb.pfwd_packed
    M = len(ROWS)
    jax_out = np.concatenate([np.asarray(ntt_phase2_packed_pallas(
        jax_pack_pad(jnp.asarray(_u32(x[r * M:(r + 1) * M])), k), qrow, p2p,
        p2sp, n2=p.ntt.n2, interpret=True)) for r in range(2)])
    assert np.array_equal(_u32(want), jax_out)


@pytest.mark.parametrize("packed", [False, True], ids=["B7", "B11"])
def test_model_on_an_odd_axis(packed):
    """n2 = 128 (L = 7: R = 16 values a thread in two contiguous units of
    8), c = 16 on 8 shards, rep 2, the worst case: model == plain."""
    p = get_params(n=1 << 14, max_level=4, alpha=1)
    dc = DeviceContext(p, "cpu")
    rows = (4, 0, 1, 2)
    nb = dc.ntt_basis(rows, shard=(7, 8), packed=packed)
    k = nb.pack if packed else 1
    assert k == (8 if packed else 1) and p.ntt.n2 == 128
    x = _inputs(p.q_arr[list(rows)], 2, (p.ntt.n2, 16), 0, True)
    if packed:
        x = _pack_pad(x, k, 2)
    plain = ntt_phase2_packed_plain if packed else ntt_phase2_plain
    want = plain(x, nb, 2)
    for tc in (4, 16):
        assert torch.equal(phase2_model(x, nb, 2, tc, k), want)


@pytest.mark.parametrize("packed", [False, True], ids=["B7", "B11"])
@pytest.mark.parametrize("c", (1, 32))
def test_model_does_the_operations_the_bound_counts(ctx, c, packed):
    """chip_smoke's B7/B11 bound counts what the schedule does: the
    model's butterflies and conditional subtracts, at benchlib.OPS each,
    are benchlib.radix_phase2_ops on every limb slice the launch computes
    (the padding rows included)."""
    p, _, dc = ctx
    ns = p.ntt.n1 // c
    nb = dc.ntt_basis(ROWS, shard=(ns - 1, ns), packed=packed)
    k = nb.pack if packed else 1
    x = _inputs(p.q_arr[list(ROWS)], 1, (p.ntt.n2, c), 5, False)
    if packed:
        x = _pack_pad(x, k, 1)
    _COUNT.clear()
    phase2_model(x, nb, 1, min(c, 4), k)
    n, rows = p.ntt.n2, x.shape[0] * k
    assert _COUNT["lazy_butterfly"] == rows * c * n // 2 * 6
    assert set(_COUNT) == {"lazy_butterfly", "csub"}
    assert (sum(benchlib.OPS[t] * v for t, v in _COUNT.items())
            == benchlib.radix_phase2_ops(rows, n, c))


# chip_smoke.phase_cases gives B7 and B11 B6's and B10's shapes: at set B
# n1 = n2 = 256, so phase 2's slices [n2, n1/ns] are phase 1's [n1, n2/ns]
B7_SHAPES = B6_SHAPES
B11_SHAPES = B10_SHAPES


@pytest.mark.parametrize("label", list(B7_SHAPES) + list(B11_SHAPES))
def test_geometry_at_chip_smokes_shapes(label):
    """B7's and B11's tile width at chip_smoke's shapes (phase_tile_cols,
    the rule of B6 and B10): within one limb's c lanes, never the 4-column
    tile, a block that fits, and on the main rows at 4 shards (B7) and 8
    shards (B11) a block for half the SMs or more."""
    for groups, c, k in (B7_SHAPES | B11_SHAPES)[label]:
        tc = phase_tile_cols(groups, c, k * c)
        assert tc <= c and c % tc == 0 and tc in (8, 16)
        blocks = _geometry_ok(groups, 256, k * c, tc)
        if (groups, c) in ((35, 64), (9, 32)):
            assert blocks >= PHASE_MIN_BLOCKS
