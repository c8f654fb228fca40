"""Kernels B8 and B9, the per-limb inverse phases of the coefficient-sharded
NTT (csrc/ntt.cu's ntt_iphase2_radix / ntt_iphase1_radix: B8 on B2's phase
A, csrc/ntt_reg.cuh::radix_phase<L, false, false>; B9 on radix_iphase1),
around what the CPU can run. Each is its lane-packed twin (B12, B13) with
k = 1 and G = M groups of one limb, so the int64 model is
tests/test_torch_iphase_radix.py's `iphase_model` at k = 1: a block per
[n, TC] tile of one limb, limb g mod M (the row of rep stacked copies),
for B9 the lazy mid_inv product at the contiguous rows, read at column
lane0 of the shard's own [M, n1, c] slice; the GS passes of
`radix_gs_rows`; one conditional subtract from [0, 2q) to [0, q) at the
strided rows, stored in the input's layout. It is held bit for bit
(tolerance 0) against the plain versions `intt_phase2_plain` /
`intt_phase1_plain` and the JAX `intt_phase2_pallas` /
`intt_phase1_pallas` in interpret mode (whose lazy ranges differ: B8
reduces from [0, 3q) by two conditional subtracts, B9 starts with a
product into [0, 3q); both outputs are canonical, so equal to the bit),
with every lazy margin asserted (each GS output below 2q, each lazy product
below 2q, each store below q). The cases: n = 4096 (n1 = n2 = 64) at c =
1, 8, 16 and 32 columns a shard, rep 2, the primes of the parameters just
below numtheory.PRIME_CAP (2^32/6), random inputs and the worst case
(every input q - 1), at every tile width; one limb at rep 2 (the tail's
last limb); an odd axis (n = 128: two contiguous units a thread). The
model does the operations that chip_smoke's bound counts
(benchlib.radix_phase2_ops inverse, radix_phase1_ops), and the tile widths
the wrappers pick fit a block at every shape chip_smoke checks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homulator_tpu.ops.ntt_pallas import (
    intt_phase1_pallas, intt_phase2_pallas,
)
from homulator_tpu.params import get_params
from homulator_tpu_torch import benchlib
from homulator_tpu_torch.context import DeviceContext
from homulator_tpu_torch.ops.ntt import intt_phase1_plain, intt_phase2_plain
from homulator_tpu_torch.ops.ntt_kernels import (
    PHASE_MIN_BLOCKS, phase_tile_cols,
)

from .test_torch_hpip_radix import _load_root_module
from .test_torch_iphase_radix import iphase_model
from .test_torch_ntt_radix import _COUNT, _geometry_ok
from .test_torch_phase_radix import (  # noqa: F401 (ctx: a fixture)
    B6_SHAPES, ROWS, SHARD_COLS, _inputs, _tiles, _u32, ctx,
)

PHASES = {"B8": (intt_phase2_plain, False),
          "B9": (intt_phase1_plain, True)}


def _jax_phase(jdc, x, ns, c, n, phase1, reps):
    """The JAX per-limb kernel in interpret mode on each copy of x [reps*M,
    n, c] (rank ns - 1's slice; B9 takes that rank's mid_inv columns),
    concatenated."""
    jnb = jdc.ntt_basis(ROWS)
    ip1, ip1s, midi, midis, ip2, ip2s = jnb.pinv
    cols = slice((ns - 1) * c, ns * c)
    M = len(ROWS)
    out = []
    for r in range(reps):
        jx = jnp.asarray(_u32(x[r * M:(r + 1) * M]))
        out.append(np.asarray(
            intt_phase1_pallas(jx, jnb.q, midi[:, :, cols],
                               midis[:, :, cols], ip1, ip1s, n1=n, c=c,
                               interpret=True) if phase1 else
            intt_phase2_pallas(jx, jnb.q, ip2, ip2s, n2=n, c=c,
                               interpret=True)))
    return np.concatenate(out)


@pytest.mark.parametrize("worst", [False, True], ids=["random", "worst"])
@pytest.mark.parametrize("c", SHARD_COLS)
@pytest.mark.parametrize("phase", list(PHASES))
def test_model_matches_plain_and_jax(ctx, phase, c, worst):
    """B8 (on [n2, n1/ns]) or B9 (on [n1, n2/ns]) on the last rank's column
    slice, rep 2, at every tile width: the model at k = 1 equals the plain
    version and the JAX per-limb kernel (one call a copy) bit for bit."""
    p, jdc, dc = ctx
    plain, phase1 = PHASES[phase]
    n, other = (p.ntt.n1, p.ntt.n2) if phase1 else (p.ntt.n2, p.ntt.n1)
    ns = other // c
    nb = dc.ntt_basis(ROWS, shard=(ns - 1, ns))
    assert nb.pack == 0
    if phase1:
        assert tuple(nb.mid_inv.shape) == (len(ROWS), n, c)
    x = _inputs(p.q_arr[list(ROWS)], 2, (n, c), 50 + c + 7 * phase1, worst)
    want = plain(x, nb, 2)
    for tc in _tiles(x.shape[0], c, c):
        assert torch.equal(iphase_model(x, nb, 2, tc, 1, phase1), want)
    assert np.array_equal(_u32(want),
                          _jax_phase(jdc, x, ns, c, n, phase1, 2))


@pytest.mark.parametrize("phase", list(PHASES))
def test_model_on_one_limb(ctx, phase):
    """One limb (the tail's last, chip_smoke's M = 1 rep 2) at c = 16 on
    4 shards: both copies' blocks read limb 0's tables; the worst case at
    every tile width; model == plain."""
    p, _, dc = ctx
    plain, phase1 = PHASES[phase]
    nb = dc.ntt_basis((ROWS[0],), shard=(1, 4))
    x = _inputs(p.q_arr[[ROWS[0]]], 2, (64, 16), 0, True)
    want = plain(x, nb, 2)
    for tc in _tiles(x.shape[0], 16, 16):
        assert torch.equal(iphase_model(x, nb, 2, tc, 1, phase1), want)


@pytest.mark.parametrize("phase", list(PHASES))
def test_model_on_an_odd_axis(phase):
    """n = 128 (L = 7: R = 16 values a thread in two contiguous units of
    8), c = 16 on 8 shards, rep 2, the worst case: model == plain."""
    p = get_params(n=1 << 14, max_level=4, alpha=1)
    dc = DeviceContext(p, "cpu")
    rows = (4, 0, 1, 2)
    nb = dc.ntt_basis(rows, shard=(7, 8))
    plain, phase1 = PHASES[phase]
    assert p.ntt.n1 == p.ntt.n2 == 128
    x = _inputs(p.q_arr[list(rows)], 2, (128, 16), 0, True)
    want = plain(x, nb, 2)
    for tc in (4, 16):
        assert torch.equal(iphase_model(x, nb, 2, tc, 1, phase1), want)


@pytest.mark.parametrize("c", (1, 32))
@pytest.mark.parametrize("phase", list(PHASES))
def test_model_does_the_operations_the_bound_counts(ctx, phase, c):
    """chip_smoke's B8/B9 bound counts what the schedule does: the model's
    butterflies, lazy products and conditional subtracts, at benchlib.OPS
    each, are benchlib.radix_phase2_ops (inverse: one conditional subtract
    an element) for B8 and radix_phase1_ops for B9 on every limb slice, the
    operations of chip_smoke.phase_bound."""
    p, _, dc = ctx
    plain, phase1 = PHASES[phase]
    n = p.ntt.n1 if phase1 else p.ntt.n2
    ns = 64 // c
    nb = dc.ntt_basis(ROWS, shard=(ns - 1, ns))
    x = _inputs(p.q_arr[list(ROWS)], 1, (n, c), 11, False)
    _COUNT.clear()
    iphase_model(x, nb, 1, min(c, 4), 1, phase1)
    rows = x.shape[0]
    assert _COUNT["lazy_butterfly"] == rows * c * n // 2 * 6
    assert set(_COUNT) == ({"lazy_butterfly", "lazy_shoup", "csub"}
                           if phase1 else {"lazy_butterfly", "csub"})
    ops = sum(benchlib.OPS[t] * v for t, v in _COUNT.items())
    assert ops == (benchlib.radix_phase1_ops(rows, n, c) if phase1 else
                   benchlib.radix_phase2_ops(rows, n, c, fwd=False))
    chip_smoke = _load_root_module("chip_smoke")
    name = "intt_phase1" if phase1 else "intt_phase2"
    M = len(ROWS)
    nbytes = 4 * (2 * rows * n * c + int(phase1) * 2 * M * n * c
                  + 2 * M * n + M)
    assert (chip_smoke.phase_bound(nb, rows, n, c, name)
            == benchlib.bound(nbytes, ops))


# the shapes chip_smoke.phase_cases gives B8 and B9 at set B (n1 = n2 =
# 256), as (rows, c, k = 1): B6's, but for the tail, whose inverse takes
# the last limb (M = 1 rep 2) where the forward one takes M = 34 rep 2
B8_SHAPES = B9_SHAPES = {
    "ns=4 main/digit2/special/tail": [(35, 64, 1), (45, 64, 1), (30, 64, 1),
                                      (2, 64, 1)],
    "ns=2, 8, 16, 32 main": B6_SHAPES["ns=2, 8, 16, 32 main"]}


@pytest.mark.parametrize("label", list(B8_SHAPES))
def test_geometry_at_chip_smokes_shapes(label):
    """B8's and B9's tile width at chip_smoke's shapes (phase_tile_cols,
    the rule of every phase kernel): within the limb's c columns, never
    the 4-column tile, a block that fits, and on the main rows at 4 shards
    a block for half the SMs or more."""
    for rows, c, k in B8_SHAPES[label]:
        tc = phase_tile_cols(rows, c, k * c)
        assert tc <= c and c % tc == 0 and tc in (8, 16)
        blocks = _geometry_ok(rows, 256, k * c, tc)
        if (rows, c) == (35, 64):
            assert blocks >= PHASE_MIN_BLOCKS
