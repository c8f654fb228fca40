"""Wrappers of the CUDA NTT kernels: B1 (forward) and B2 (inverse), and the
phase kernels B6-B9 and B10-B13 of the coefficient-sharded transform.

B1 and B2 replace `homulator_tpu/ops/ntt_pallas.py::ntt_pallas` and
`::intt_pallas`; each transform is two launches of the register-radix
kernels on PyTorch's current stream, through a scratch array the wrapper
allocates, with the tile widths of `radix_phases`, and the wrapper
counts one launch of its kernel per transform. B6-B9 replace
`::ntt_phase1_pallas`, `::ntt_phase2_pallas`, `::intt_phase2_pallas` and
`::intt_phase1_pallas`: one launch each on [rep*M, n, c] column slices.
B10-B13 replace their lane-packed forms `::ntt_phase1_packed_pallas`,
`::ntt_phase2_packed_pallas`, `::intt_phase2_packed_pallas` and
`::intt_phase1_packed_pallas`: one launch each on [rep*G, n, k*c] lane
groups, reading the per-limb tables of the basis (csrc/ntt.cu has the
design note). B6-B13 run on the register passes of B1 and B2, with the
tile width of `phase_tile_cols` (at most one limb's c columns). The plain
versions are in ops/ntt.py: callers dispatch CPU tensors there, never
here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import kernels
from ..context import NttBasis

_FWD_TABLES = ("tw1", "tw1_sh", "mid", "mid_sh", "tw2", "tw2_sh")
_INV_TABLES = ("itw2", "itw2_sh", "mid_inv", "mid_inv_sh", "itw1", "itw1_sh")
_P1 = ("tw1", "tw1_sh", "mid", "mid_sh")
_IP1 = ("mid_inv", "mid_inv_sh", "itw1", "itw1_sh")
# the basis tables each kernel reads, in its argument order
TABLES = {"ntt_fwd": _FWD_TABLES, "ntt_inv": _INV_TABLES,
          "ntt_phase1": _P1, "ntt_phase1_packed": _P1,
          "ntt_phase2": ("tw2", "tw2_sh"),
          "ntt_phase2_packed": ("tw2", "tw2_sh"),
          "intt_phase2": ("itw2", "itw2_sh"),
          "intt_phase2_packed": ("itw2", "itw2_sh"),
          "intt_phase1": _IP1, "intt_phase1_packed": _IP1}
_MAX_N = 1024  # per-axis length: the kernels take n = 2 .. 1024

# The launch geometry of the register-radix phases (B1, B2, B4): a block
# holds TILE_COLS[i] columns, the widest that still gives MIN_BLOCKS blocks
# (two for each of an H100's 132 SMs), else the narrowest; at most
# csrc/ntt_reg.cuh's kMaxTileCols = 16. The kernel takes TC and derives
# the rest: a block per TC columns of a limb, TC * 2^floor(log2(n)/2)
# threads, radix_smem_words<L>(TC) words of shared memory.
TILE_COLS = (16, 8, 4)
MIN_BLOCKS = 2 * 132
# B6-B13 (the phases on a shard's few columns): the widest of
# PHASE_TILE_COLS that gives PHASE_MIN_BLOCKS blocks
# (half the SMs), else the narrowest. On an H100 a 4-column tile (16-byte
# row segments a warp: half of each 32-byte sector of its strided loads,
# mid reads and stores) lost to 8 and 16 columns at every set-B shape of B6
# and B10 (up to 1.75 times their time) even where the MIN_BLOCKS rule
# gave it twice the blocks; for B7 and B11 neither 8 nor 16 columns led at
# every shape, each within 10% of the other (PERF.md §6).
PHASE_TILE_COLS = (16, 8)
PHASE_MIN_BLOCKS = 64


def radix_tile_cols(rows: int, n: int, ncols: int,
                    limb_cols: Optional[int] = None, tiles=TILE_COLS,
                    min_blocks: int = MIN_BLOCKS) -> int:
    """Columns a block holds (TC) in a register-radix phase that transforms
    each of ncols columns of rows [n, ncols] along its n points, chosen
    from `tiles` (default TILE_COLS); with limb_cols (B10: rows lane
    groups of ncols = k*c lanes, limb_cols = c), TC stays within one
    limb's columns."""
    widest = ncols if limb_cols is None else limb_cols
    fits = [tc for tc in tiles if tc <= widest] or [widest]
    return next((t for t in fits if rows * (ncols // t) >= min_blocks),
                fits[-1])


def phase_tile_cols(groups: int, c: int, lanes: int) -> int:
    """TC of B6-B9 (groups limbs [n, c], lanes = c) or B10-B13 (groups
    lane groups of lanes = k*c, k limbs of c lanes each)."""
    return radix_tile_cols(groups, 0, lanes, c, PHASE_TILE_COLS,
                           PHASE_MIN_BLOCKS)


def radix_phases(rows: int, n1: int, n2: int,
                 fwd: bool) -> Tuple[Tuple[int, int, int], ...]:
    """(n, ncols, TC) of phases A and B of B1 (fwd: along n1 on n2
    columns, then along n2 on n1) or B2 (along n2 on n1 columns, then along
    n1 on n2)."""
    ab = ((n1, n2), (n2, n1)) if fwd else ((n2, n1), (n1, n2))
    return tuple((n, c, radix_tile_cols(rows, n, c)) for n, c in ab)


def traffic(name: str, x: torch.Tensor, nb: NttBasis):
    """(tensors read, other bytes) of one launch of kernel `name` on x,
    as its wrapper declares it (kernels.count): x, q and the kernel's
    basis tables read once; an output of x's size written, and for B1
    and B2 also their scratch of x's size, written and read back."""
    nbytes = 4 * x.numel() * (3 if name in ("ntt_fwd", "ntt_inv") else 1)
    return (x, nb.q, *(getattr(nb, k) for k in TABLES[name])), nbytes


def _launch(name: str, x: torch.Tensor, nb: NttBasis, rep: int,
            in_rows: int, in_cols: int) -> torch.Tensor:
    tables = TABLES[name]
    if not x.is_cuda:
        raise ValueError(f"{name}: CUDA kernel called on {x.device}")
    M = nb.q.shape[0]
    if rep < 1 or x.ndim != 3 or x.shape[0] != rep * M:
        raise ValueError(f"{name}: x {tuple(x.shape)} is not [{rep}*{M}, ...]")
    n1, n2 = nb.n1, nb.n2
    if any(m < 2 or m > _MAX_N or m & (m - 1) for m in (n1, n2)):
        raise ValueError(f"{name}: n1={n1}, n2={n2}: need powers of two in "
                         f"[2, {_MAX_N}]")
    kernels.require_cuda_int32("x", x, x.device, (rep * M, in_rows, in_cols))
    kernels.require_cuda_int32("q", nb.q, x.device, (M,))
    for k in tables:
        kernels.require_cuda_int32(k, getattr(nb, k), x.device)
    phases = radix_phases(rep * M, n1, n2, name == "ntt_fwd")
    lib = kernels.load()
    scratch = torch.empty_like(x)
    out = torch.empty((rep * M, in_cols, in_rows), dtype=torch.int32,
                      device=x.device)
    with torch.cuda.device(x.device):
        rc = getattr(lib, "hk_" + name)(
            kernels.ptr(x), kernels.ptr(scratch), kernels.ptr(out),
            kernels.ptr(nb.q),
            *(kernels.ptr(getattr(nb, k)) for k in tables),
            rep * M, M, n1, n2, *(tc.bit_length() - 1 for _, _, tc in phases),
            kernels.stream(x))
    kernels.check(rc, name)
    kernels.count(name, *traffic(name, x, nb))
    return out


def _launch_phase(name: str, x: torch.Tensor, nb: NttBasis, rep: int,
                  n: int, sliced=()) -> torch.Tensor:
    """One phase kernel on x [rep*M, n, c] (c a power of two up to n)
    -> a new [rep*M, n, c]. The tables named in `sliced` are per-element
    [M, n, c] (the shard's mid slice that B6 and B9 read); the others are
    flat stage tables [M, n]. The kernel also takes log2 of its tile
    width, phase_tile_cols'."""
    tables = TABLES[name]
    if not x.is_cuda:
        raise ValueError(f"{name}: CUDA kernel called on {x.device}")
    M = nb.q.shape[0]
    if rep < 1 or x.ndim != 3 or x.shape[0] != rep * M or x.shape[1] != n:
        raise ValueError(f"{name}: x {tuple(x.shape)} is not "
                         f"[{rep}*{M}, {n}, c]")
    c = x.shape[2]
    if n > _MAX_N or c < 1 or c > n or c & (c - 1):
        raise ValueError(f"{name}: n={n}, c={c}: need a power-of-two c <= "
                         f"n <= {_MAX_N}")
    kernels.require_cuda_int32("x", x, x.device)
    kernels.require_cuda_int32("q", nb.q, x.device, (M,))
    for k in tables:
        kernels.require_cuda_int32(
            k, getattr(nb, k), x.device,
            (M, n, c) if k in sliced else (M, n))
    tile = phase_tile_cols(rep * M, c, c)
    lib = kernels.load()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = getattr(lib, "hk_" + name)(
            kernels.ptr(x), kernels.ptr(out), kernels.ptr(nb.q),
            *(kernels.ptr(getattr(nb, k)) for k in tables),
            rep * M, M, n, c, tile.bit_length() - 1, kernels.stream(x))
    kernels.check(rc, name)
    kernels.count(name, *traffic(name, x, nb))
    return out


def ntt_phase1(x: torch.Tensor, nb: NttBasis, rep: int = 1) -> torch.Tensor:
    """Kernel B6: int32 [rep*M, n1, c] coeff columns on the GPU -> stage-1
    CT butterflies times nb.mid ([M, n1, c], this shard's slice): [rep*M,
    n1, c] in [0, q), not transposed (the exchange transposes)."""
    return _launch_phase("ntt_phase1", x, nb, rep, nb.n1, ("mid", "mid_sh"))


def ntt_phase2(x: torch.Tensor, nb: NttBasis, rep: int = 1) -> torch.Tensor:
    """Kernel B7: int32 [rep*M, n2, c] -> stage-2 CT butterflies, eval
    columns in [0, q)."""
    return _launch_phase("ntt_phase2", x, nb, rep, nb.n2)


def intt_phase2(x: torch.Tensor, nb: NttBasis, rep: int = 1) -> torch.Tensor:
    """Kernel B8: int32 [rep*M, n2, c] eval columns -> inverse stage-2 GS
    butterflies, in [0, q), on B2's phase A."""
    return _launch_phase("intt_phase2", x, nb, rep, nb.n2)


def intt_phase1(x: torch.Tensor, nb: NttBasis, rep: int = 1) -> torch.Tensor:
    """Kernel B9: int32 [rep*M, n1, c] -> times nb.mid_inv ([M, n1, c])
    in registers, then inverse stage-1 GS butterflies (B2's passes): coeff
    columns in [0, q)."""
    return _launch_phase("intt_phase1", x, nb, rep, nb.n1,
                         ("mid_inv", "mid_inv_sh"))


def _launch_packed(name: str, x: torch.Tensor, nb: NttBasis, rep: int,
                   n: int, mid=()) -> torch.Tensor:
    """One lane-packed phase kernel on x [rep*G, n, k*c] (k = nb.pack, G
    = ceil(M/k) groups a copy, c a power of two up to 32 with k*c a
    multiple of 32, as the JAX package packs, or c = 64 at k = 2, the
    width study's shape, also checked on the card) -> a new [rep*G, n,
    k*c]. The tables named in `mid` are the shard's per-limb [M, n, c]
    mid slice; the others flat [M, n] stage tables. Lane j of group g
    reads limb min((g mod G)*k + j div c, M - 1). The kernel also takes
    log2 of its tile width, phase_tile_cols'."""
    tables = TABLES[name]
    if not x.is_cuda:
        raise ValueError(f"{name}: CUDA kernel called on {x.device}")
    M, k = nb.q.shape[0], nb.pack
    G = -(-M // k) if k else 0
    if (k < 1 or rep < 1 or x.ndim != 3 or x.shape[0] != rep * G
            or x.shape[1] != n or x.shape[2] % k):
        raise ValueError(f"{name}: x {tuple(x.shape)} is not "
                         f"[{rep}*{G}, {n}, {k}*c] (pack k={k})")
    c = x.shape[2] // k
    if (n > _MAX_N or c < 1 or c > (64 if k == 2 else 32) or c & (c - 1)
            or k & (k - 1) or (k * c) % 32):
        raise ValueError(f"{name}: n={n}, k={k}, c={c}: need power-of-two "
                         f"k and c <= 32 (64 at k = 2), k*c a multiple of "
                         f"32, n <= {_MAX_N}")
    kernels.require_cuda_int32("x", x, x.device)
    kernels.require_cuda_int32("q", nb.q, x.device, (M,))
    for t in tables:
        kernels.require_cuda_int32(t, getattr(nb, t), x.device,
                                   (M, n, c) if t in mid else (M, n))
    tile = phase_tile_cols(rep * G, c, k * c)
    lib = kernels.load()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = getattr(lib, "hk_" + name)(
            kernels.ptr(x), kernels.ptr(out), kernels.ptr(nb.q),
            *(kernels.ptr(getattr(nb, t)) for t in tables),
            rep * G, G, M, k, n, c, tile.bit_length() - 1, kernels.stream(x))
    kernels.check(rc, name)
    kernels.count(name, *traffic(name, x, nb))
    return out


def ntt_phase1_packed(x: torch.Tensor, nb: NttBasis,
                      rep: int = 1) -> torch.Tensor:
    """Kernel B10: B6 on lane-packed groups, int32 [rep*G, n1, k*c] ->
    the same layout in [0, q) per lane."""
    return _launch_packed("ntt_phase1_packed", x, nb, rep, nb.n1,
                          ("mid", "mid_sh"))


def ntt_phase2_packed(x: torch.Tensor, nb: NttBasis,
                      rep: int = 1) -> torch.Tensor:
    """Kernel B11: B7 on lane-packed groups [rep*G, n2, k*c]."""
    return _launch_packed("ntt_phase2_packed", x, nb, rep, nb.n2)


def intt_phase2_packed(x: torch.Tensor, nb: NttBasis,
                       rep: int = 1) -> torch.Tensor:
    """Kernel B12: B8 on lane-packed groups [rep*G, n2, k*c], on B2's
    phase A."""
    return _launch_packed("intt_phase2_packed", x, nb, rep, nb.n2)


def intt_phase1_packed(x: torch.Tensor, nb: NttBasis,
                       rep: int = 1) -> torch.Tensor:
    """Kernel B13: B9 on lane-packed groups [rep*G, n1, k*c], the mid_inv
    product in registers before B2's GS passes."""
    return _launch_packed("intt_phase1_packed", x, nb, rep, nb.n1,
                          ("mid_inv", "mid_inv_sh"))


def ntt_fwd(x: torch.Tensor, nb: NttBasis, rep: int = 1) -> torch.Tensor:
    """Kernel B1: int32 [rep*M, n1, n2] coeff tiles on the GPU ->
    [rep*M, n2, n1] eval tiles in [0, q)."""
    return _launch("ntt_fwd", x, nb, rep, nb.n1, nb.n2)


def ntt_inv(x: torch.Tensor, nb: NttBasis, rep: int = 1) -> torch.Tensor:
    """Kernel B2: int32 [rep*M, n2, n1] eval tiles on the GPU ->
    [rep*M, n1, n2] coeff tiles in [0, q)."""
    return _launch("ntt_inv", x, nb, rep, nb.n2, nb.n1)
