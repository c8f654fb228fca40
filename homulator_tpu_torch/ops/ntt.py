"""4-step negacyclic NTT / iNTT over RNS limb arrays.

The counterpart of `homulator_tpu/ops/ntt.py:67-78, 109-273` without the
lane-packed branches. N = n1 * n2:

  forward  [M, n1, n2] coeff tiles: CT stages along n1 (stage twiddles
           `params.ntt.sub1.stage_tw`), mid twiddle `tw_mid`, transpose,
           CT stages along n2 -> [M, n2, n1] eval tiles
  inverse  [M, n2, n1] eval tiles: GS stages along n2, transpose, mid
           twiddle `tw_mid_inv` (carries 1/N), GS stages along n1
           -> [M, n1, n2] coeff tiles

Same butterfly network as `_ct_stages` / `_gs_stages` of the JAX package,
so the output order is its permuted evaluation order and every output is
the same canonical residue. `*_rep` transform rep stacked arrays over one
basis (tables shared: row i uses basis row i % M).

On a coefficient-sharded basis (`nb.shard`, inside a shard program of
parallel/comm.py) each transform is the phase-split form of the JAX
package's `_ntt_sharded` / `_intt_sharded`: the butterfly phases run on
this shard's column slices and the [n1, n2] transpose is one all_to_all:

  forward  [R, n1, n2/ns] -> phase 1 (B6: stage 1, mid slice) -> all_to_all
           + local transpose -> [R, n2, n1/ns] -> phase 2 (B7: stage 2)
  inverse  [R, n2, n1/ns] -> phase 2 (B8: inverse stage 2) -> all_to_all +
           local transpose -> [R, n1, n2/ns] -> phase 1 (B9: mid_inv slice,
           inverse stage 1)

The JAX package splits a rep-stacked transform into per-copy calls when
sharded (ops/ntt.py:232-236); here the rep copies stay in one launch per
phase and one exchange (the kernels index tables by limb % M), which moves
the same rows and gives the same bits.

Dispatch: a CPU tensor runs the plain PyTorch version below; a CUDA tensor
goes to the hand-written kernels (ops/ntt_kernels.py, csrc/ntt.cu).
"""

from __future__ import annotations

import torch

from ..context import NttBasis
from ..parallel import comm as comm_mod
from . import ntt_kernels
from .modmath import modadd, modsub, mulmod


def _ct_stages(x: torch.Tensor, tw: torch.Tensor, q: torch.Tensor):
    """CT (DIT) butterflies along axis 1 of int64 [R, n, m]; tw int64
    [R, n] flat stage twiddles; q int64 [R, 1, 1, 1]."""
    R, n, m = x.shape
    for s in range(n.bit_length() - 1):
        B, H = 1 << s, n >> (s + 1)
        xr = x.view(R, B, 2, H, m)
        u = xr[:, :, 0]
        v = mulmod(xr[:, :, 1], tw[:, B: 2 * B, None, None], q)
        x = torch.stack([modadd(u, v, q), modsub(u, v, q)], dim=2)
        x = x.view(R, n, m)
    return x


def _gs_stages(x: torch.Tensor, itw: torch.Tensor, q: torch.Tensor):
    """GS inverse butterflies along axis 1 (no 1/n factor)."""
    R, n, m = x.shape
    for s in range(n.bit_length() - 2, -1, -1):
        B, H = 1 << s, n >> (s + 1)
        xr = x.view(R, B, 2, H, m)
        u, v = xr[:, :, 0], xr[:, :, 1]
        s1 = mulmod(modsub(u, v, q), itw[:, B: 2 * B, None, None], q)
        x = torch.stack([modadd(u, v, q), s1], dim=2).view(R, n, m)
    return x


def _rep_tables(nb: NttBasis, rep: int, *names):
    return [getattr(nb, k).long().repeat((rep,) + (1,) * (getattr(nb, k).ndim - 1))
            for k in names]


def ntt_plain(x: torch.Tensor, nb: NttBasis, rep: int = 1) -> torch.Tensor:
    """Plain version of kernel B1: int32 [rep*M, n1, n2] -> [rep*M, n2, n1]."""
    q, tw1, mid, tw2 = _rep_tables(nb, rep, "q", "tw1", "mid", "tw2")
    q4 = q.view(-1, 1, 1, 1)
    y = _ct_stages(x.long(), tw1, q4)
    y = mulmod(y, mid, q4[:, 0])
    y = _ct_stages(y.transpose(1, 2).contiguous(), tw2, q4)
    return y.to(torch.int32)


def intt_plain(x: torch.Tensor, nb: NttBasis, rep: int = 1) -> torch.Tensor:
    """Plain version of kernel B2: int32 [rep*M, n2, n1] -> [rep*M, n1, n2]."""
    q, itw2, mid_inv, itw1 = _rep_tables(nb, rep, "q", "itw2", "mid_inv",
                                         "itw1")
    q4 = q.view(-1, 1, 1, 1)
    y = _gs_stages(x.long(), itw2, q4)
    y = mulmod(y.transpose(1, 2), mid_inv, q4[:, 0])
    return _gs_stages(y.contiguous(), itw1, q4).to(torch.int32)


def ntt_phase1_plain(x: torch.Tensor, nb: NttBasis,
                     rep: int = 1) -> torch.Tensor:
    """Plain version of kernel B6: stage-1 CT butterflies along n1, then
    times the mid slice. int32 [rep*M, n1, c] coeff columns -> [rep*M, n1,
    c] in [0, q); nb.mid is [M, n1, c]."""
    q, tw1, mid = _rep_tables(nb, rep, "q", "tw1", "mid")
    q4 = q.view(-1, 1, 1, 1)
    y = _ct_stages(x.long(), tw1, q4)
    return mulmod(y, mid, q4[:, 0]).to(torch.int32)


def ntt_phase2_plain(x: torch.Tensor, nb: NttBasis,
                     rep: int = 1) -> torch.Tensor:
    """Plain version of kernel B7: stage-2 CT butterflies along n2.
    int32 [rep*M, n2, c] -> [rep*M, n2, c] eval columns in [0, q)."""
    q, tw2 = _rep_tables(nb, rep, "q", "tw2")
    return _ct_stages(x.long(), tw2, q.view(-1, 1, 1, 1)).to(torch.int32)


def intt_phase2_plain(x: torch.Tensor, nb: NttBasis,
                      rep: int = 1) -> torch.Tensor:
    """Plain version of kernel B8: inverse stage-2 GS butterflies along n2.
    int32 [rep*M, n2, c] eval columns -> [rep*M, n2, c] in [0, q)."""
    q, itw2 = _rep_tables(nb, rep, "q", "itw2")
    return _gs_stages(x.long(), itw2, q.view(-1, 1, 1, 1)).to(torch.int32)


def intt_phase1_plain(x: torch.Tensor, nb: NttBasis,
                      rep: int = 1) -> torch.Tensor:
    """Plain version of kernel B9: times the mid_inv slice (carries 1/N),
    then inverse stage-1 GS butterflies along n1. int32 [rep*M, n1, c] ->
    [rep*M, n1, c] coeff columns in [0, q); nb.mid_inv is [M, n1, c]."""
    q, mid_inv, itw1 = _rep_tables(nb, rep, "q", "mid_inv", "itw1")
    q4 = q.view(-1, 1, 1, 1)
    y = mulmod(x, mid_inv, q4[:, 0])
    return _gs_stages(y, itw1, q4).to(torch.int32)


def _check_device(x: torch.Tensor):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _dispatch(kernel, plain):
    """A transform that runs plain on a CPU tensor and kernel on a CUDA
    tensor."""
    def run(x: torch.Tensor, nb: NttBasis, rep: int = 1) -> torch.Tensor:
        _check_device(x)
        return (kernel if x.is_cuda else plain)(x, nb, rep)
    run.__doc__ = plain.__doc__
    return run


ntt_phase1 = _dispatch(ntt_kernels.ntt_phase1, ntt_phase1_plain)
ntt_phase2 = _dispatch(ntt_kernels.ntt_phase2, ntt_phase2_plain)
intt_phase2 = _dispatch(ntt_kernels.intt_phase2, intt_phase2_plain)
intt_phase1 = _dispatch(ntt_kernels.intt_phase1, intt_phase1_plain)


def _transpose_a2a(y: torch.Tensor, nb: NttBasis) -> torch.Tensor:
    """The distributed tile transpose: y is this shard's column slice
    [R, a, b/ns] of a global [R, a, b]; returns its slice [R, b, a/ns] of
    the global transpose. One all_to_all (row chunk i to rank i, received
    blocks concatenated in rank order along the columns) and a local
    transpose, made contiguous for the next phase kernel."""
    comm = comm_mod.current()
    if (comm.rank, comm.size) != nb.shard:
        raise ValueError(f"basis sharded as {nb.shard} (rank, ns) run by "
                         f"rank {comm.rank} of {comm.size}")
    return comm.all_to_all(y, 1, 2).transpose(1, 2).contiguous()


def ntt_rep(x: torch.Tensor, nb: NttBasis, rep: int) -> torch.Tensor:
    """Forward NTT of rep stacked copies over one basis:
    [rep*M, n1, n2] -> [rep*M, n2, n1] int32 (sharded: [rep*M, n1, n2/ns]
    coeff columns -> [rep*M, n2, n1/ns] eval columns)."""
    _check_device(x)
    if nb.shard is not None:
        y = _transpose_a2a(ntt_phase1(x, nb, rep), nb)
        return ntt_phase2(y, nb, rep)
    if x.is_cuda:
        return ntt_kernels.ntt_fwd(x, nb, rep)
    return ntt_plain(x, nb, rep)


def intt_rep(x: torch.Tensor, nb: NttBasis, rep: int) -> torch.Tensor:
    """Inverse of ntt_rep: [rep*M, n2, n1] -> [rep*M, n1, n2] int32
    (sharded: [rep*M, n2, n1/ns] -> [rep*M, n1, n2/ns])."""
    _check_device(x)
    if nb.shard is not None:
        y = _transpose_a2a(intt_phase2(x, nb, rep), nb)
        return intt_phase1(y, nb, rep)
    if x.is_cuda:
        return ntt_kernels.ntt_inv(x, nb, rep)
    return intt_plain(x, nb, rep)


def ntt(x: torch.Tensor, nb: NttBasis) -> torch.Tensor:
    """[M, n1, n2] coeff tiles -> [M, n2, n1] eval tiles."""
    return ntt_rep(x, nb, 1)


def intt(x: torch.Tensor, nb: NttBasis) -> torch.Tensor:
    """[M, n2, n1] eval tiles -> [M, n1, n2] coeff tiles."""
    return intt_rep(x, nb, 1)
