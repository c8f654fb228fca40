"""4-step negacyclic NTT / iNTT over RNS limb arrays.

The counterpart of `homulator_tpu/ops/ntt.py:205-273` (single device).
N = n1 * n2:

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

Dispatch: a CPU tensor runs the plain PyTorch version below; a CUDA tensor
goes to the hand-written kernels (ops/ntt_kernels.py, csrc/ntt.cu).
"""

from __future__ import annotations

import torch

from ..context import NttBasis
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


def _check_device(x: torch.Tensor):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def ntt_rep(x: torch.Tensor, nb: NttBasis, rep: int) -> torch.Tensor:
    """Forward NTT of rep stacked copies over one basis:
    [rep*M, n1, n2] -> [rep*M, n2, n1] int32."""
    _check_device(x)
    if x.is_cuda:
        return ntt_kernels.ntt_fwd(x, nb, rep)
    return ntt_plain(x, nb, rep)


def intt_rep(x: torch.Tensor, nb: NttBasis, rep: int) -> torch.Tensor:
    """Inverse of ntt_rep: [rep*M, n2, n1] -> [rep*M, n1, n2] int32."""
    _check_device(x)
    if x.is_cuda:
        return ntt_kernels.ntt_inv(x, nb, rep)
    return intt_plain(x, nb, rep)


def ntt(x: torch.Tensor, nb: NttBasis) -> torch.Tensor:
    """[M, n1, n2] coeff tiles -> [M, n2, n1] eval tiles."""
    return ntt_rep(x, nb, 1)


def intt(x: torch.Tensor, nb: NttBasis) -> torch.Tensor:
    """[M, n2, n1] eval tiles -> [M, n1, n2] coeff tiles."""
    return intt_rep(x, nb, 1)
