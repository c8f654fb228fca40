"""Fused ModUp NTT + key inner product (the HPIP unit): plain PyTorch
version and the wrapper of kernel B4.

The counterpart of `homulator_tpu/ops/hpip_pallas.py::hpip_fused`, reached
through `keyswitch.hpip_acc`, which sends a CPU tensor to hpip_plain and a
CUDA tensor to hpip_kernel. For ext row r (specials first, K = alpha +
level rows) and key component k:

  acc[k, r] = sum_d term_d[r] * key[d, k, r]      (Montgomery-form key)
  term_d[r] = NTT(conv_d[row r])   r outside digit d's own rows
            = d_eval[r - alpha]    r one of them

conv_d holds digit d's converted rows in the COEFF domain (ext order minus
its own rows: conv-local row r for r < alpha+lo, r - nd for r >= alpha+hi).
The result is the inner product of the unfused route
(`inner_product_pieces(modup_conv_all(...))`) without the eval-domain
lifted digits ever being stored. csrc/hpip.cu has the design note: two
launches on B1's register radix passes, their tile widths from
hpip_phases. A batch (the batched hmult's: conv_d [B, rows_d, n1, n2],
d_eval [B, level, n2, n1] -> [B, 2, K, n2, n1]) under one key is one
launch pair, the batch the grids' z axis.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import kernels
from ..context import KeySwitchLevelTables
from .modmath import mont_mul
from .ntt import ntt_plain
from .ntt_kernels import radix_tile_cols

_MAX_BETA = 16  # csrc/hpip.cu kMaxBeta
_MAX_N = 256  # per-axis length, csrc/hpip.cu kMaxLog: N <= 2^16
_FWD_TABLES = ("tw1", "tw1_sh", "mid", "mid_sh", "tw2", "tw2_sh")


def hpip_phases(conv_rows: int, K: int, n1: int, n2: int):
    """Tile columns (TC) of B4's two launches: phase A transforms each of
    conv_rows converted rows along n1 on n2 columns, as B1's phase A;
    phase B each of K ext rows along n2 on n1 columns, as B1's phase B."""
    return radix_tile_cols(conv_rows, n1, n2), radix_tile_cols(K, n2, n1)


def traffic(convs, d_eval: torch.Tensor, key: torch.Tensor,
            kt: KeySwitchLevelTables):
    """(tensors read, other bytes) of one launch of B4, as hpip_kernel
    declares it (kernels.count): the conversion pieces, d_eval, the
    digits' key rows, q, qinv and the ext basis's forward tables read;
    the output [2, K, n2, n1] written and the phase-A scratch (one row a
    converted row) written and read back. In a batch of B (d_eval [B,
    level, n2, n1]) every element reads the key rows and the tables (each
    z-slice of the grids does), so it declares B times an element's
    bytes."""
    nt = kt.ext_nt
    K = kt.special_nt.q.shape[0] + kt.level
    n = nt.n1 * nt.n2
    batch = d_eval.shape[0] if d_eval.ndim == 4 else 1
    shared = (key[:len(kt.digits), :, :K], nt.q, kt.ext_qinv,
              *(getattr(nt, k) for k in _FWD_TABLES))
    reads = (*convs, d_eval) + shared
    rows = sum(c.shape[-3] for c in convs)
    return reads, (batch * 4 * n * (2 * K + 2 * rows)
                   + (batch - 1) * sum(t.numel() * t.element_size()
                                       for t in shared))


def hpip_plain(convs, d_eval: torch.Tensor, key: torch.Tensor,
               kt: KeySwitchLevelTables) -> torch.Tensor:
    """Plain version of kernel B4: each digit's converted rows through
    ntt_plain, its own rows from d_eval, Montgomery products against the
    key, and the sum over digits. Returns int32 [2, K, n2, n1] in [0, q),
    or [B, 2, K, n2, n1] for a batch (d_eval [B, level, n2, n1], conv_d
    [B, rows_d, n1, n2]; the key and the tables broadcast over it)."""
    alpha = kt.special_nt.q.shape[0]
    K = alpha + kt.level
    q = kt.ext_nt.q.long().view(1, -1, 1, 1)
    qinv = kt.ext_qinv.long().view(1, -1, 1, 1)
    acc = 0
    for d, (conv, dt) in enumerate(zip(convs, kt.digits)):
        t = ntt_plain(conv.reshape((-1,) + conv.shape[-2:]), dt.other_nt,
                      math.prod(conv.shape[:-3]))
        t = t.view(conv.shape[:-2] + t.shape[-2:])
        cut = alpha + dt.lo  # converted rows before the digit's own rows
        term = torch.cat([t[..., :cut, :, :], d_eval[..., dt.lo:dt.hi, :, :],
                          t[..., cut:, :, :]], dim=-3)
        acc = acc + mont_mul(term.unsqueeze(-4), key[d, :, :K], q, qinv)
    return (acc % q).to(torch.int32)


def hpip_kernel(convs, d_eval: torch.Tensor, key: torch.Tensor,
                kt: KeySwitchLevelTables) -> torch.Tensor:
    """Kernel B4 on the GPU (two launches through a phase-A scratch, tile
    widths from hpip_phases); counts one launch. Same arguments and
    result as hpip_plain; a batch (d_eval [B, level, n2, n1], each
    piece [B, rows_d, n1, n2]) is one launch pair."""
    dev = d_eval.device
    if not d_eval.is_cuda:
        raise ValueError(f"hpip: CUDA kernel called on {dev}")
    nt = kt.ext_nt
    n1, n2 = nt.n1, nt.n2
    alpha = kt.special_nt.q.shape[0]
    level = kt.level
    K = alpha + level
    beta = len(kt.digits)
    lead = tuple(d_eval.shape[:-3])
    batch = d_eval.shape[0] if lead else 1
    if len(lead) > 1 or batch > 65535:
        raise ValueError(f"hpip: d_eval {tuple(d_eval.shape)} is not [level, "
                         "n2, n1] or [B, level, n2, n1] (B <= 65535)")
    if len(convs) != beta or beta > _MAX_BETA:
        raise ValueError(f"hpip: {len(convs)} conversion pieces for {beta} "
                         f"digits (at most {_MAX_BETA})")
    if any(m < 2 or m > _MAX_N or m & (m - 1) for m in (n1, n2)):
        raise ValueError(f"hpip: n1={n1}, n2={n2}: need powers of two in "
                         f"[2, {_MAX_N}]")
    kernels.require_cuda_int32("d_eval", d_eval, dev, lead + (level, n2, n1))
    if (key.ndim != 5 or key.shape[0] < beta or key.shape[1] != 2
            or key.shape[2] < K or tuple(key.shape[3:]) != (n2, n1)):
        raise ValueError(f"hpip: key {tuple(key.shape)} is not "
                         f"[>={beta}, 2, >={K}, {n2}, {n1}]")
    kernels.require_cuda_int32("key", key, dev)
    rows = []
    for d, (c, dt) in enumerate(zip(convs, kt.digits)):
        rows.append(K - (dt.hi - dt.lo))
        kernels.require_cuda_int32(f"convs[{d}]", c, dev,
                                   lead + (rows[-1], n1, n2))
    kernels.require_cuda_int32("q", nt.q, dev, (K,))
    kernels.require_cuda_int32("qinv", kt.ext_qinv, dev, (K,))
    for k in _FWD_TABLES:
        kernels.require_cuda_int32(k, getattr(nt, k), dev)
    lib = kernels.load()
    conv_ptrs = (ctypes.c_void_p * beta)(*(kernels.ptr(c) for c in convs))
    conv_rows = (ctypes.c_int * beta)(*rows)
    spans = (ctypes.c_int * (2 * beta))(
        *(v for dt in kt.digits for v in (dt.lo, dt.hi)))
    tc_a, tc_b = hpip_phases(batch * sum(rows), batch * K, n1, n2)
    scratch = torch.empty(lead + (sum(rows), n2, n1), dtype=torch.int32,
                          device=dev)
    out = torch.empty(lead + (2, K, n2, n1), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.hk_hpip(
            ctypes.addressof(conv_ptrs), ctypes.addressof(conv_rows),
            ctypes.addressof(spans), kernels.ptr(d_eval), kernels.ptr(key),
            kernels.ptr(scratch), kernels.ptr(out), kernels.ptr(nt.q),
            kernels.ptr(kt.ext_qinv),
            *(kernels.ptr(getattr(nt, k)) for k in _FWD_TABLES),
            beta, alpha, level, key.shape[2], n1, n2,
            tc_a.bit_length() - 1, tc_b.bit_length() - 1, batch,
            level * n1 * n2, kernels.stream(d_eval))
    kernels.check(rc, "hpip")
    kernels.count("hpip", *traffic(convs, d_eval, key, kt))
    return out
