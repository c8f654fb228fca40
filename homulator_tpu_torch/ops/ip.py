"""Key-switch inner product of the piecewise route: plain PyTorch version
and the wrapper of kernel B18 (csrc/ip.cu).

Reached through `keyswitch.inner_product_pieces`, which sends a CPU tensor
to ip_plain and a CUDA tensor to ip_kernel. For ext row r (specials
first, K = alpha + level rows) and key component k:

  acc[k, r] = sum_d term_d[r] * key[d, k, r]      (Montgomery-form key)
  term_d[r] = conv_d[r]               r < alpha + lo_d
            = d_eval[r - alpha]       alpha + lo_d <= r < alpha + hi_d
            = conv_d[r - nd_d]        otherwise (nd_d = hi_d - lo_d)

conv_d holds digit d's converted rows in the eval domain, its own rows
left out (modup_conv_all's pieces, or their automorphisms on the hoisted
route). Both versions return int32 [..., 2, K, R, C] in [0, q), laid out
as keyswitch.hpip_acc returns it; a batch (d_eval [B, level, R, C], conv_d
[B, rows_d, R, C]) under one key is one launch. The work is elementwise
over the last two axes, so a column slice of a coefficient-sharded basis
([R, C / ns] tiles) takes the same code.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..context import KeySwitchLevelTables
from .modmath import col, lazy_sum_reduce, mont_mul

_MAX_BETA = 16  # csrc/ip.cu kMaxBeta


def traffic(convs, d_eval: torch.Tensor, key: torch.Tensor,
            kt: KeySwitchLevelTables):
    """(tensors read, other bytes) of one launch of B18, as ip_kernel
    declares it (kernels.count): the conversion pieces, d_eval, the
    digits' key rows, q and qinv read once; the output [..., 2, K, R, C]
    written. The key is read once a launch, whatever the batch."""
    K = kt.special_nt.q.shape[0] + kt.level
    reads = (*convs, d_eval, key[:len(kt.digits), :, :K], kt.ext_nt.q,
             kt.ext_qinv)
    return reads, 4 * 2 * K * d_eval[..., 0, :, :].numel()


def ip_plain(convs, d_eval: torch.Tensor, key: torch.Tensor,
             kt: KeySwitchLevelTables) -> torch.Tensor:
    """Plain version of kernel B18, on int64 carriers: each digit lifted to
    the ext basis (its converted rows around its own rows of d_eval),
    Montgomery products against the key, the lazy sum over digits reduced
    once. Returns int32 [..., 2, K, R, C] in [0, q)."""
    alpha = kt.special_nt.q.shape[0]
    K = alpha + kt.level
    q, qinv = col(kt.ext_nt.q), col(kt.ext_qinv)
    exts = []
    for conv, dt in zip(convs, kt.digits):
        cut = alpha + dt.lo  # converted rows before the digit's own rows
        exts.append(torch.cat([conv[..., :cut, :, :],
                               d_eval[..., dt.lo:dt.hi, :, :],
                               conv[..., cut:, :, :]], dim=-3))
    return torch.stack([
        lazy_sum_reduce([mont_mul(e, key[d, k, :K], q, qinv)
                         for d, e in enumerate(exts)], q)
        for k in (0, 1)], dim=-4).to(torch.int32)


def ip_kernel(convs, d_eval: torch.Tensor, key: torch.Tensor,
              kt: KeySwitchLevelTables) -> torch.Tensor:
    """Kernel B18 on the GPU: one launch for both key components and the
    whole batch; counts one launch. Same arguments and result as
    ip_plain; raises on what the kernel does not take (the checks run in
    this order, so each shows on any device: digits, shapes and dtypes,
    alignment, then the device)."""
    alpha = kt.special_nt.q.shape[0]
    level = kt.level
    K = alpha + level
    beta = len(kt.digits)
    dev = d_eval.device
    lead = tuple(d_eval.shape[:-3])
    if len(lead) > 1:
        raise ValueError(f"ip: d_eval {tuple(d_eval.shape)} is not [level, "
                         "R, C] or [B, level, R, C]")
    if len(convs) != beta or beta > _MAX_BETA:
        raise ValueError(f"ip: {len(convs)} conversion pieces for {beta} "
                         f"digits (at most {_MAX_BETA})")
    R, C = d_eval.shape[-2:]
    plane = R * C
    if plane % 4:
        raise ValueError(f"ip: a row of {R} x {C} words is not a multiple "
                         "of 4 (16-byte vectors)")
    kernels.require_cuda_int32("d_eval", d_eval, dev, lead + (level, R, C))
    if (key.ndim != 5 or key.shape[0] < beta or key.shape[1] != 2
            or key.shape[2] < K or tuple(key.shape[3:]) != (R, C)):
        raise ValueError(f"ip: key {tuple(key.shape)} is not "
                         f"[>={beta}, 2, >={K}, {R}, {C}]")
    kernels.require_cuda_int32("key", key, dev)
    for d, (c, dt) in enumerate(zip(convs, kt.digits)):
        kernels.require_cuda_int32(f"convs[{d}]", c, dev,
                                   lead + (K - (dt.hi - dt.lo), R, C))
    kernels.require_cuda_int32("q", kt.ext_nt.q, dev, (K,))
    kernels.require_cuda_int32("qinv", kt.ext_qinv, dev, (K,))
    if any(kernels.ptr(t) % 16 for t in (*convs, d_eval, key)):
        raise ValueError("ip: an operand is not 16-byte aligned")
    if not d_eval.is_cuda:
        raise ValueError(f"ip: CUDA kernel called on {dev}")
    lib = kernels.load()
    conv_ptrs = (ctypes.c_void_p * beta)(*(kernels.ptr(c) for c in convs))
    spans = (ctypes.c_int * (2 * beta))(
        *(v for dt in kt.digits for v in (dt.lo, dt.hi)))
    out = torch.empty(lead + (2, K, R, C), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.hk_ip(
            ctypes.addressof(conv_ptrs), ctypes.addressof(spans),
            kernels.ptr(d_eval), kernels.ptr(key), kernels.ptr(out),
            kernels.ptr(kt.ext_nt.q), kernels.ptr(kt.ext_qinv), beta, alpha,
            level, key.shape[2], plane, lead[0] if lead else 1,
            kernels.stream(d_eval))
    kernels.check(rc, "ip")
    kernels.count("ip", *traffic(convs, d_eval, key, kt))
    return out
