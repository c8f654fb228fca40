"""The roofline's peak-rate chains (csrc/peaks.cu) and their plain versions.

Counterparts of scripts/roofline.py:170-267, the loops XLA fuses on the
TPU: on x int32 [n] (uint32 bits),

  chain(x, iters, "square")  y = y*y + 12345 mod 2^32, iters * S links
  chain(x, iters, "shoup")   y = y*W mod Q (Shoup), iters * S links
  chain(x, iters, "mont")    y = y*W_MONT*2^-32 mod Q (Montgomery), the same
  stream(z, x)               z*2654435761 ^ x mod 2^32, one pass

with S = 32 links an iteration and roofline.py's constants: Q = 716799361
(the largest prime band, below 2^32/6), W = 123456789. The chains start
from residues in [0, Q) (the Shoup and Montgomery links need them). A CPU
tensor runs the plain version (int64 carriers, products split at 16 bits
where they would exceed int64); a CUDA tensor launches the kernel, counted
under peak_square, peak_shoup, peak_mont or peak_stream, or raises.
"""

from __future__ import annotations

import torch

from .. import kernels
from .modmath import _MASK16, _MASK32, _u32, mont_mul, shoup_mul

S = 32
Q = 716799361
W = 123456789 % Q
W_SH = (W << 32) // Q
W_MONT = (W << 32) % Q
QINV_NEG = (-pow(Q, -1, 1 << 32)) % (1 << 32)
STREAM_MUL = 2654435761
_OPS = {"square": (0, 0, 0, 0), "shoup": (1, W, W_SH, Q),
        "mont": (2, W_MONT, Q, QINV_NEG)}


def _mul32(a: torch.Tensor, c) -> torch.Tensor:
    """a * c mod 2^32 for uint32 values a (int64) and c (int64 or int),
    without an int64 product above 2^48: c's high half adds only the low
    16 bits of its product, shifted."""
    return (a * (c & _MASK16) + (((a * (c >> 16)) & _MASK16) << 16)) & _MASK32


def _to_i32(a: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> int32 with the same low 32 bits."""
    return torch.where(a >= 1 << 31, a - (1 << 32), a).to(torch.int32)


def chain_plain(x: torch.Tensor, iters: int, op: str) -> torch.Tensor:
    """Plain version of the chain kernel: iters * S links of `op`."""
    if op not in _OPS:
        raise ValueError(f"unknown chain {op!r}")
    y = _u32(x)
    # filled on the device: no host copy, so the chain can be captured in
    # a CUDA graph
    w, w_sh, w_mont, qinv = (torch.full((), v, dtype=torch.int64,
                                        device=x.device)
                             for v in (W, W_SH, W_MONT, QINV_NEG))
    for _ in range(iters * S):
        if op == "square":
            y = (_mul32(y, y) + 12345) & _MASK32
        elif op == "shoup":
            y = shoup_mul(y, w, w_sh, Q)
        else:
            y = mont_mul(y, w_mont, Q, qinv)
    return _to_i32(y)


def stream_plain(z: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version of the stream kernel: z*2654435761 ^ x mod 2^32."""
    return _to_i32(_mul32(_u32(z), STREAM_MUL) ^ _u32(x))


def chain(x: torch.Tensor, iters: int, op: str) -> torch.Tensor:
    """iters * S links of chain `op` (square, shoup or mont) over x int32
    [n] (residues in [0, Q) for shoup and mont)."""
    if x.device.type == "cpu":
        return chain_plain(x, iters, op)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    kernels.require_cuda_int32("x", x, x.device)
    if x.ndim != 1 or iters < 0 or op not in _OPS:
        raise ValueError(f"chain {op!r} over x {tuple(x.shape)}, iters "
                         f"{iters}")
    lib = kernels.load()
    y = torch.empty_like(x)
    code, a, b, c = _OPS[op]
    with torch.cuda.device(x.device):
        rc = lib.hk_peak_chain(kernels.ptr(x), kernels.ptr(y), x.numel(),
                               iters, code, a, b, c, kernels.stream(x))
    kernels.check(rc, f"peak_{op}")
    kernels.count(f"peak_{op}")
    return y


def stream(z: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One streaming pass z*2654435761 ^ x over int32 [n] (n % 4 == 0)."""
    if z.device.type == "cpu":
        return stream_plain(z, x)
    if not z.is_cuda:
        raise ValueError(f"unsupported device {z.device}")
    kernels.require_cuda_int32("z", z, z.device)
    kernels.require_cuda_int32("x", x, z.device, tuple(z.shape))
    if z.ndim != 1 or z.numel() % 4:
        raise ValueError(f"stream over {tuple(z.shape)}: need [4k]")
    lib = kernels.load()
    out = torch.empty_like(z)
    with torch.cuda.device(z.device):
        rc = lib.hk_peak_stream(kernels.ptr(z), kernels.ptr(x),
                                kernels.ptr(out), z.numel(),
                                kernels.stream(z))
    kernels.check(rc, "peak_stream")
    kernels.count("peak_stream")
    return out
