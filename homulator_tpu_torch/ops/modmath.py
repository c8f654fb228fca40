"""Modular arithmetic on int64 carriers (plain PyTorch).

The counterpart of `homulator_tpu/ops/modmath.py`. Residues are stored as
int32 (q < 2^30) and every function here computes in int64, where a
product of two residues (< 2^60) is exact; torch on the CPU implements no
add, shift or compare for uint32. The TPU's 16-bit partial products and
approximate high word are workarounds for a machine without a 32x32->64
multiply and have no counterpart here (the CUDA kernels use `__umulhi`).

Inputs may be int32 or int64 tensors of canonical residues; `q` (and the
other per-prime constants) broadcast against them. Every result is an
int64 tensor in [0, q), except where a docstring says otherwise.
"""

from __future__ import annotations

from typing import Sequence

import torch

_MASK16 = 0xFFFF
_MASK32 = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int64 view of a tensor holding uint32 bit patterns (e.g. an int32
    Shoup quotient or -q^{-1} mod 2^32 whose top bit is set)."""
    return x.long() & _MASK32


def col(v: torch.Tensor, ndim: int = 3) -> torch.Tensor:
    """[K] per-prime constants as int64 [K, 1, ..., 1] against [K, ...]
    data of rank ndim ([K, R, C] tiles by default)."""
    return v.long().view((-1,) + (1,) * (ndim - 1))


def modadd(a, b, q) -> torch.Tensor:
    s = a.long() + b.long()
    return torch.where(s >= q, s - q, s)


def modsub(a, b, q) -> torch.Tensor:
    d = a.long() - b.long()
    return torch.where(d < 0, d + q, d)


def cond_sub(a, q) -> torch.Tensor:
    """One conditional subtract: [0, 2q) -> [0, q)."""
    a = a.long()
    return torch.where(a >= q, a - q, a)


def mulmod(a, b, q) -> torch.Tensor:
    """a * b mod q (both < 2^31: the product is exact in int64)."""
    return (a.long() * b.long()) % q


def shoup_mul(a, w, w_sh, q) -> torch.Tensor:
    """a * w mod q with w_sh = floor(w * 2^32 / q) (uint32 bits), for
    0 <= a < 2^31: r = a*w - floor(a*w_sh / 2^32)*q lies in [0, 2q)."""
    a = a.long()
    hi = (a * _u32(w_sh)) >> 32  # a * w_sh < 2^63
    return cond_sub(a * w.long() - hi * q, q)


def mont_mul(a, b_mont, q, qinv_neg) -> torch.Tensor:
    """a * b mod q for b_mont = b * 2^32 mod q (Montgomery REDC at radix
    2^32; qinv_neg = -q^{-1} mod 2^32 as uint32 bits). The low-word
    product m = lo * qinv_neg mod 2^32 is split at 16 bits so that no
    int64 intermediate wraps."""
    t = a.long() * b_mont.long()  # < 2^60
    lo = t & _MASK32
    qi = _u32(qinv_neg)
    m = (lo * (qi & _MASK16)
         + (((lo * (qi >> 16)) & _MASK16) << 16)) & _MASK32
    return cond_sub((t + m * q) >> 32, q)  # t + m*q < 2^63


def lazy_sum_reduce(terms: Sequence[torch.Tensor], q) -> torch.Tensor:
    """Sum of terms each in [0, 2q), reduced once at the end. int64 holds
    the unreduced sum of any practical number of terms (< 2^32 of them)."""
    acc = terms[0].long()
    for t in terms[1:]:
        acc = acc + t.long()
    return acc % q


def lazy_tree_sum(terms: torch.Tensor, q) -> torch.Tensor:
    """Reduce axis 0 of terms (each row in [0, 2q)) to one row in [0, q)."""
    return terms.long().sum(dim=0) % q
