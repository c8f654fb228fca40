"""RNS base conversion: plain PyTorch version and the wrapper of kernel B3.

The counterpart of `homulator_tpu/ops/bconv_fused.py::bconv_fused` (and of
the centered conversion of `ops/bconv.py` + `keyswitch.modup_digit`'s
virtual count row); its plain version is ops/bconv.py's two steps. For x [nd, R, C] over input primes in_q:

  xh_i  = x_i * s_i mod in_q_i
  v     = #{i : xh_i >= (in_q_i >> 1) + 1}           (center=True only)
  out_j = (sum_i xh_i * mat[j, i] + v * mat[j, nd]) mod out_q_j

`mat` holds [m_out, nd (+1 with center)] plain residues mod out_q (the
centering column last). The TPU kernel's bf16 planes, 128-lane re-tile and
pairing epilogue compute the same residues and have no counterpart here.
"""

from __future__ import annotations

import torch

from .. import kernels
from .bconv import bconv_step1, bconv_step1_centered, bconv_step2_plain

_MAX_ND = 32  # csrc/bconv.cu instantiates nd <= 16 and nd <= 32


def bconv_plain(x, s, s_sh, in_q, mat, out_q, center: bool) -> torch.Tensor:
    """Plain version of kernel B3 on int64 carriers: step 1 (with the count
    row when centering), then step 2 (ops/bconv.py); int32 [m_out, R, C]."""
    nd = x.shape[0]
    if mat.shape[1] != nd + int(center):
        raise ValueError(f"matrix {tuple(mat.shape)} for {nd} input rows "
                         f"(center={center})")
    step1 = bconv_step1_centered if center else bconv_step1
    return bconv_step2_plain(step1(x, s, s_sh, in_q), mat, out_q)


def bconv_fused(x, s, s_sh, in_q, mat, mat_sh, out_q, *,
                center: bool = False) -> torch.Tensor:
    """Base conversion of int32 x [nd, R, C] -> int32 [m_out, R, C].

    s/s_sh: [nd] step-1 Shoup pair; mat/mat_sh: [m_out, nd+center] matrix
    Shoup pair (read by the kernel only). A CPU tensor runs bconv_plain; a
    CUDA tensor launches kernel B3 (csrc/bconv.cu)."""
    if x.device.type == "cpu":
        return bconv_plain(x, s, s_sh, in_q, mat, out_q, center)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    nd, R, C = x.shape
    m_out = out_q.shape[0]
    if nd > _MAX_ND:
        raise ValueError(f"bconv: nd={nd} above {_MAX_ND}")
    dev = x.device
    kernels.require_cuda_int32("x", x, dev)
    for name, t, shape in (("s", s, (nd,)), ("s_sh", s_sh, (nd,)),
                           ("in_q", in_q, (nd,)),
                           ("mat", mat, (m_out, nd + int(center))),
                           ("mat_sh", mat_sh, (m_out, nd + int(center))),
                           ("out_q", out_q, (m_out,))):
        kernels.require_cuda_int32(name, t, dev, shape)
    lib = kernels.load()
    out = torch.empty((m_out, R, C), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.hk_bconv(
            kernels.ptr(x), kernels.ptr(out), kernels.ptr(s),
            kernels.ptr(s_sh), kernels.ptr(in_q), kernels.ptr(mat),
            kernels.ptr(mat_sh), kernels.ptr(out_q), nd, int(center), m_out,
            R * C, kernels.stream(x))
    kernels.check(rc, "bconv")
    kernels.count("bconv")
    return out
