"""RNS base conversion: plain PyTorch version and the wrapper of kernel B3.

The counterpart of `homulator_tpu/ops/bconv_fused.py::bconv_fused` (and of
the centered conversion of `ops/bconv.py` + `keyswitch.modup_digit`'s
virtual count row); its plain version is ops/bconv.py's two steps. For x [nd, R, C] over input primes in_q:

  xh_i  = x_i * s_i mod in_q_i
  v     = #{i : xh_i >= (in_q_i >> 1) + 1}           (center=True only)
  out_j = (sum_i xh_i * mat[j, i] + v * mat[j, nd]) mod out_q_j

`mat` holds [m_out, nd (+1 with center)] plain residues mod out_q (the
centering column last). The TPU kernel's bf16 planes, 128-lane re-tile and
pairing epilogue compute the same residues and have no counterpart in B3.

Its bf16-plane product alone is kernel B17 (bconv_planes_mm,
csrc/bconv_mma.cu, the port's first tensor-core kernel; it replaces
`scripts/roofline.py::main._mm_kernel`): rows [:m_out] of mbig @ planes(x)
with the table of build_bf16_tables. It is on no op's path; the roofline
(scripts/roofline_torch.py) times it beside B3 on a ModUp digit.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .bconv import bconv_step1, bconv_step1_centered, bconv_step2_plain

_MAX_ND = 32  # csrc/bconv.cu instantiates nd <= 16 and nd <= 32
RADIX_BITS = 8
NPLANES = 4  # ceil(30 / 8): primes < 2^30


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


def build_bf16_tables(mat_plain, q_rows):
    """The port's copy of `homulator_tpu/ops/bconv_fused.py::
    build_bf16_tables`. mat_plain: [m_out, nd] plain residues (the
    centering column included); q_rows: [m_out] output primes (array-likes
    of non-negative integers). Returns (mbig bf16 [4*m_out, 4*nd], whose
    row i*m_out + j, column k*nd + t holds byte i of mat[j, t] * 2^(8k) mod
    q_j; horner_sh int32 [m_out], the Shoup quotient of 2^16 mod each
    q_j). Raises above nd = 32, the pairing epilogue's bound (the JAX
    function asserts it)."""
    mat = np.asarray(mat_plain).astype(np.uint64)
    m_out, nd = mat.shape
    if nd > _MAX_ND:
        raise ValueError(f"build_bf16_tables: nd={nd} above {_MAX_ND} "
                         "(pairing epilogue bound)")
    q = np.asarray(q_rows).astype(np.uint64)
    mbig = np.zeros((NPLANES, m_out, NPLANES * nd), dtype=np.float32)
    for k in range(NPLANES):
        mk = (mat << np.uint64(RADIX_BITS * k)) % q[:, None]
        for i in range(NPLANES):
            plane = (mk >> np.uint64(RADIX_BITS * i)) & np.uint64(255)
            mbig[i, :, k * nd: (k + 1) * nd] = plane.astype(np.float32)
    horner_sh = ((np.uint64(1 << 16) << np.uint64(32)) // q).astype(np.uint32)
    return (torch.from_numpy(mbig.reshape(NPLANES * m_out, NPLANES * nd)).to(
        torch.bfloat16), torch.from_numpy(horner_sh.view(np.int32)))


def byte_planes(x: torch.Tensor) -> torch.Tensor:
    """The byte planes of x [nd, ...] stacked plane-major: [4*nd, ...]."""
    x = x.long() & 0xFFFFFFFF
    return torch.cat([(x >> (RADIX_BITS * k)) & 255 for k in range(NPLANES)])


def bconv_planes_mm_plain(x: torch.Tensor, mbig: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel B17: rows [:m_out] of mbig @ planes(x) in
    float64, exact (every sum is an integer below 2^24 << 2^53); int32
    [m_out, R, C] for x int32 [nd, R, C]."""
    nd, R, C = x.shape
    m_out = mbig.shape[0] // NPLANES
    planes = byte_planes(x).view(NPLANES * nd, R * C).double()
    d = mbig[:m_out].double() @ planes
    return d.to(torch.int32).view(m_out, R, C)


def bconv_planes_mm(x: torch.Tensor, mbig: torch.Tensor) -> torch.Tensor:
    """Kernel B17: the bf16-plane product of a base conversion, x int32
    [nd, R, C] (a digit's rows with a zero row appended as the TPU kernel
    takes them, nd <= 32) and mbig bf16 [4*m_out, 4*nd] (build_bf16_tables)
    -> int32 [m_out, R, C], the plane-0 sums D_0. A CPU tensor runs
    bconv_planes_mm_plain; a CUDA tensor launches B17 (mma.sync bf16 with
    f32 accumulation), which computes all 4*m_out rows and stores the first
    m_out, as the TPU kernel does."""
    nd, R, C = x.shape
    m_out = mbig.shape[0] // NPLANES
    if nd > _MAX_ND:
        raise ValueError(f"bconv_planes_mm: nd={nd} above {_MAX_ND}")
    if tuple(mbig.shape) != (NPLANES * m_out, NPLANES * nd):
        raise ValueError(f"bconv_planes_mm: table {tuple(mbig.shape)} for "
                         f"{nd} input rows")
    if x.device.type == "cpu":
        return bconv_planes_mm_plain(x, mbig)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    kernels.require_cuda_int32("x", x, x.device)
    if (mbig.device != x.device or mbig.dtype != torch.bfloat16
            or not mbig.is_contiguous()):
        raise ValueError("mbig: a contiguous bf16 tensor on x's device")
    if (R * C) % 256 or m_out > 64:
        raise ValueError(f"bconv_planes_mm: R*C={R * C} not a multiple of "
                         f"256, or m_out={m_out} above 64")
    lib = kernels.load()
    out = torch.empty((m_out, R, C), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.hk_bconv_planes_mm(kernels.ptr(x), kernels.ptr(mbig),
                                    kernels.ptr(out), nd, m_out, R * C,
                                    kernels.stream(x))
    kernels.check(rc, "bconv_planes_mm")
    kernels.count("bconv_planes_mm")
    return out
