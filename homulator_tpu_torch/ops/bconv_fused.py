"""RNS base conversion: plain PyTorch version and the wrapper of kernel B3.

The counterpart of `homulator_tpu/ops/bconv_fused.py::bconv_fused` (and of
the centered conversion of `ops/bconv.py` + `keyswitch.modup_digit`'s
virtual count row); its plain version is ops/bconv.py's two steps. For x
[nd, R, C] (or a batch [B, nd, R, C], the batched hmult's: one launch,
the table shared) over input primes in_q:

  xh_i  = x_i * s_i mod in_q_i
  v     = #{i : xh_i >= (in_q_i >> 1) + 1}           (center=True only)
  out_j = (sum_i xh_i * mat[j, i] + v * mat[j, nd]) mod out_q_j

`mat` holds [m_out, nd (+1 with center)] plain residues mod out_q (the
centering column last). Kernel B3 (csrc/bconv.cu) computes step 2 as the
TPU kernel does, as a product of xh's byte planes with the table of
build_bf16_tables, on the tensor cores (csrc/planes_mma.cuh): it takes
that table in its device layout (mma_table) and its horner_sh where the
plain version takes `mat`.

The product alone is kernel B17 (bconv_planes_mm, csrc/bconv_mma.cu, on
the same core; it replaces `scripts/roofline.py::main._mm_kernel`): rows
[:m_out] of mbig @ planes(x). It is on no op's path; the roofline
(scripts/roofline_torch.py) times it beside B3 on a ModUp digit.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .bconv import bconv_step1, bconv_step1_centered, bconv_step2_plain

_MAX_ND = 32  # table columns / 4: build_bf16_tables' bound
RADIX_BITS = 8
NPLANES = 4  # ceil(30 / 8): primes < 2^30
# csrc/planes_mma.cuh's launch geometry: 8 warps a block, a warp's x tile
# [8 ks, 32] double-buffered with rows 40 words apart, table rows 32 ks +
# 16 bytes apart
_WARPS, _X_STRIDE, _TAB_PAD = 8, 40, 16
SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block can take


def _geometry(nd: int, m_out: int):
    """(k32 steps, blocks of 8 output rows) of a table of nd columns / 4."""
    return -(-nd // 8), -(-m_out // 8)


def mma_smem_bytes(nd: int, m_out: int, raw: bool) -> int:
    """Shared memory of a launch of B3 (raw False) or B17 (raw: mbig is
    staged as it is, too), planes_mma.cuh's Layout, for a table of nd
    columns / 4 and m_out output rows."""
    ks, jb = _geometry(nd, m_out)
    return (_WARPS * 2 * 8 * ks * _X_STRIDE * 4
            + jb * 32 * (32 * ks + _TAB_PAD) + int(raw) * 32 * m_out * nd
            + 8 * ks * 16 + jb * 8 * 8)


def mma_table(mbig: torch.Tensor) -> torch.Tensor:
    """The device layout of a table of build_bf16_tables for B3's
    tensor-core core (csrc/planes_mma.cuh): uint8 [32 jb, 32 ks + 16] on
    mbig's device, where byte 4 t + p of row (jb' * 4 + i) * 8 + r holds
    mbig[i * m_out + j, p * nd + t] for output row j = 8 jb' + r < m_out
    and input row t < nd, and every other byte is 0 (the last 16 of a row
    keep ldmatrix free of bank conflicts)."""
    m_out, nd = mbig.shape[0] // NPLANES, mbig.shape[1] // NPLANES
    ks, jb = _geometry(nd, m_out)
    mb = mbig.float().cpu().numpy().astype(np.uint8).reshape(
        NPLANES, m_out, NPLANES, nd)  # [i, j, p, t]
    tab = np.zeros((jb, NPLANES, 8, 32 * ks + _TAB_PAD), dtype=np.uint8)
    j = np.arange(m_out)
    tab[j // 8, :, j % 8, :4 * nd] = mb.transpose(1, 0, 3, 2).reshape(
        m_out, NPLANES, 4 * nd)  # [j, i, k = 4 t + p]
    return torch.from_numpy(tab.reshape(32 * jb, -1)).to(mbig.device)


def check_mma_table(name, tab, nd, m_out, dev):
    """Raise unless tab is a table in the device layout (mma_table) for nd
    columns / 4 and m_out output rows on dev that a launch of B3 or B5
    takes."""
    ks, jb = _geometry(nd, m_out)
    _check_table(name, tab, (32 * jb, 32 * ks + _TAB_PAD), torch.uint8, nd,
                 m_out, dev)


def _check_table(name, tab, shape, dtype, nd, m_out, dev):
    """Raise unless tab is a contiguous, 16-byte aligned `dtype` tensor of
    `shape` on dev, nd <= 32, and the launch fits a block's shared
    memory."""
    if nd > _MAX_ND:
        raise ValueError(f"{name}: nd={nd} above {_MAX_ND}")
    if tuple(tab.shape) != shape:
        raise ValueError(f"{name}: table {tuple(tab.shape)}, expected "
                         f"{shape} for {nd} input rows and {m_out} output "
                         "rows")
    if (tab.device != dev or tab.dtype != dtype or not tab.is_contiguous()
            or tab.data_ptr() % 16):
        raise ValueError(f"{name}: the table must be a contiguous, 16-byte "
                         f"aligned {dtype} tensor on x's device")
    if mma_smem_bytes(nd, m_out, dtype == torch.bfloat16) > SMEM_LIMIT:
        raise ValueError(f"{name}: m_out={m_out} needs more shared memory "
                         "than a block has")


def bconv_plain(x, s, s_sh, in_q, mat, out_q, center: bool) -> torch.Tensor:
    """Plain version of kernel B3 on int64 carriers: step 1 (with the count
    row when centering), then step 2 (ops/bconv.py); int32 [m_out, R, C]
    for x [nd, R, C], [B, m_out, R, C] for a batch x [B, nd, R, C] (the
    batch axis moved behind the rows, so the per-row constants broadcast
    over it: one set of tables for the whole batch)."""
    rows_first = x.transpose(0, 1) if x.ndim == 4 else x
    nd = rows_first.shape[0]
    if mat.shape[1] != nd + int(center):
        raise ValueError(f"matrix {tuple(mat.shape)} for {nd} input rows "
                         f"(center={center})")
    step1 = bconv_step1_centered if center else bconv_step1
    out = bconv_step2_plain(step1(rows_first, s, s_sh, in_q), mat, out_q)
    return out.transpose(0, 1).contiguous() if x.ndim == 4 else out


def bconv_traffic(x, s, s_sh, in_q, mat_mma, horner_sh, out_q):
    """(tensors read, other bytes) of one launch of B3 on x [nd, R, C] or
    [B, nd, R, C], as bconv_fused declares it (kernels.count): x and the
    kernel's tables read, the output written; in a batch every element
    reads the tables (each z-slice of the grid stages them), so a batch of
    B declares B times an element's bytes."""
    tables = (s, s_sh, in_q, mat_mma, horner_sh, out_q)
    batch = x.shape[0] if x.ndim == 4 else 1
    nbytes = (4 * out_q.shape[0] * (x.numel() // x.shape[-3])
              + (batch - 1) * sum(t.numel() * t.element_size()
                                  for t in tables))
    return (x,) + tables, nbytes


def bconv_fused(x, s, s_sh, in_q, mat, mat_mma, horner_sh, out_q, *,
                center: bool = False) -> torch.Tensor:
    """Base conversion of int32 x [nd, R, C] -> int32 [m_out, R, C], or of
    a batch x [B, nd, R, C] -> [B, m_out, R, C] in one launch (rows
    contiguous within an element; the elements any stride apart, so x may
    be a row slice of a larger batch).

    s/s_sh: [nd] step-1 Shoup pair; mat: [m_out, nd+center] plain matrix
    (read by the plain version only); mat_mma/horner_sh: the device layout
    of its build_bf16_tables table (mma_table) and that table's horner_sh
    (read by the kernel only). A CPU tensor runs bconv_plain; a CUDA tensor
    launches kernel B3 (csrc/bconv.cu), the batch as its grid's z axis.
    Its declared traffic: bconv_traffic."""
    if x.ndim not in (3, 4):
        raise ValueError(f"bconv: x {tuple(x.shape)} is not [nd, R, C] or "
                         "[B, nd, R, C]")
    traffic = bconv_traffic(x, s, s_sh, in_q, mat_mma, horner_sh, out_q)
    if x.device.type == "cpu":
        with kernels.as_kernel(*traffic):
            return bconv_plain(x, s, s_sh, in_q, mat, out_q, center)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    with kernels.unobserved():
        return _bconv_kernel(x, s, s_sh, in_q, mat_mma, horner_sh, out_q,
                             center, traffic)


def _bconv_kernel(x, s, s_sh, in_q, mat_mma, horner_sh, out_q, center,
                  traffic) -> torch.Tensor:
    nd, R, C = x.shape[-3:]
    batch = x.shape[0] if x.ndim == 4 else 1
    m_out = out_q.shape[0]
    dev = x.device
    check_mma_table("bconv", mat_mma, nd + int(center), m_out, dev)
    if x.ndim == 4:  # each element's [nd, R, C] contiguous, any stride apart
        kernels.require_cuda_int32("x[0]", x[0], dev)
        if batch > 65535 or x.stride(0) < nd * R * C:
            raise ValueError(f"bconv: a batch of {batch} elements "
                             f"{x.stride(0)} words apart is not one B3 "
                             "launch takes")
    else:
        kernels.require_cuda_int32("x", x, dev)
    for name, t, shape in (("s", s, (nd,)), ("s_sh", s_sh, (nd,)),
                           ("in_q", in_q, (nd,)),
                           ("horner_sh", horner_sh, (m_out,)),
                           ("out_q", out_q, (m_out,))):
        kernels.require_cuda_int32(name, t, dev, shape)
    lib = kernels.load()
    out = torch.empty(x.shape[:-3] + (m_out, R, C), dtype=torch.int32,
                      device=dev)
    with torch.cuda.device(dev):
        rc = lib.hk_bconv(
            kernels.ptr(x), kernels.ptr(out), kernels.ptr(s),
            kernels.ptr(s_sh), kernels.ptr(in_q), kernels.ptr(mat_mma),
            kernels.ptr(horner_sh), kernels.ptr(out_q), nd, int(center),
            m_out, R * C, batch, x.stride(0) if x.ndim == 4 else 0,
            m_out * R * C, kernels.stream(x))
    kernels.check(rc, "bconv")
    kernels.count("bconv", *traffic)
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
    """Kernel B17: the byte-plane product of a base conversion, x int32
    [nd, R, C] (a digit's rows with a zero row appended as the TPU kernel
    takes them, nd <= 32) and mbig bf16 [4*m_out, 4*nd] (build_bf16_tables)
    -> int32 [m_out, R, C], the plane-0 sums D_0. A CPU tensor runs
    bconv_planes_mm_plain; a CUDA tensor launches B17 (B3's tensor-core
    core, csrc/planes_mma.cuh), which computes all 4*m_out rows and stores
    the first m_out, as the TPU kernel does."""
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
    _check_table("bconv_planes_mm", mbig, tuple(mbig.shape), torch.bfloat16,
                 nd, m_out, x.device)
    lib = kernels.load()
    out = torch.empty((m_out, R, C), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.hk_bconv_planes_mm(kernels.ptr(x), kernels.ptr(mbig),
                                    kernels.ptr(out), nd, m_out, R * C,
                                    kernels.stream(x))
    kernels.check(rc, "bconv_planes_mm")
    kernels.count("bconv_planes_mm")
    return out
