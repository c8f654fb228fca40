"""RNS base conversion in two steps: the graph route's form, and the
wrapper of kernel B5.

The counterpart of `homulator_tpu/ops/bconv.py` (`bconv_step1`,
`bconv_step2`) and of `homulator_tpu/ops/bconv_pallas.py::
bconv_step2_pallas`, the kernel form of step 2. For x [nd, ...] over input
primes in_q and a matrix over output primes out_q:

  step 1  xhat_i = x_i * s_i mod in_q_i
  step 2  out_j  = sum_i xhat_i * mat[j, i] mod out_q_j

A centered conversion appends the count row v to xhat
(bconv_step1_centered) and reads it through the matrix's centering column;
step 2 takes the rows as they come. Step 1 is a PyTorch op on the int64
carrier, as the JAX package computes it outside any Pallas kernel; step 2
goes to B5 (csrc/bconv.cu, on B3's tensor-core core) on a CUDA tensor.
"""

from __future__ import annotations

import math

import torch

from .. import kernels
from .modmath import col, mulmod, shoup_mul

def bconv_step1(x, s, s_sh, in_q) -> torch.Tensor:
    """xhat_i = x_i * s_i mod in_q_i for x [nd, ...] (s/s_sh: [nd] Shoup
    pair). Returns int64 [nd, ...] in [0, in_q)."""
    r = x.ndim
    return shoup_mul(x, col(s, r), col(s_sh, r), col(in_q, r))


def bconv_step1_centered(x, s, s_sh, in_q) -> torch.Tensor:
    """Step 1 and the centering count row v = #{i : xhat_i >= (in_q_i >> 1)
    + 1}: int64 [nd+1, ...], the input rows of step 2 on a matrix whose
    last column is the centering column [-Q_in]."""
    xhat = bconv_step1(x, s, s_sh, in_q)
    v = (xhat >= (col(in_q, x.ndim) >> 1) + 1).sum(dim=0, keepdim=True)
    return torch.cat([xhat, v])


def bconv_step2_plain(xhat, mat, out_q) -> torch.Tensor:
    """Plain version of kernel B5 on int64 carriers: xhat [nd, ...] (any
    values below 2^31), mat [m_out, nd] plain residues mod out_q; each
    term reduced, then summed (the sum of nd <= 2^31 terms below 2^30 stays
    exact). Returns int32 [m_out, ...]."""
    nd, r = xhat.shape[0], xhat.ndim
    if mat.shape[1] != nd:
        raise ValueError(f"matrix {tuple(mat.shape)} for {nd} input rows")
    oq = col(out_q, r)
    m = mat.long()
    acc = torch.zeros((m.shape[0],) + tuple(xhat.shape[1:]),
                      dtype=torch.int64, device=xhat.device)
    for i in range(nd):
        acc += mulmod(xhat[i][None], col(m[:, i], r), oq)
    return (acc % oq).to(torch.int32)


def bconv_step2(xhat, mat, mat_mma, horner_sh, out_q) -> torch.Tensor:
    """out_j = sum_i xhat_i * mat[j, i] mod out_q_j: xhat [nd, ...] ->
    int32 [m_out, ...]. mat: [m_out, nd] plain residues (read by the plain
    version only); mat_mma/horner_sh: the device layout of mat's
    build_bf16_tables table (ops/bconv_fused.py::mma_table) and its
    horner_sh, which DeviceContext builds once (read by the kernel only).
    A CPU tensor runs bconv_step2_plain; any other call needs both tables
    (none is built per call), and a CUDA tensor launches kernel B5 (B3's
    tensor-core core with step 1 and the count off, csrc/bconv.cu), which
    takes nd <= 32. Its declared traffic: xhat read as int32, the
    tables read, the output written (kernels.count)."""
    traffic = ([t for t in (mat_mma, horner_sh, out_q) if t is not None],
               4 * (xhat.shape[0] + out_q.shape[0])
               * math.prod(xhat.shape[1:]))
    if xhat.device.type == "cpu":
        with kernels.as_kernel(*traffic):
            return bconv_step2_plain(xhat, mat, out_q)
    with kernels.unobserved():
        return _bconv_step2_kernel(xhat, mat_mma, horner_sh, out_q, traffic)


def _bconv_step2_kernel(xhat, mat_mma, horner_sh, out_q,
                        traffic) -> torch.Tensor:
    if mat_mma is None or horner_sh is None:
        raise ValueError("bconv_step2: kernel B5 takes the matrix's table "
                         "in the device layout and its horner_sh "
                         "(DeviceContext builds them); none given")
    if not xhat.is_cuda:
        raise ValueError(f"unsupported device {xhat.device}")
    from .bconv_fused import check_mma_table  # it imports this module

    nd, m_out = xhat.shape[0], out_q.shape[0]
    dev = xhat.device
    check_mma_table("bconv_step2", mat_mma, nd, m_out, dev)
    x = xhat.to(torch.int32).contiguous()
    for name, t in (("horner_sh", horner_sh), ("out_q", out_q)):
        kernels.require_cuda_int32(name, t, dev, (m_out,))
    lib = kernels.load()
    out = torch.empty((m_out,) + tuple(x.shape[1:]), dtype=torch.int32,
                      device=dev)
    with torch.cuda.device(dev):
        rc = lib.hk_bconv_step2(
            kernels.ptr(x), kernels.ptr(out), kernels.ptr(mat_mma),
            kernels.ptr(horner_sh), kernels.ptr(out_q), nd, m_out,
            x[0].numel(), kernels.stream(x))
    kernels.check(rc, "bconv_step2")
    kernels.count("bconv_step2", *traffic)
    return out
