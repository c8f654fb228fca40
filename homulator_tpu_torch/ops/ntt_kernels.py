"""Wrappers of the CUDA NTT kernels B1 (forward) and B2 (inverse).

They replace `homulator_tpu/ops/ntt_pallas.py::ntt_pallas` and
`::intt_pallas` (csrc/ntt.cu has the design note). Each transform is two
launches on PyTorch's current stream, through a scratch array the wrapper
allocates; the wrapper counts one launch of its kernel per transform. The
plain versions are `ntt_plain` / `intt_plain` in ops/ntt.py: callers
dispatch CPU tensors there, never here.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..context import NttBasis

_FWD_TABLES = ("tw1", "tw1_sh", "mid", "mid_sh", "tw2", "tw2_sh")
_INV_TABLES = ("itw2", "itw2_sh", "mid_inv", "mid_inv_sh", "itw1", "itw1_sh")
_MAX_N = 1024  # per-axis tile length: n * 33 words of shared memory


def _launch(name: str, x: torch.Tensor, nb: NttBasis, rep: int,
            tables, in_rows: int, in_cols: int) -> torch.Tensor:
    if not x.is_cuda:
        raise ValueError(f"{name}: CUDA kernel called on {x.device}")
    M = nb.q.shape[0]
    if rep < 1 or x.ndim != 3 or x.shape[0] != rep * M:
        raise ValueError(f"{name}: x {tuple(x.shape)} is not [{rep}*{M}, ...]")
    n1, n2 = nb.n1, nb.n2
    if max(n1, n2) > _MAX_N:
        raise ValueError(f"{name}: n1={n1}, n2={n2} above {_MAX_N}")
    kernels.require_cuda_int32("x", x, x.device, (rep * M, in_rows, in_cols))
    kernels.require_cuda_int32("q", nb.q, x.device, (M,))
    for k in tables:
        kernels.require_cuda_int32(k, getattr(nb, k), x.device)
    lib = kernels.load()
    scratch = torch.empty((rep * M, in_cols, in_rows), dtype=torch.int32,
                          device=x.device)
    out = torch.empty((rep * M, in_cols, in_rows), dtype=torch.int32,
                      device=x.device)
    with torch.cuda.device(x.device):
        rc = getattr(lib, "hk_" + name)(
            kernels.ptr(x), kernels.ptr(scratch), kernels.ptr(out),
            kernels.ptr(nb.q),
            *(kernels.ptr(getattr(nb, k)) for k in tables),
            rep * M, M, n1, n2, kernels.stream(x))
    kernels.check(rc, name)
    kernels.LAUNCHES[name] += 1
    return out


def ntt_fwd(x: torch.Tensor, nb: NttBasis, rep: int = 1) -> torch.Tensor:
    """Kernel B1: int32 [rep*M, n1, n2] coeff tiles on the GPU ->
    [rep*M, n2, n1] eval tiles in [0, q)."""
    return _launch("ntt_fwd", x, nb, rep, _FWD_TABLES, nb.n1, nb.n2)


def ntt_inv(x: torch.Tensor, nb: NttBasis, rep: int = 1) -> torch.Tensor:
    """Kernel B2: int32 [rep*M, n2, n1] eval tiles on the GPU ->
    [rep*M, n1, n2] coeff tiles in [0, q)."""
    return _launch("ntt_inv", x, nb, rep, _INV_TABLES, nb.n2, nb.n1)
