"""Build and load the CUDA kernels of `csrc/`, and count their launches.

The sources have a plain C interface: each `.cu` is compiled by its own
`nvcc` process (all started together) and the objects are linked into one
shared library under `build/kernels/` at the root of the checkout (at first
use, once per source content), loaded with `ctypes`. Every pointer and
the CUDA stream cross as `c_void_p`; every C entry returns
`cudaGetLastError()` after its launches, and `check` raises on non-zero.

Nothing here runs at import: the CPU tests import every module of the
package on machines without `nvcc` or a GPU.

Each wrapper also declares what its kernel moves when it counts the
launch: the tensors the kernel reads and the bytes it writes. While a
byte count of `stats.OpCosts` (`CkksEngine.op_cost_counters`) is active,
`count` adds them to it, and a kernel's plain version runs under
`as_kernel`: unseen by the count, which takes the kernel's declared bytes
instead, so one op counts the same bytes on the CPU and on the card.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional, Sequence

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Launch counts per kernel wrapper: each wrapper adds one (`count`) where it
# launches its kernel, and nowhere else. The shard threads of a ThreadMesh
# launch concurrently, so updates and the first load hold a lock.
LAUNCHES = {"ntt_fwd": 0, "ntt_inv": 0, "bconv": 0, "hpip": 0,
            "bconv_step2": 0, "ip": 0, "moddown": 0,
            "ntt_phase1": 0, "ntt_phase2": 0, "intt_phase2": 0,
            "intt_phase1": 0, "ntt_phase1_packed": 0, "ntt_phase2_packed": 0,
            "intt_phase2_packed": 0, "intt_phase1_packed": 0,
            # on no op's path: the NTT anatomy (B14-B16), the bf16-plane
            # product (B17) and the roofline's peak chains
            "ntt_anatomy": 0, "ntt_shoup_forms": 0, "ntt_components": 0,
            "bconv_planes_mm": 0, "peak_square": 0, "peak_shoup": 0,
            "peak_mont": 0, "peak_stream": 0}

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    # x, scratch, out, q, 6 tables, rows, M, n1, n2, log2 of the tile
    # columns of phases A and B, stream
    "hk_ntt_fwd": [_P] * 10 + [_I] * 6 + [_P],
    "hk_ntt_inv": [_P] * 10 + [_I] * 6 + [_P],
    # x, out, q, 4 tables (B6: tw1, tw1_sh, mid, mid_sh; B9: mid_inv,
    # mid_inv_sh, itw1, itw1_sh) or 2 (B7, B8), rows, M, n, c, log2 of the
    # tile columns, stream
    "hk_ntt_phase1": [_P] * 7 + [_I] * 5 + [_P],
    "hk_ntt_phase2": [_P] * 5 + [_I] * 5 + [_P],
    "hk_intt_phase2": [_P] * 5 + [_I] * 5 + [_P],
    "hk_intt_phase1": [_P] * 7 + [_I] * 5 + [_P],
    # the lane-packed B10-B13: x, out, q, the same tables, rows (rep*G),
    # G, M, k, n, c, log2 of the tile lanes, stream
    "hk_ntt_phase1_packed": [_P] * 7 + [_I] * 7 + [_P],
    "hk_ntt_phase2_packed": [_P] * 5 + [_I] * 7 + [_P],
    "hk_intt_phase2_packed": [_P] * 5 + [_I] * 7 + [_P],
    "hk_intt_phase1_packed": [_P] * 7 + [_I] * 7 + [_P],
    # x, out, s, s_sh, in_q, the table's device layout, horner_sh, out_q,
    # nd, center, m_out, ncoef, batch, x's and out's batch strides, stream
    "hk_bconv": [_P] * 8 + [_I] * 3 + [ctypes.c_longlong, _I]
                + [ctypes.c_longlong] * 2 + [_P],
    # xhat, out, the table's device layout, horner_sh, out_q, nd, m_out,
    # ncoef, stream
    "hk_bconv_step2": [_P] * 5 + [_I] * 2 + [ctypes.c_longlong, _P],
    # convs, conv_rows, spans (host arrays), d_eval, key, scratch, out, q,
    # qinv, 6 tables, beta, alpha, level, k_full, n1, n2, log2 of the tile
    # columns of phases A and B, batch, d_eval's batch stride, stream
    "hk_hpip": [_P] * 15 + [_I] * 9 + [ctypes.c_longlong, _P],
    # convs, spans (host arrays), d_eval, key, out, q, qinv, beta, alpha,
    # level, k_full, plane (words a row), batch, stream
    "hk_ip": [_P] * 7 + [_I] * 4 + [ctypes.c_longlong, _I, _P],
    # ModDown's elementwise steps (B19-B21): acc0, acc1, their batch
    # stride, d0, d1, theirs, zl, q, pm, pm_sh, plane, batch, stream
    "hk_md_zl": [_P] * 2 + [_LL] + [_P] * 2 + [_LL] + [_P] * 4
                + [_LL, _I, _P],
    # b, zl, out, sp_q, s1, s1_sh, m2, m2_sh, q, pinv, pinv_sh, alpha,
    # plane, batch, stream
    "hk_md_head": [_P] * 11 + [_I, _LL, _I, _P],
    # acc0, acc1, their batch stride, d0, d1, theirs, with d, e, out, q,
    # pm, pm_sh, c, c_sh, rep, rows, plane, batch, stream
    "hk_md_tail": [_P] * 2 + [_LL] + [_P] * 2 + [_LL, _I] + [_P] * 7
                  + [_I] * 2 + [_LL, _I, _P],
    # x, out, q, mid, mid_sh, mid product, transposed, rows, M, n1, n2,
    # stream
    "hk_ntt_anatomy": [_P] * 5 + [_I] * 6 + [_P],
    # x, out, q, tw1, tw1_sh, Shoup form, runs, transposed, rows, M, n1, n2,
    # log2 of the tile columns, stream
    "hk_ntt_stages": [_P] * 5 + [_I] * 8 + [_P],
    # x, out, words, stream
    "hk_copy_words": [_P] * 2 + [ctypes.c_longlong, _P],
    # x, mbig, out, nd, m_out, ncoef, stream
    "hk_bconv_planes_mm": [_P] * 3 + [_I] * 2 + [ctypes.c_longlong, _P],
    # x, y, n, iters, op, three constants, stream
    "hk_peak_chain": [_P] * 2 + [ctypes.c_longlong] + [_I] * 2
                     + [ctypes.c_uint] * 3 + [_P],
    # z, x, out, n, stream
    "hk_peak_stream": [_P] * 3 + [ctypes.c_longlong, _P],
}


# Device kernels one launch of a wrapper runs, where it is not one: B1, B2
# and B4 each run their two radix phases as two kernels.
KERNELS_PER_LAUNCH = {"ntt_fwd": 2, "ntt_inv": 2, "hpip": 2}


def reset_launch_counts() -> None:
    with _LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


# The active byte count (a stats.OpCosts), or None: set by its `counting()`.
COSTS = None
# The span recorder (stats.SpanRecorder) while a span is open, or None: set
# by the recorder.
SPANS = None


def count(name: str, reads: Sequence[torch.Tensor] = (),
          nbytes: int = 0) -> None:
    """One launch of kernel `name` (called by its wrapper only), which
    reads the tensors `reads` and moves `nbytes` other bytes (its outputs
    written, a scratch array written and read back, an input it reads as
    int32): the declaration an active byte count adds. An open span
    (stats.span) is credited with the launch."""
    with _LOCK:
        LAUNCHES[name] += 1
    spans = SPANS
    if spans is not None:
        spans.launch(name)
    declare(reads, nbytes)


def declare(reads: Sequence[torch.Tensor], nbytes: int) -> None:
    """Add one kernel's declared traffic to the active byte count."""
    costs = COSTS
    if costs is not None:
        costs.kernel(reads, nbytes)


@contextlib.contextmanager
def unobserved():
    """A block whose aten calls the active byte count does not see: a
    kernel wrapper's own allocations and casts, or a plain version."""
    costs = COSTS
    if costs is None:
        yield
        return
    costs.paused += 1
    try:
        yield
    finally:
        costs.paused -= 1


@contextlib.contextmanager
def as_kernel(reads: Sequence[torch.Tensor], nbytes: int):
    """Run a kernel's plain version (on a CPU tensor) as the kernel it
    stands for: unobserved, then the kernel's declared traffic."""
    with unobserved():
        yield
    declare(reads, nbytes)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin)")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path() -> str:
    """Path of the library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libhomulator_kernels_{h.hexdigest()[:16]}.so")


def build() -> float:
    """Compile csrc/*.cu unless the library for these sources exists: one
    nvcc per source, all at once, then one link. Returns the seconds spent
    (0.0 when it was already built). nvcc's output, with ptxas's register
    and shared-memory report, goes to the `.log` beside the library."""
    out = library_path()
    if os.path.exists(out):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    srcs = [s for s in _sources() if s.endswith(".cu")]
    tmpdir = tempfile.mkdtemp(dir=BUILD_DIR)
    t0 = time.perf_counter()
    try:
        objs = [os.path.join(tmpdir, os.path.basename(s)[:-3] + ".o")
                for s in srcs]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", o, s],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [os.path.basename(s) for s, p in zip(srcs, procs)
                  if p.returncode != 0]
        lib = os.path.join(tmpdir, "lib.so")
        if not failed:
            link = subprocess.run(
                [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                 "-shared", "-o", lib, *objs],
                capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
            if link.returncode != 0:
                failed.append("link")
        seconds = time.perf_counter() - t0
        with open(out[:-3] + ".log", "w") as f:
            f.write("".join(logs))
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n"
                               + "".join(logs))
        os.replace(lib, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return seconds


def load() -> ctypes.CDLL:
    """The kernel library, built on first use in this process."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        build()
        lib = ctypes.CDLL(library_path())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.hk_error_string.argtypes = [ctypes.c_int]
        lib.hk_error_string.restype = ctypes.c_char_p
        _LIB = lib
        return _LIB


def check(rc: int, what: str) -> None:
    if rc != 0:
        msg = load().hk_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda_int32(name: str, t: torch.Tensor, device: torch.device,
                       shape=None) -> None:
    """Raise unless t is a contiguous int32 tensor on `device` (and of
    `shape` when given): what every kernel takes."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.int32")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
