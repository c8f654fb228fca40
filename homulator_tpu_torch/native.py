"""ctypes binding of the native host core (`native/ckks_core.cpp`).

The counterpart of `homulator_tpu/native.py`: the same entry points
(`ckks_ntt_fwd`, `ckks_ntt_inv`, `ckks_ewe_mul/add/sub`, `ckks_bconv`,
`ckks_core_version`) and the same flattened tables (`NativeNtt`), bit for
bit equal to the numpy reference (`refimpl.RefCkks`). It serves the host
side of the engine: key generation, encoding, encryption and decryption.

The library is compiled from the checkout's source at first use by `g++`
with the flags of `native/Makefile` (`CXXFLAGS`) into `build/native/` at
the root of the checkout, one file per content of source and flags and
per CPU that `-march=native` names there (`library_path`: a build
directory copied to another machine holds no library that its CPU may
lack instructions for), and is never the checked-in
`native/libckks_core.so`. A missing compiler or a failed build raises
with the compiler's output; there is no fallback.
Several processes may build at once: each compiles in a directory of its
own and moves the result into place with one `os.replace`.

Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_ROOT, "native", "ckks_core.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "native")
CXX = "g++"
# native/Makefile's flags (its -Wall aside: warnings change no code)
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-fopenmp", "-std=c++17",
            "-shared"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_TARGETS: Dict[str, str] = {}  # compiler -> its -march=native target
_LOCK = threading.Lock()

_U64P = np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS")


def _compiler() -> str:
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"native core: compiler {CXX!r} not found")
    return cxx


def _target(cxx: str) -> str:
    """The -march and -mtune lines of `cxx -march=native -Q --help=target`:
    the CPU that this machine's build is for."""
    if cxx not in _TARGETS:
        proc = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"native core: {cxx} -march=native -Q "
                               f"--help=target failed:\n{proc.stderr}")
        _TARGETS[cxx] = " ".join(
            " ".join(line.split()) for line in proc.stdout.splitlines()
            if line.split()[:1] in (["-march="], ["-mtune="]))
    return _TARGETS[cxx]


def library_path() -> str:
    """Path of the library for the current source, compiler, flags and
    CPU; raises when the compiler is missing."""
    cxx = _compiler()
    h = hashlib.sha256(" ".join([cxx, *CXXFLAGS, _target(cxx)]).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libckks_core_{h.hexdigest()[:16]}.so")


def build() -> float:
    """Compile the source unless its library exists. Returns the seconds
    spent (0.0 when it was already built); raises with g++'s output when
    the compiler is missing or fails."""
    out = library_path()
    if os.path.exists(out):
        return 0.0
    cxx = _compiler()
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmpdir = tempfile.mkdtemp(dir=os.path.dirname(out))
    t0 = time.perf_counter()
    try:
        lib = os.path.join(tmpdir, "lib.so")
        proc = subprocess.run([cxx, *CXXFLAGS, "-o", lib, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"native core: {CXX} failed "
                               f"(exit {proc.returncode}):\n"
                               + proc.stdout + proc.stderr)
        os.replace(lib, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return time.perf_counter() - t0


def _bind(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    c_int, c_ll = ctypes.c_int, ctypes.c_longlong
    for f in (lib.ckks_ntt_fwd, lib.ckks_ntt_inv):
        f.argtypes = [_U64P, c_int, c_int, c_int, _U64P, _U64P, _U64P, _U64P]
        f.restype = None
    for f in (lib.ckks_ewe_mul, lib.ckks_ewe_add, lib.ckks_ewe_sub):
        f.argtypes = [_U64P, _U64P, _U64P, c_int, c_ll, _U64P]
        f.restype = None
    lib.ckks_bconv.argtypes = [_U64P, _U64P, _U64P, c_int, c_int, c_ll, _U64P]
    lib.ckks_bconv.restype = None
    lib.ckks_core_version.argtypes = []
    lib.ckks_core_version.restype = c_int
    return lib


def load() -> ctypes.CDLL:
    """The library for the current source and flags, built first if it
    is not there (raises if that fails)."""
    with _LOCK:
        path = library_path()
        if path not in _LIBS:
            build()
            _LIBS[path] = _bind(path)
        return _LIBS[path]


def load_if_built() -> Optional[ctypes.CDLL]:
    """The library if it is already built for the current source,
    compiler, flags and CPU, else None (also without a compiler); never
    builds."""
    with _LOCK:
        if shutil.which(CXX) is None:
            return None
        path = library_path()
        if path not in _LIBS:
            if not os.path.exists(path):
                return None
            _LIBS[path] = _bind(path)
        return _LIBS[path]


class NativeNtt:
    """Per-params flattened tables for the native NTT (psi_br layout),
    as the JAX package's NativeNtt holds them, on the library `lib`."""

    def __init__(self, params, lib: Optional[ctypes.CDLL] = None):
        self.p = params
        self.lib = load() if lib is None else lib
        t = params.ntt
        K = params.num_primes
        self.n1, self.n2 = t.n1, t.n2

        def flat(stages, n):
            out = np.zeros((K, n), dtype=np.uint64)
            for s, arr in enumerate(stages):
                out[:, (1 << s): (1 << (s + 1))] = arr
            return np.ascontiguousarray(out)

        self.psi1 = flat(t.sub1.stage_tw, t.n1)
        self.psi2 = flat(t.sub2.stage_tw, t.n2)
        self.ipsi1 = flat(t.sub1.inv_stage_tw, t.n1)
        self.ipsi2 = flat(t.sub2.inv_stage_tw, t.n2)
        self.tw_mid = np.ascontiguousarray(t.tw_mid.reshape(K, -1))
        self.tw_mid_inv = np.ascontiguousarray(t.tw_mid_inv.reshape(K, -1))
        self.qs = np.ascontiguousarray(params.q_arr)

    def _input(self, x: np.ndarray, idx: np.ndarray) -> np.ndarray:
        """A copy of x ([len(idx), N] residues) for the in-place C call."""
        out = np.array(x, dtype=np.uint64, order="C")
        if out.shape != (len(idx), self.n1 * self.n2):
            raise ValueError(f"native NTT: x {out.shape}, expected "
                             f"({len(idx)}, {self.n1 * self.n2})")
        return out

    def ntt(self, x: np.ndarray, idx) -> np.ndarray:
        idx = np.asarray(idx)
        out = self._input(x, idx)
        self.lib.ckks_ntt_fwd(
            out, out.shape[0], self.n1, self.n2,
            *(np.ascontiguousarray(a[idx])
              for a in (self.qs, self.psi1, self.tw_mid, self.psi2)))
        return out

    def intt(self, x: np.ndarray, idx) -> np.ndarray:
        idx = np.asarray(idx)
        out = self._input(x, idx)
        self.lib.ckks_ntt_inv(
            out, out.shape[0], self.n1, self.n2,
            *(np.ascontiguousarray(a[idx])
              for a in (self.qs, self.ipsi1, self.tw_mid_inv, self.ipsi2)))
        return out
