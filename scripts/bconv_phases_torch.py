#!/usr/bin/env python3
"""Where the time goes inside kernel B3: SM cycles (clock64) of each phase
of csrc/planes_mma.cuh's schedule, from an instrumented copy of B3.

    python3 scripts/bconv_phases_torch.py

Copies csrc/bconv.cu and its headers into build/bconv_phases/, inserts
clock64 reads between the phases of `hk::planes::run` (the staging loads
of the first x tile, the table and the constants, and the barrier after
them; the table's rewrite, which B3 skips; step 1 and the count; the loop
over blocks of 8 output rows, with its products and epilogue; the last
barrier) and has thread 0 of the first and the last block write them to
a device array, builds that copy with the flags of kernels.py and runs it
on set B's ModUp digit 0 (15+1 -> 35 rows) at N = 2^16, on a 4-shard slice
(c = 64) and on 999 coefficients, each bit-exact against bconv_plain. Fails
if an insertion point is missing from the sources. Prints the card's name,
power limit and SM clock, the cycles of each phase and the device time
of the copy (benchlib.device_ms); the reads cost a few cycles each.
Imports no JAX and nothing of the JAX package.
"""

import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "bconv_phases")
PHASES = ("staging loads", "table rewrite", "step 1 + count",
          "output blocks", "last barrier", "total")
# (file, anchor, text inserted after it)
PROBES = [
    ("planes_mma.cuh", "namespace hk {\nnamespace planes {\n",
     "__device__ long long g_phase[16];\n"),
    ("planes_mma.cuh", "                                    uint8_t* smem, "
     "const Layout& lay) {\n",
     "  long long T[6];\n  T[0] = clock64();\n"),
    ("planes_mma.cuh", "  cp_async_wait<0>();\n  __syncthreads();\n",
     "  T[1] = clock64();\n"),
    ("planes_mma.cuh", "    convert_table(tab, raw, lay);\n"
     "    __syncthreads();\n  }\n", "  T[2] = clock64();\n"),
    ("planes_mma.cuh", "    op.count(a, cnt);\n", "    T[3] = clock64();\n"),
    ("planes_mma.cuh", "      op.store(jb, d, c0, full);\n    }\n",
     "    T[4] = clock64();\n"),
]
TAIL = ("  __syncthreads();\n  T[5] = clock64();\n"
        "  const int slot = blockIdx.x == 0 ? 0 : 8;\n"
        "  if (threadIdx.x == 0 && (blockIdx.x == 0 || blockIdx.x == "
        "gridDim.x - 1)) {\n"
        "    for (int i = 0; i < 5; ++i)\n"
        "      g_phase[slot + i] = T[i + 1] - T[i];\n"
        "    g_phase[slot + 5] = T[5] - T[0];\n  }\n")
LOOP_END = ("      op.store(jb, d, c0, full);\n    }\n    T[4] = clock64();\n"
            "  }\n")


def instrumented_library(kernels):
    """Build the instrumented copy of B3; returns the loaded library."""
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    src = {f: open(os.path.join(kernels.CSRC, f)).read()
           for f in ("bconv.cu", "planes_mma.cuh", "modarith.cuh")}
    for f, anchor, text in PROBES:
        if src[f].count(anchor) != 1:
            raise RuntimeError(f"{f}: insertion point not found once: "
                               f"{anchor!r}")
        src[f] = src[f].replace(anchor, anchor + text)
    if src["planes_mma.cuh"].count(LOOP_END) != 1:
        raise RuntimeError("planes_mma.cuh: end of run's tile loop not found")
    src["planes_mma.cuh"] = src["planes_mma.cuh"].replace(
        LOOP_END, LOOP_END + TAIL)
    src["bconv.cu"] += ('\nextern "C" int hk_phases(long long* out) {\n'
                        "  return cudaMemcpyFromSymbol(out, g_phase, "
                        "sizeof(g_phase));\n}\n")
    for f, text in src.items():
        with open(os.path.join(OUT, f), "w") as fh:
            fh.write(text)
    lib = os.path.join(OUT, "libbconv_phases.so")
    r = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
                        "-o", lib, os.path.join(OUT, "bconv.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError("nvcc failed:\n" + r.stdout + r.stderr)
    cdll = ctypes.CDLL(lib)
    cdll.hk_bconv.argtypes = kernels._SIGNATURES["hk_bconv"]
    cdll.hk_phases.argtypes = [ctypes.c_void_p]
    return cdll


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bconv_phases_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from homulator_tpu_torch import benchlib, kernels
    from homulator_tpu_torch.api import get_params
    from homulator_tpu_torch.context import DeviceContext
    from homulator_tpu_torch.ops.bconv_fused import bconv_plain

    lib = instrumented_library(kernels)
    print(benchlib.card_line())
    print("# SM clock (nvidia-smi): " + subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    dc = DeviceContext(get_params(n=1 << 16, max_level=45, alpha=15), "cuda")
    dt = dc.keyswitch_tables(35).digits[0]
    n1, n2 = dc.params.ntt.n1, dc.params.ntt.n2
    nd, m_out = dt.hi - dt.lo, dt.other_nt.q.shape[0]
    for label, shape in ((f"modup digit0 {nd}+1->{m_out} N=2^16", (n1, n2)),
                         ("ns=4 c=64 slice", (n1, n2 // 4)),
                         ("999 coefficients", (27, 37))):
        x = benchlib.residues(dt.in_q, (nd,) + shape, 1)
        out = torch.empty((m_out,) + shape, dtype=torch.int32, device="cuda")

        def call():
            rc = lib.hk_bconv(
                x.data_ptr(), out.data_ptr(), dt.step1.data_ptr(),
                dt.step1_sh.data_ptr(), dt.in_q.data_ptr(),
                dt.mat_mma.data_ptr(), dt.horner_sh.data_ptr(),
                dt.other_nt.q.data_ptr(), nd, 1, m_out,
                shape[0] * shape[1], 1, 0, 0,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"hk_bconv: CUDA error {rc}")

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        if not torch.equal(out, bconv_plain(x, dt.step1, dt.step1_sh,
                                            dt.in_q, dt.mat, dt.other_nt.q,
                                            True)):
            raise AssertionError(f"{label}: != bconv_plain")
        buf = (ctypes.c_longlong * 16)()
        lib.hk_phases(ctypes.addressof(buf))
        for who, slot in (("first block", 0), ("last block", 8)):
            print(f"# {label}, {who}, cycles: " + ", ".join(
                f"{p} {buf[slot + i]}" for i, p in enumerate(PHASES)))
        print(f"# {label}: device time {benchlib.device_ms(call):.4f} ms "
              "(instrumented copy)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
