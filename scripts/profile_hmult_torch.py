#!/usr/bin/env python3
"""Where the device time of one hmult goes in the PyTorch + CUDA port.

    python3 scripts/profile_hmult_torch.py [--trace chiprun_out/hmult_trace.json]

Runs hmult(45,35,15) of parameter set B (N = 2^16) eagerly on one CUDA GPU,
CALLS times after 3 warm-up calls, under torch.profiler and groups the CUDA
kernels it launched by name: the port's three kernels (B1 ntt_fwd, B2 ntt_inv, B3 bconv), torch's
copies and concatenations, its reductions, and its other elementwise
kernels (the int64 arithmetic of homulator_tpu_torch/ops/modmath.py).
Prints each group's device time and launches per hmult, after the card's
name and power limit. Imports no JAX.
"""

import argparse
import os
import subprocess
import sys
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVEL = 35
CALLS = 10

GROUPS = (  # (group, substrings of the kernel name); the first match wins
    ("B1 ntt_fwd", ("ntt_fwd",)),
    ("B2 ntt_inv", ("ntt_inv",)),
    ("B3 bconv", ("bconv",)),
    ("torch copies and concatenations", ("copy", "Cat", "Memcpy")),
    ("torch reductions", ("reduce",)),
    ("torch elementwise", ("elementwise", "Memset")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", help="write a Chrome trace to this path")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_hmult_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from homulator_tpu_torch import kernels
    from homulator_tpu_torch.api import CkksEngine, get_params

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])

    params = get_params(n=1 << 16, max_level=45, alpha=15)
    eng = CkksEngine(params, seed=1, device="cuda")
    eng.keygen()
    rng = np.random.default_rng(7)
    slots = params.n // 2
    scale = float(1 << 29)
    ct1 = eng.encrypt_complex(rng.normal(size=slots), LEVEL, scale)
    ct2 = eng.encrypt_complex(rng.normal(size=slots), LEVEL, scale)
    for _ in range(3):
        eng.hmult(ct1, ct2)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(CALLS):
            eng.hmult(ct1, ct2)
        torch.cuda.synchronize()
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)

    us, count = defaultdict(float), defaultdict(int)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            g = group_of(e.name)
            us[g] += e.time_range.elapsed_us()
            count[g] += 1
    total = sum(us.values())
    if total == 0:
        raise RuntimeError("the profiler recorded no device kernels")
    print(f"# hmult(45,{LEVEL},15): device kernel time "
          f"{total / CALLS / 1e3:.3f} ms per hmult over {CALLS} eager calls "
          f"(torch.profiler); wrapper launches {dict(kernels.LAUNCHES)}")
    print("| Share of device kernel time | ms / hmult | launches / hmult "
          "| Group |")
    print("|---|---|---|---|")
    for g in sorted(us, key=us.get, reverse=True):
        print(f"| {100 * us[g] / total:.1f}% | {us[g] / CALLS / 1e3:.3f} "
              f"| {count[g] / CALLS:g} | {g} |")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    return 0


if __name__ == "__main__":
    sys.exit(main())
