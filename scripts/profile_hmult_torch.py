#!/usr/bin/env python3
"""Where the device time of one hmult (or hrotate, or encrypted workload)
goes in the PyTorch + CUDA port.

    python3 scripts/profile_hmult_torch.py
        [--op hmult|hrotate|matvec_bsgs|logreg_sigmoid3] [--fused-hpip]
        [--ntt-mode auto|jnp] [--trace hmult_trace.json]

Runs the op at (45,35,15) of parameter set B (N = 2^16) eagerly on one
CUDA GPU (the workloads of homulator_tpu_torch/workloads.py at level 35:
the 64 x 64 BSGS matvec with g = 8, logreg over all 32768 slots; the host
engine on the native core), CALLS times after 3 warm-up calls, under
torch.profiler and
groups the CUDA kernels it launched by name: the port's kernels of the
single-device routes (B1 ntt_fwd, B2 ntt_inv, B3 bconv, B4 hpip with its
two launches apart, B5 bconv_step2), torch's copies and concatenations and gathers, its
reductions, and its other elementwise kernels (the int64 arithmetic of
homulator_tpu_torch/ops/modmath.py). `--fused-hpip` runs the key switch
on the fused HPIP route, `--ntt-mode jnp` on the graph route (B5 in place
of B3, the engine's ntt_mode). Prints each
group's device time and launches per op, after the card's name and power
limit. Imports no JAX and nothing of the JAX package.
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
    ("B5 bconv_step2", ("bconv_step2",)),
    ("B3 bconv", ("bconv",)),
    ("B4 hpip phase A", ("hpip_radix_a",)),
    ("B4 hpip phase B", ("hpip_radix_b",)),
    ("torch copies, concatenations and gathers",
     ("copy", "Cat", "Memcpy", "index", "gather")),
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
    ap.add_argument("--op", default="hmult", choices=[
        "hmult", "hrotate", "matvec_bsgs", "logreg_sigmoid3"])
    ap.add_argument("--fused-hpip", action="store_true",
                    help="key switch through the fused HPIP kernel B4")
    ap.add_argument("--ntt-mode", choices=["auto", "jnp"], default="auto",
                    help="the engine's key-switch route: accelerated (auto) "
                         "or graph (jnp)")
    ap.add_argument("--trace", help="write a Chrome trace to this path")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_hmult_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from homulator_tpu_torch import api, kernels, workloads
    from homulator_tpu_torch.api import get_params

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])

    params = get_params(n=1 << 16, max_level=45, alpha=15)
    eng = workloads.native_engine(params, seed=1, device="cuda",
                                  ntt_mode=args.ntt_mode)
    eng.keygen()
    if args.op == "hrotate":
        eng.gen_rotation_key(1)
    api.USE_FUSED_HPIP = args.fused_hpip
    rng = np.random.default_rng(7)
    slots = params.n // 2
    scale = float(1 << 29)
    ct1 = eng.encrypt_complex(rng.normal(size=slots), LEVEL, scale)
    ct2 = eng.encrypt_complex(rng.normal(size=slots), LEVEL, scale)
    if args.op == "matvec_bsgs":
        prep = workloads.matvec_prep(
            eng, rng.normal(size=(64, 64)) / 64, LEVEL, scale, 8)
    elif args.op == "logreg_sigmoid3":
        prep = workloads.logreg_prep(
            eng, rng.normal(size=slots) / np.sqrt(slots), 0.3, LEVEL, scale)
    ops = {"hmult": lambda: eng.hmult(ct1, ct2),
           "hrotate": lambda: eng.hrotate(ct1, 1),
           "matvec_bsgs": lambda: workloads.matvec_bsgs(ct1.data, prep),
           "logreg_sigmoid3": lambda: workloads.logreg_sigmoid3(ct1.data,
                                                                prep)}
    op = ops[args.op]

    for _ in range(3):
        op()
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(CALLS):
            op()
        torch.cuda.synchronize()
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)

    us, count = defaultdict(float), defaultdict(int)
    for e in prof.events():
        # the op's spans (stats.span) are mirrored on the device's
        # timeline as user annotations: not device work
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            g = group_of(e.name)
            us[g] += e.time_range.elapsed_us()
            count[g] += 1
    total = sum(us.values())
    if total == 0:
        raise RuntimeError("the profiler recorded no device kernels")
    route = ("graph" if args.ntt_mode == "jnp" else
             "fused HPIP" if args.fused_hpip else "piecewise")
    print(f"# {args.op}(45,{LEVEL},15), {route} key switch: device kernel "
          f"time {total / CALLS / 1e3:.3f} ms per {args.op} over {CALLS} "
          f"eager calls (torch.profiler); wrapper launches "
          f"{dict(kernels.LAUNCHES)}")
    print(f"| Share of device kernel time | ms / {args.op} | launches / "
          f"{args.op} | Group |")
    print("|---|---|---|---|")
    for g in sorted(us, key=us.get, reverse=True):
        print(f"| {100 * us[g] / total:.1f}% | {us[g] / CALLS / 1e3:.3f} "
              f"| {count[g] / CALLS:g} | {g} |")
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "homulator_tpu"))
    if bad:
        raise AssertionError(f"imported {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
