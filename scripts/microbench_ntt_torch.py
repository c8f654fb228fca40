#!/usr/bin/env python3
"""The forward NTT's first phase, cut into its parts and timed.

    python3 scripts/microbench_ntt_torch.py [--root DIR]

The port's counterpart of scripts/microbench_ntt.py. On M = 35 limbs of
random residues at parameter set B (n1 = n2 = 256), kernel B14
(csrc/anatomy.cu, ops/anatomy.py::ntt_anatomy) runs each variant alone,
every output transposed ([M, n2, n1]): copy, midT (the mid-table Shoup
product), stages1 (the 8 stage-1 CT stages), stages2x (16 stages, stage 1
twice) and full, the NTT itself (kernel B1). Each is reported in
microseconds per limb from its device time (CUDA-graph replay). On Hopper
a 256 KiB limb does not fit one block, so B1 is two launches; under
torch.profiler the script also times them apart: ntt_fwd_radix_a (stage 1,
mid, transposed store) and ntt_fwd_radix_b (stage 2). Prints the card's
name and power limit, then one JSON line. Times the `homulator_tpu_torch`
of DIR (default: this checkout; another one, such as an earlier commit
unpacked with `git archive`, builds its own kernels under its own
build/). To compare two commits, run both in one call on one card, in
turns: parent, change, change, parent. Imports no JAX and nothing of the
JAX package.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M = 35
CALLS = 20  # profiled B1 calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose homulator_tpu_torch is timed")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("microbench_ntt_torch: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from homulator_tpu_torch import benchlib
    from homulator_tpu_torch.context import DeviceContext
    from homulator_tpu_torch.ops.anatomy import B14_VARIANTS, ntt_anatomy
    from homulator_tpu_torch.params import get_params

    if not benchlib.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {benchlib.__file__}, not from {root}")
    print(benchlib.card_line())
    dc = DeviceContext(get_params(n=1 << 16, max_level=45, alpha=15), "cuda")
    nb = dc.ntt_basis(dc.main_rows(M))
    x = benchlib.residues(nb.q, (M, nb.n1, nb.n2))
    out = {"root": root}
    for v in B14_VARIANTS:
        ms = benchlib.device_ms(lambda: ntt_anatomy(x, nb, v))
        out[f"{v}_ms"] = ms
        out[f"{v}_us_per_limb"] = 1e3 * ms / M
        print(f"{v:10s} {ms:.4f} ms, {out[f'{v}_us_per_limb']:8.3f} us/limb")
    for _ in range(3):
        ntt_anatomy(x, nb, "full")
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            ntt_anatomy(x, nb, "full")
        torch.cuda.synchronize()
    for half in ("ntt_fwd_radix_a", "ntt_fwd_radix_b"):
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and half in e.name]
        if len(us) != CALLS:
            raise RuntimeError(f"the profiler saw {len(us)} {half} kernels "
                               f"in {CALLS} calls")
        out[f"full_{half}_us_per_limb"] = sum(us) / CALLS / M
        print(f"full {half} {out[f'full_{half}_us_per_limb']:8.3f} us/limb "
              "(torch.profiler)")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
