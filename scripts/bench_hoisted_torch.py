#!/usr/bin/env python3
"""Hoisted rotations on the port: k rotations of one ciphertext sharing
one ModUp (Halevi-Shoup hoisting, CkksEngine.hrotate_hoisted) against k
single hrotate calls, at parameter set B (N = 2^16, maxLevel 45, level
35, alpha 15), steps 1, 2, 4, 8.

    python3 scripts/bench_hoisted_torch.py

The counterpart of scripts/bench_hoisted.py, with its keys
(k_rotations, hoisted_ms_for_k, hoisted_ms_per_rotation,
single_hrotate_ms, speedup_vs_k_singles) on the device time (CUDA-graph
replay, benchlib.device_ms), and the same keys with the prefix eager_ on
the eager latency (CUDA events, median of 20 after 3 warm-ups,
benchlib.latency_ms). The single hrotate is step 1, as the JAX script's.
The hoisted outputs are checked bit for bit against the single hrotates
first. Hoisting runs the piecewise route (the JAX package's choice). One
JSON line with the card's name and power limit. Needs the card; imports
no JAX and nothing of the JAX package.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

STEPS = [1, 2, 4, 8]


def main() -> int:
    import torch

    from homulator_tpu_torch import benchlib, kernels
    from homulator_tpu_torch.params import get_params
    from homulator_tpu_torch.workloads import native_engine

    if not torch.cuda.is_available():
        raise SystemExit("bench_hoisted_torch: needs a CUDA card")
    kernels.build()
    n, level = 65536, 35
    eng = native_engine(get_params(n=n, max_level=45, alpha=15), seed=1)
    eng.keygen()
    for s in STEPS:
        eng.gen_rotation_key(s)
    m = np.zeros(eng.params.n, dtype=np.int64)
    m[0] = int(3 * 2.0**29)
    ct = eng.encrypt_ints(m, level, 2.0**29)
    outs = eng.hrotate_hoisted(ct, STEPS)
    for s, o in zip(STEPS, outs):
        if not torch.equal(o.data, eng.hrotate(ct, s).data):
            raise AssertionError(f"hrotate_hoisted step {s} != hrotate")

    def hoisted():
        return eng.hrotate_hoisted(ct, STEPS)

    def single():
        return eng.hrotate(ct, 1)

    k = len(STEPS)
    out = {"card": benchlib.card_line(), "backend": "cuda",
           "shape": "L=45 l=35 alpha=15", "steps": STEPS}
    for prefix, timer in (("", lambda fn: benchlib.device_ms(fn, calls=2)),
                          ("eager_", benchlib.latency_ms)):
        h, s1 = timer(hoisted), timer(single)
        out.update({
            f"{prefix}k_rotations": k,
            f"{prefix}hoisted_ms_for_k": h,
            f"{prefix}hoisted_ms_per_rotation": h / k,
            f"{prefix}single_hrotate_ms": s1,
            f"{prefix}speedup_vs_k_singles": k * s1 / h,
        })
    for key, v in out.items():
        print(f"{key:34s} {v}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
