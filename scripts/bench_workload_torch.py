#!/usr/bin/env python3
"""End-to-end encrypted-workload benchmark of the port: BSGS matvec.

    python3 scripts/bench_workload_torch.py [--smoke] [--device cuda|cpu]
                                            [--fused-hpip]

The counterpart of scripts/bench_workload.py: a d x d encrypted
matrix-vector product (one dense layer under encryption, the diagonal
method with baby and giant steps, homulator_tpu_torch/workloads.py) at
parameter set B (N = 2^16, 45 main + 15 special primes, alpha 15),
level 35, d = 64, g = 8: 7 baby rotations sharing one hoisted ModUp, 7
giant rotations, 14 key switches and 64 plaintext products, seed 7.
--smoke takes the JAX script's smoke parameters (N = 256, maxLevel 8,
level 6, alpha 4, d = 16, g = 4, scale 2^26); --device cpu the plain
path; --fused-hpip the fused HPIP key switch (api.USE_FUSED_HPIP).

The host engine runs the native core (`native.py`, built at first use):
the host seconds of the keys and of the rest of the set-up (the diagonal
encodes, the tables) are printed. The result is decrypted and checked
within 1e-2 of M @ x in the first d slots before any timing. Then, on
cuda and without --smoke: the eager latency (CUDA events around one
call, median of 20 after 3 warm-ups; benchlib.latency_ms) and the device
time (CUDA-graph replay; benchlib.device_ms), with the card's name and
power limit, one JSON line appended to
outLogs/workloads/matvec_bsgs_torch.jsonl (the JAX record's fields, its
e2e_ms the eager latency and its scan_width None: the port runs no scan)
and printed. Imports no JAX and nothing of the JAX package.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the JAX script's smoke parameters")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--fused-hpip", action="store_true",
                    help="the fused HPIP key-switch route")
    args = ap.parse_args()

    from homulator_tpu_torch import api, benchlib, kernels, native, workloads
    from homulator_tpu_torch.context import Ciphertext
    from homulator_tpu_torch.params import get_params

    if args.smoke:
        n, max_level, level, alpha = 256, 8, 6, 4
        d, g = 16, 4
        scale = 2.0**26
    else:
        n, max_level, level, alpha = 65536, 45, 35, 15
        d, g = 64, 8
        scale = 2.0**29
    api.USE_FUSED_HPIP = args.fused_hpip
    cuda = args.device == "cuda"
    compile_s = kernels.build() if cuda else 0.0
    t0 = time.perf_counter()
    native.load()
    print(f"# native core: {time.perf_counter() - t0:.2f} s "
          f"({os.path.relpath(native.library_path(), ROOT)})")
    params = get_params(n=n, max_level=max_level, alpha=alpha)
    eng = workloads.native_engine(params, seed=7, device=args.device)
    slots = n // 2

    rng = np.random.default_rng(7)
    M = rng.normal(size=(d, d)) / d
    x = rng.normal(size=d)
    t0 = time.perf_counter()
    eng.keygen()
    baby_steps, giant_steps = workloads.matvec_steps(d, g)
    for s in baby_steps + giant_steps:
        eng.gen_rotation_key(s)
    keygen_s = time.perf_counter() - t0
    ct_x = eng.encrypt_complex(np.tile(x, slots // d), level, scale)
    t0 = time.perf_counter()
    prep = workloads.matvec_prep(eng, M, level, scale, g)
    prep_s = time.perf_counter() - t0
    print(f"# host set-up (native core): keys {keygen_s:.2f} s "
          f"(relin + {len(baby_steps + giant_steps)} rotations), prep "
          f"{prep_s:.2f} s ({d} diagonal encodes, tables)")

    def fn():
        return workloads.matvec_bsgs(ct_x.data, prep)

    out = fn()
    y = eng.decrypt_complex(Ciphertext(out, level, prep.out_scale)).real[:d]
    err = float(np.max(np.abs(y - M @ x)))
    print(f"# verify max-abs-err = {err:.3e}", flush=True)
    if not err < 1e-2:
        raise AssertionError(f"decrypt gate 1e-2 failed: {err}")
    if args.smoke or not cuda:
        print("# smoke OK (verify passed; no artifact written)")
        return 0

    eager_ms = benchlib.latency_ms(fn)
    device_ms = benchlib.device_ms(fn, calls=2)
    rec = {
        "workload": "matvec_bsgs", "n": n, "max_level": max_level,
        "level": level, "alpha": alpha, "d": d, "g": g, "scan_width": None,
        "e2e_ms": eager_ms, "eager_ms": eager_ms, "device_ms": device_ms,
        "keyswitches": prep.keyswitches, "hoisted_modups": 1, "pmults": d,
        "verify_err": err, "compile_s": compile_s,
        "host_keygen_s": keygen_s, "host_prep_s": prep_s, "native": True,
        "route": "fused" if args.fused_hpip else "pieces",
        "backend": "cuda", "card": benchlib.card_line(),
    }
    path = os.path.join(ROOT, "outLogs", "workloads",
                        "matvec_bsgs_torch.jsonl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
