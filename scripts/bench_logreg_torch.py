#!/usr/bin/env python3
"""End-to-end encrypted logistic-regression inference of the port.

    python3 scripts/bench_logreg_torch.py [--smoke] [--device cuda|cpu]
                                          [--fused-hpip]

The counterpart of scripts/bench_logreg.py: sigmoid(<x, w> + b) under
encryption (homulator_tpu_torch/workloads.py) at parameter set B (N =
2^16, 45 main + 15 special primes, alpha 15), level 35, scale 2^29,
seed 11. The score is a plaintext product and a rotate-and-add reduction
over the 32768 slots (15 rotations) before the one rescale, + b; the
sigmoid the degree-3 polynomial 0.5 + 0.197 t - 0.004 t^3 through
hsquare, hmult and two constant products across three levels of descent
(35 -> 34 -> 33 -> 32): 17 key switches. --smoke takes the JAX script's
smoke parameters (N = 256, maxLevel 10, alpha 5, level 8, scale 2^29);
--device cpu the plain path; --fused-hpip the fused HPIP key switch
(api.USE_FUSED_HPIP).

The host engine runs the native core (`native.py`, built at first use):
the host seconds of the keys and of the rest of the set-up (the weights'
and constants' encodes, the tables) are printed. Slot 0 of the result is
decrypted and checked within 1e-2 of the clear polynomial before any
timing. Then, on cuda and without --smoke: the eager latency (CUDA
events around one call, median of 20 after 3 warm-ups;
benchlib.latency_ms) and the device time (CUDA-graph replay;
benchlib.device_ms), with the card's name and power limit, one JSON line
appended to outLogs/workloads/logreg_torch.jsonl (the JAX record's
fields, its e2e_ms the eager latency) and printed. Imports no JAX and
nothing of the JAX package.
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
        n, max_level, alpha = 256, 10, 5
        # the scale tracks the prime size (2^29): the two sigmoid
        # branches' scales agree only when s^2 / q ~ q
        level, scale = 8, 2.0**29
    else:
        n, max_level, alpha = 65536, 45, 15
        level, scale = 35, 2.0**29
    api.USE_FUSED_HPIP = args.fused_hpip
    cuda = args.device == "cuda"
    compile_s = kernels.build() if cuda else 0.0
    t0 = time.perf_counter()
    native.load()
    print(f"# native core: {time.perf_counter() - t0:.2f} s "
          f"({os.path.relpath(native.library_path(), ROOT)})")
    params = get_params(n=n, max_level=max_level, alpha=alpha)
    eng = workloads.native_engine(params, seed=11, device=args.device)
    slots = n // 2

    rng = np.random.default_rng(11)
    x = rng.normal(size=slots)
    w = rng.normal(size=slots) / np.sqrt(slots)
    b = 0.3
    t0 = time.perf_counter()
    eng.keygen()
    steps = workloads.logreg_steps(slots)
    for s in steps:
        eng.gen_rotation_key(s)
    keygen_s = time.perf_counter() - t0
    ct_x = eng.encrypt_complex(x, level, scale)
    t0 = time.perf_counter()
    prep = workloads.logreg_prep(eng, w, b, level, scale)
    prep_s = time.perf_counter() - t0
    print(f"# host set-up (native core): keys {keygen_s:.2f} s "
          f"(relin + {len(steps)} rotations), prep {prep_s:.2f} s "
          "(weights, bias and constants encoded, tables)")

    def fn():
        return workloads.logreg_sigmoid3(ct_x.data, prep)

    out = fn()
    y = eng.decrypt_complex(Ciphertext(out, prep.out_level,
                                       prep.s_out))[0].real
    score = float(np.dot(x, w) + b)
    c0, c1, c3 = workloads.SIGMOID3
    expected = c0 + c1 * score + c3 * score**3
    err = abs(y - expected)
    print(f"# score={score:.5f} got={y:.5f} poly={expected:.5f} "
          f"err={err:.2e}", flush=True)
    if not err < 1e-2:
        raise AssertionError(f"decrypt gate 1e-2 failed: {err}")
    if args.smoke or not cuda:
        print("# smoke OK (verify passed; no artifact written)")
        return 0

    eager_ms = benchlib.latency_ms(fn)
    device_ms = benchlib.device_ms(fn, calls=2)
    rec = {
        "workload": "logreg_sigmoid3", "n": n, "max_level": max_level,
        "level": level, "alpha": alpha, "slots": slots,
        "e2e_ms": eager_ms, "eager_ms": eager_ms, "device_ms": device_ms,
        "keyswitches": prep.keyswitches, "verify_err": err,
        "compile_s": compile_s, "host_keygen_s": keygen_s,
        "host_prep_s": prep_s, "native": True,
        "route": "fused" if args.fused_hpip else "pieces",
        "backend": "cuda", "card": benchlib.card_line(),
    }
    path = os.path.join(ROOT, "outLogs", "workloads", "logreg_torch.jsonl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
