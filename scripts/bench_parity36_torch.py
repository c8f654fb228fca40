#!/usr/bin/env python3
"""Bit-width parity on the port: hmult at the reference's modelled
modulus magnitude, on the card.

    python3 scripts/bench_parity36_torch.py [--out PARITY36_H100.json]

The counterpart of scripts/bench_parity36.py. The reference models
36-bit words (config_4.cfg:9), so its set-B workload hmult 45 35 15
carries a 36*45-bit main, a 36*35-bit live and a 36*15-bit special
modulus; this framework's primes are below 2^30 (numtheory.PRIME_CAP),
so magnitude parity needs more, smaller primes. parity36_shape counts
them from the generated primes (its own copy, over the port's
numtheory): (56, 19, 43) at N = 2^16, as PARITY36.json has it, but
recomputed here. run_one runs hmult at (45, 35, 15) and at that shape:
host seconds of the tables, the keys and two encryptions (native core),
the decrypt gate (coefficient 0 of 7 * 7 within 0.01 of 49, the JAX
script's), and the device time (CUDA-graph replay) and eager latency
of hmult. One JSON object with the card's name and power limit, printed
and written to --out. Needs the card for run_one; imports no JAX and
nothing of the JAX package.
"""

import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402


def parity36_shape(n: int, max_level: int, alpha: int, level: int):
    """(L, alpha, level, mean prime bits): the limb counts whose modulus
    bits match the reference's modelled 36-bit words, from the generated
    prime magnitudes (scripts/bench_parity36.py's function, on the port's
    numtheory)."""
    from homulator_tpu_torch import numtheory as nt

    pool = nt.gen_ntt_primes(n, 2 * (max_level + alpha))
    bits = np.array([math.log2(p) for p in pool])

    def count_for(target):
        return int(np.searchsorted(np.cumsum(bits), target) + 1)

    L36 = count_for(36 * max_level)
    a36 = count_for(36 * alpha)
    l36 = count_for(36 * level)
    return L36, a36, l36, float(bits[: L36 + a36].mean())


def run_one(n, max_level, level, alpha, tag, out):
    """hmult(max_level, level, alpha) at ring degree n on the card: its
    host set-up seconds, decrypt gate and times under `tag` in out."""
    import torch

    from homulator_tpu_torch import benchlib
    from homulator_tpu_torch.params import get_params
    from homulator_tpu_torch.workloads import native_engine

    t0 = time.perf_counter()
    params = get_params(n=n, max_level=max_level, alpha=alpha)
    eng = native_engine(params, seed=1)
    out[f"{tag}_tables_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.keygen()
    out[f"{tag}_keygen_s"] = time.perf_counter() - t0
    scale = 2.0**29
    m = np.zeros(params.n, dtype=np.int64)
    m[0] = int(7 * scale)
    t0 = time.perf_counter()
    ct1 = eng.encrypt_ints(m, level, scale)
    ct2 = eng.encrypt_ints(m, level, scale)
    out[f"{tag}_encrypt2_s"] = time.perf_counter() - t0
    res = eng.hmult(ct1, ct2)
    torch.cuda.synchronize()
    dec = eng.decrypt_bigint(res, count=1)
    out[f"{tag}_correct"] = bool(abs(dec[0] / res.scale - 49.0) < 0.01)
    out[f"{tag}_hmult_ms"] = benchlib.hmult_ms(eng, ct1, ct2)
    out[f"{tag}_hmult_eager_ms"] = benchlib.hmult_ms(eng, ct1, ct2,
                                                     eager=True)
    out[f"{tag}_shape"] = (f"L={max_level} l={level} alpha={alpha} "
                           f"dnum={params.beta(max_level)}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "PARITY36_H100.json"))
    args = ap.parse_args()

    import torch

    from homulator_tpu_torch import benchlib, kernels

    if not torch.cuda.is_available():
        raise SystemExit("bench_parity36_torch: needs a CUDA card")
    kernels.build()
    n = 65536
    out = {"backend": "cuda", "card": benchlib.card_line()}
    L36, a36, l36, eff = parity36_shape(n, 45, 15, 35)
    out["eff_prime_bits"] = eff
    out["parity_shape"] = {"L": L36, "alpha": a36, "level": l36}
    run_one(n, 45, 35, 15, "native30", out)
    run_one(n, L36, l36, a36, "parity36", out)
    print(json.dumps(out))
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0 if out["native30_correct"] and out["parity36_correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
