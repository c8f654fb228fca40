#!/usr/bin/env python3
"""Example: encrypted logistic-regression inference, end to end, on the
PyTorch + CUDA port (`homulator_tpu_torch`).

The same program as examples/encrypted_logreg.py: score = <x, w> + b
under encryption (slotwise pmult, rescale, the rotate-and-add sum of
`linalg.sum_slots`, cadd), then sigmoid approximated by the degree-3
CKKS polynomial

    sigmoid(t) ~ 0.5 + 0.197 t - 0.004 t^3      (|t| <~ 6)

evaluated with hsquare / hmult / cmult / cadd, align_levels reconciling
the two branches; the same clear assert. Imports no JAX and nothing of
the JAX package.

    python3 examples/encrypted_logreg_torch.py [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    from homulator_tpu_torch import linalg
    from homulator_tpu_torch.api import CkksEngine, get_params

    params = get_params(n=256, max_level=10, alpha=5)
    eng = CkksEngine(params, device=args.device)
    eng.keygen()

    slots = params.n // 2
    # The scale must track the prime size (2^scale_bits = 2^29): after a
    # rescale the working scale becomes s^2/q, and the two sigmoid
    # branches (t at one level, t^3 two rescales deeper) only carry
    # matching scales when s ~ q; align_levels aligns levels, not scales.
    level, scale = 8, 2.0**29
    rng = np.random.default_rng(7)
    # A small "model": weights scaled so |score| stays in the poly's range.
    x = rng.normal(size=slots)
    w = rng.normal(size=slots) / np.sqrt(slots)
    b = 0.3

    ct_x = eng.encrypt_complex(x, level, scale)
    pt_w = eng.plaintext_complex(w, level, scale)

    # ---- score = <x, w> + b (every slot ends up holding the full sum) --
    prod = eng.rescale(eng.pmult(ct_x, pt_w))
    t = eng.cadd(linalg.sum_slots(eng, prod), b)

    # ---- sigmoid(t) ~ 0.5 + 0.197 t - 0.004 t^3 ------------------------
    t2 = eng.hsquare(t)                      # level-1, scale^2 rescaled
    t3 = eng.hmult(eng.mod_drop(t, 1), t2)   # align t to t2's level first
    lin = eng.cmult(t, 0.197)                # 0.197 t
    cub = eng.cmult(t3, -0.004)              # -0.004 t^3
    lin, cub = eng.align_levels(lin, cub)
    y = eng.cadd(eng.hadd(lin, cub), 0.5)

    got = eng.decrypt_complex(y)[0].real
    score = float(np.dot(x, w) + b)
    expected = 0.5 + 0.197 * score - 0.004 * score**3
    true_sig = 1.0 / (1.0 + np.exp(-score))
    print(f"score (clear)          : {score:.6f}")
    print(f"encrypted sigmoid      : {got:.6f}")
    print(f"poly reference (clear) : {expected:.6f}")
    print(f"true sigmoid           : {true_sig:.6f}")
    err = abs(got - expected)
    print(f"encrypted-vs-poly err  : {err:.2e}")
    assert err < 1e-2, err
    print("OK")


if __name__ == "__main__":
    main()
