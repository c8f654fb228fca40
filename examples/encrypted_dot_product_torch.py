#!/usr/bin/env python3
"""Example: encrypted dot product <x, w> with rotation-based slot summation,
on the PyTorch + CUDA port (`homulator_tpu_torch`).

The same program as examples/encrypted_dot_product.py: keygen, slot
encoding, pmult, rescale, the rotate-and-add sum over log2(slots)
rotations (`linalg.sum_slots`), decrypt, and the same clear assert.
Imports no JAX and nothing of the JAX package.

    python3 examples/encrypted_dot_product_torch.py [--device cuda|cpu]
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

    params = get_params(n=256, max_level=8, alpha=4)
    eng = CkksEngine(params, device=args.device)
    eng.keygen()

    slots = params.n // 2
    scale = 2.0**29
    rng = np.random.default_rng(0)
    x = rng.normal(size=slots)
    w = rng.normal(size=slots)

    ct = eng.encrypt_complex(x, level=8, scale=scale)
    pt_w = eng.plaintext_complex(w, level=8, scale=scale)

    # slotwise product, then rotate-and-add log2(slots) times to sum.
    prod = eng.rescale(eng.pmult(ct, pt_w))
    acc = linalg.sum_slots(eng, prod)

    got = eng.decrypt_complex(acc)[0].real
    expected = float(np.dot(x, w))
    print(f"encrypted <x, w> = {got:.6f}   plaintext = {expected:.6f}   "
          f"err = {abs(got - expected):.2e}")
    print()
    eng.stats.show()
    assert abs(got - expected) < 1e-2


if __name__ == "__main__":
    main()
