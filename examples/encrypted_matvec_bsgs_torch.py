#!/usr/bin/env python3
"""Example: encrypted matrix-vector product y = M @ x, diagonal method
with baby-step/giant-step (BSGS) rotation structure, on the PyTorch + CUDA
port (`homulator_tpu_torch`).

The same program as examples/encrypted_matvec_bsgs.py, whose computation
the port's `linalg.bsgs_matvec` holds: M is a public d x d matrix, x
arrives encrypted in the slots, packed d-periodically
(`linalg.encrypt_vector`), and

    y = sum_j rot( sum_i pdiag_{g*j+i} * rot(x, i), g*j )

with the inner-group diagonals pre-rotated by -g*j in the clear; the g-1
baby rotations share one ModUp (`CkksEngine.hrotate_hoisted`), so d = 16
costs 3 hoisted + 3 giant key switches instead of 15 plain rotations. No
rescale at the end, as there; the same clear assert. Imports no JAX and
nothing of the JAX package.

    python3 examples/encrypted_matvec_bsgs_torch.py [--device cuda|cpu]
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

    d = 16                 # matrix dim; d | slots so diagonals wrap cleanly
    g = 4                  # giant step = sqrt(d)
    level, scale = 6, 2.0**26

    rng = np.random.default_rng(3)
    M = rng.normal(size=(d, d)) / d
    x = rng.normal(size=d)

    ct_x = linalg.encrypt_vector(eng, x, level, scale)
    acc = linalg.bsgs_matvec(eng, ct_x, M, g=g, rescale_out=False)

    y = eng.decrypt_complex(acc).real[:d]
    y_ref = M @ x
    err = np.max(np.abs(y - y_ref))
    print("y (encrypted) :", np.round(y, 4))
    print("y (reference) :", np.round(y_ref, 4))
    print(f"max abs error : {err:.3e}")
    assert err < 1e-2, err
    print("OK")


if __name__ == "__main__":
    main()
