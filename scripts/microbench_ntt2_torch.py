#!/usr/bin/env python3
"""Three forms of the Shoup product inside the NTT stage loop, timed.

    python3 scripts/microbench_ntt2_torch.py [--root DIR]

The port's counterpart of scripts/microbench_ntt2.py. Kernel B15
(csrc/anatomy.cu, ops/anatomy.py::ntt_shoup_forms) runs 16 CT stages
(stage 1 twice) on M = 35 limbs of random residues at parameter set B
(n1 = n2 = 256), transposed at exit, with the butterflies' Shoup product
in each form: production (__umulhi), natmul (the exact high word from
16-bit partial products, the TPU's form) and approx (the TPU's 3-product
approximate high word). All three compute the same residues (checked
here, and against the plain version). Times the `homulator_tpu_torch` of
DIR (default: this checkout; another one, such as an earlier commit
unpacked with `git archive`, builds its own kernels under its own
build/). Prints the card's name and power limit, each form's device time
a call (CUDA-graph replay) and microseconds per limb, then one JSON line.
To compare two commits, run both in one call on one card, in turns:
parent, change, change, parent. Imports no JAX and nothing of the JAX
package.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M = 35


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose homulator_tpu_torch is timed")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("microbench_ntt2_torch: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from homulator_tpu_torch import benchlib
    from homulator_tpu_torch.context import DeviceContext
    from homulator_tpu_torch.ops.anatomy import (
        B15_FORMS, ntt_shoup_forms, ntt_shoup_forms_plain,
    )
    from homulator_tpu_torch.params import get_params

    if not benchlib.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {benchlib.__file__}, not from {root}")
    print(benchlib.card_line())
    dc = DeviceContext(get_params(n=1 << 16, max_level=45, alpha=15), "cuda")
    nb = dc.ntt_basis(dc.main_rows(M))
    x = benchlib.residues(nb.q, (M, nb.n1, nb.n2))
    want = ntt_shoup_forms_plain(x, nb, "production")
    out = {"root": root}
    for form in B15_FORMS:
        if not torch.equal(ntt_shoup_forms(x, nb, form), want):
            raise AssertionError(f"form {form} != the plain version")
        ms = benchlib.device_ms(lambda: ntt_shoup_forms(x, nb, form))
        out[f"{form}_ms"] = ms
        out[f"{form}_us_per_limb"] = 1e3 * ms / M
        print(f"{form:10s} {ms:.4f} ms, {out[f'{form}_us_per_limb']:8.3f} "
              "us/limb (16 stages)")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
