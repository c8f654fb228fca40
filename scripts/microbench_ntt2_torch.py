#!/usr/bin/env python3
"""Three forms of the Shoup product inside the NTT stage loop, timed.

    python3 scripts/microbench_ntt2_torch.py

The port's counterpart of scripts/microbench_ntt2.py. Kernel B15
(csrc/anatomy.cu, ops/anatomy.py::ntt_shoup_forms) runs 16 CT stages
(stage 1 twice, reduced between) on M = 35 limbs of random residues at
parameter set B (n1 = n2 = 256), transposed at exit, with the butterflies'
Shoup product in each form: production (__umulhi), natmul (the exact high
word from 16-bit partial products, the TPU's form) and approx (the TPU's
3-product approximate high word). All three compute the same residues
(checked here). Prints the card's name and power limit, microseconds per
limb from each form's device time (CUDA-graph replay), then one JSON line.
Imports no JAX and nothing of the JAX package.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M = 35


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("microbench_ntt2_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from homulator_tpu_torch import benchlib
    from homulator_tpu_torch.context import DeviceContext
    from homulator_tpu_torch.ops.anatomy import B15_FORMS, ntt_shoup_forms
    from homulator_tpu_torch.params import get_params

    print(benchlib.card_line())
    dc = DeviceContext(get_params(n=1 << 16, max_level=45, alpha=15), "cuda")
    nb = dc.ntt_basis(dc.main_rows(M))
    x = benchlib.residues(nb.q, (M, nb.n1, nb.n2))
    want = ntt_shoup_forms(x, nb, "production")
    out = {}
    for form in B15_FORMS:
        if not torch.equal(ntt_shoup_forms(x, nb, form), want):
            raise AssertionError(f"form {form} != production")
        ms = benchlib.device_ms(lambda: ntt_shoup_forms(x, nb, form))
        out[f"{form}_us_per_limb"] = 1e3 * ms / M
        print(f"{form:10s} {out[f'{form}_us_per_limb']:8.3f} us/limb "
              "(16 stages)")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
