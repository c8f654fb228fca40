#!/usr/bin/env python3
"""NTT anatomy on the card: the components of the 4-step NTT timed apart.

    python3 scripts/bench_ntt_variants_torch.py [--root DIR]

The port's counterpart of scripts/bench_ntt_variants.py. At parameter set
B (N = 2^16, n1 = n2 = 256) on M = 35 limbs of random residues, kernel B16
(csrc/anatomy.cu, ops/anatomy.py::ntt_components) runs each component of
the transform's first phase alone: copy, transpose, mid (the Shoup product
by the mid table) and stages1 (the 8 stage-1 CT stages along n1). Each is
reported in microseconds per limb, from its device time (CUDA-graph
replay), beside full_pair_half_us: one iNTT and one NTT (B2 and B1,
benchlib.ntt_pair_ms) over 2 * 35 limb transforms. Prints the card's
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose homulator_tpu_torch is timed")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_ntt_variants_torch: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from homulator_tpu_torch import benchlib
    from homulator_tpu_torch.api import CkksEngine, get_params
    from homulator_tpu_torch.ops.anatomy import B16_PARTS, ntt_components

    if not benchlib.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {benchlib.__file__}, not from {root}")
    print(benchlib.card_line())
    eng = CkksEngine(get_params(n=1 << 16, max_level=45, alpha=15), seed=1,
                     device="cuda")
    nb = eng.dc.ntt_basis(eng.dc.main_rows(M))
    x = benchlib.residues(nb.q, (M, nb.n1, nb.n2))
    out = {"root": root}
    for part in B16_PARTS:
        ms = benchlib.device_ms(lambda: ntt_components(x, nb, part))
        out[f"{part}_ms"] = ms
        out[f"{part}_us_per_limb"] = 1e3 * ms / M
        print(f"{part:12s} {ms:.4f} ms, {out[f'{part}_us_per_limb']:8.3f} "
              "us/limb")
    # x is a valid [M, n2, n1] eval tile too (n1 == n2)
    out["full_pair_half_us"] = 1e3 * benchlib.ntt_pair_ms(eng, x, M) / (2 * M)
    print(f"{'full(pair/2)':12s} {out['full_pair_half_us']:8.3f} us/limb")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
