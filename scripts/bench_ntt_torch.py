#!/usr/bin/env python3
"""Device time of kernels B1 (ntt_fwd) and B2 (ntt_inv) at the shapes a
set-B key switch gives them, for one checkout of the port.

    python3 scripts/bench_ntt_torch.py [--root DIR] [--out FILE]

Takes the shapes from this checkout's chip_smoke.py (`ntt_cases`) and
times the `homulator_tpu_torch` of DIR (default: this checkout; another
one, such as an earlier commit unpacked with `git archive`, builds its own
kernels under its own build/): at each shape the kernel against its plain
version bit for bit, then the device time of one call (CUDA-graph replay,
the median of 20 replays of 10 calls; benchlib.device_ms). It prints no
bound: two checkouts' kernels may do different work, and chip_smoke.py
prints the bound of its own. Prints the card's name and power limit and one
JSON line, also written to FILE. To compare two commits, run both in one
call on one card, in turns: parent, change, change, parent. Imports no JAX
and nothing of the JAX package.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose homulator_tpu_torch is timed")
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_ntt_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke  # the shape table, read before DIR's package loads

    root = os.path.abspath(args.root)
    if root != ROOT:
        for mod in [m for m in sys.modules
                    if m.split(".")[0] == "homulator_tpu_torch"]:
            del sys.modules[mod]
        sys.path.insert(0, root)
    from homulator_tpu_torch import benchlib
    from homulator_tpu_torch.api import get_params
    from homulator_tpu_torch.context import DeviceContext
    from homulator_tpu_torch.ops import ntt_kernels
    from homulator_tpu_torch.ops.ntt import intt_plain, ntt_plain

    if not benchlib.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {benchlib.__file__}, not from {root}")
    card = benchlib.card_line()
    print(card)
    dc = DeviceContext(get_params(**chip_smoke.SET_B), "cuda")
    n1, n2 = dc.params.ntt.n1, dc.params.ntt.n2
    kernels = {"ntt_fwd": (ntt_kernels.ntt_fwd, ntt_plain, (n1, n2)),
               "ntt_inv": (ntt_kernels.ntt_inv, intt_plain, (n2, n1))}
    cases = chip_smoke.ntt_cases(dc.keyswitch_tables(chip_smoke.LEVEL_B))
    out = {"card": card, "root": root, "kernels": {}}
    for name, shapes in cases.items():
        kernel, plain, shape = kernels[name]
        rows = out["kernels"][name] = {}
        for label, (nb, rep) in shapes.items():
            rm = rep * nb.q.shape[0]
            x = benchlib.residues(torch.tile(nb.q, (rep,)), (rm,) + shape, rm)
            if not torch.equal(kernel(x, nb, rep), plain(x, nb, rep)):
                raise AssertionError(f"{name} {label}: != its plain version")
            rows[label] = benchlib.device_ms(lambda: kernel(x, nb, rep))
            print(f"# {name} {label}: {rows[label]:.4f} ms")
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
