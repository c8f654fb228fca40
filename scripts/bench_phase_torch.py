#!/usr/bin/env python3
"""Device time of the phase kernels of the coefficient-sharded NTT, B6
(ntt_phase1), B7 (ntt_phase2), B8 (intt_phase2), B9 (intt_phase1) and
their lane-packed forms B10-B13 (ntt_phase1_packed, ntt_phase2_packed,
intt_phase2_packed, intt_phase1_packed), at the shapes chip_smoke.py
checks them at, for one checkout of the port.

    python3 scripts/bench_phase_torch.py [--root DIR] [--tile-cols 4 8 16]
                                         [--kernels NAME ...] [--out FILE]

Takes the shapes from this checkout's chip_smoke.py (`phase_cases`: B6-B9
on column slices at 2-32 shards, B10-B13 on lane groups at 8-32 shards,
set B, level 35) and times the `homulator_tpu_torch` of DIR
(default: this checkout; another one, such as an earlier commit unpacked
with `git archive`, builds its own kernels under its own build/): at each
shape the kernel against its plain version bit for bit, then the device
time of one call (CUDA-graph replay, the median of 20 replays of 10 calls;
benchlib.device_ms), beside the bound this checkout's chip_smoke counts
(`phase_bound`) and the kernel's share of it. With --tile-cols, each width
in turn is made the only entry of DIR's `ntt_kernels.PHASE_TILE_COLS`, so
that `phase_tile_cols` takes it wherever it fits in one limb's c columns (a
sweep of the tile width of all eight, which run on the register passes; a
checkout that names the constant otherwise, or runs a kernel on column
tiles, as B8 and B9 did before they moved, runs its own widths, timed
again at each). --kernels times only the kernels named (default: all
eight). Prints the card's name and power limit and
one JSON line, also written to FILE. To compare two commits, run both in
one call on one card, in turns: parent, change, change, parent. Imports no
JAX and nothing of the JAX package.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("ntt_phase1", "ntt_phase2", "intt_phase2", "intt_phase1",
           "ntt_phase1_packed", "ntt_phase2_packed", "intt_phase2_packed",
           "intt_phase1_packed")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose homulator_tpu_torch is timed")
    ap.add_argument("--tile-cols", type=int, nargs="+",
                    help="sweep the kernels' tile width over these")
    ap.add_argument("--kernels", nargs="+", choices=KERNELS, default=KERNELS,
                    help="time only these kernels")
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_phase_torch: no CUDA device", file=sys.stderr)
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
    from homulator_tpu_torch.ops import ntt as ntt_mod
    from homulator_tpu_torch.ops import ntt_kernels

    if not benchlib.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {benchlib.__file__}, not from {root}")
    card = benchlib.card_line()
    print(card)
    dc = DeviceContext(get_params(**chip_smoke.SET_B), "cuda")
    cases = chip_smoke.phase_cases(dc)
    widths = {"default": getattr(ntt_kernels, "PHASE_TILE_COLS", None)}
    for tc in args.tile_cols or ():
        widths[f"TC={tc}"] = (tc,)
    out = {"card": card, "root": root, "kernels": {}}
    rng = np.random.default_rng(3)
    for name in args.kernels:
        kernel = getattr(ntt_kernels, name)
        plain = getattr(ntt_mod, name + "_plain")
        rows = out["kernels"][name] = {}
        for label, (nb, rep, worst) in cases[name].items():
            if worst:
                continue
            x = chip_smoke.phase_input(np, torch, name, nb, rep, False, rng)
            k = nb.pack or 1
            bound_ms = chip_smoke.phase_bound(
                nb, x.shape[0] * k, x.shape[1], x.shape[2] // k, name)[0]
            want = plain(x, nb, rep)
            for tag, tile_cols in widths.items():
                ntt_kernels.PHASE_TILE_COLS = tile_cols
                try:
                    if not torch.equal(kernel(x, nb, rep), want):
                        raise AssertionError(f"{name} {label} {tag}: != its "
                                             "plain version")
                    ms = benchlib.device_ms(lambda: kernel(x, nb, rep))
                finally:
                    ntt_kernels.PHASE_TILE_COLS = widths["default"]
                key = label if tag == "default" else f"{label} {tag}"
                rows[key] = {"ms": ms, "bound_ms": bound_ms,
                             "share": bound_ms / ms}
                print(f"# {name} {key}: {ms:.4f} ms, {bound_ms / ms:.1%} of "
                      f"the bound {bound_ms:.4f} ms")
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "homulator_tpu"))
    if bad:
        raise AssertionError(f"imported {bad}")
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
