#!/usr/bin/env python3
"""Device time of kernel B4 (hpip_kernel) at set B's levels 35 and 20, and
of B16's copy beside torch's copy_ on the same 35 limbs, for one checkout
of the port.

    python3 scripts/bench_hpip_torch.py [--root DIR] [--out FILE]

Times the `homulator_tpu_torch` of DIR (default: this checkout; another
one, such as an earlier commit unpacked with `git archive`, builds its own
kernels under its own build/): B4 on random ModUp pieces, own rows and a
random Montgomery-form key at level 35 (K = 50, digits (0,15) (15,30)
(30,35)) and level 20 (K = 35, digits (0,15) (15,20)), B16's copy
(`ntt_components(x, nb, "copy")`) and `copy_` on the M = 35 main limbs
[256, 256]; each kernel against its plain version bit for bit, then the
device time of one call (CUDA-graph replay, the median of 20 replays of
10 calls; benchlib.device_ms), for the copy and copy_ the median of five
such times taken in turns. It prints no bound: two checkouts' kernels
may do different work, and chip_smoke.py prints the bound of its own.
Prints the card's name and power limit and one JSON line, also written to
FILE. To compare two commits, run both in one call on one card, in turns:
parent, change, change, parent. Imports no JAX and nothing of the JAX
package.
"""

import argparse
import json
import os
import statistics
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SET_B = dict(n=1 << 16, max_level=45, alpha=15)
LEVELS = (35, 20)
M = 35  # B16's limbs, as scripts/bench_ntt_variants_torch.py
COPY_TURNS = 5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose homulator_tpu_torch is timed")
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_hpip_torch: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from homulator_tpu_torch import benchlib
    from homulator_tpu_torch.api import get_params
    from homulator_tpu_torch.context import DeviceContext
    from homulator_tpu_torch.ops.anatomy import (
        ntt_components, ntt_components_plain,
    )
    from homulator_tpu_torch.ops.hpip import hpip_kernel, hpip_plain

    if not benchlib.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {benchlib.__file__}, not from {root}")
    card = benchlib.card_line()
    print(card)
    p = get_params(**SET_B)
    dc = DeviceContext(p, "cuda")
    n1, n2 = p.ntt.n1, p.ntt.n2
    rng = np.random.default_rng(0)
    key_q = np.concatenate([p.q_arr[p.max_level:], p.q_arr[:p.max_level]])
    key = benchlib.residues(np.tile(key_q, 2 * p.dnum),
                            (2 * p.dnum * p.num_primes, n2, n1), rng).view(
                                p.dnum, 2, p.num_primes, n2, n1)
    out = {"card": card, "root": root, "hpip": {}, "copy": {}}
    for level in LEVELS:
        kt = dc.keyswitch_tables(level)
        convs = [benchlib.residues(dt.other_nt.q,
                                   (dt.other_nt.q.shape[0], n1, n2), rng)
                 for dt in kt.digits]
        d_eval = benchlib.residues(kt.main_nt.q, (level, n2, n1), rng)
        if not torch.equal(hpip_kernel(convs, d_eval, key, kt),
                           hpip_plain(convs, d_eval, key, kt)):
            raise AssertionError(f"hpip level {level}: != its plain version")
        spans = " ".join(f"({dt.lo},{dt.hi})" for dt in kt.digits)
        label = f"level {level} K={kt.ext_nt.q.shape[0]} digits {spans}"
        out["hpip"][label] = benchlib.device_ms(
            lambda: hpip_kernel(convs, d_eval, key, kt))
        print(f"# hpip {label}: {out['hpip'][label]:.4f} ms")
    nb = dc.keyswitch_tables(35).main_nt
    x = benchlib.residues(nb.q, (M, n1, n2), rng)
    if not torch.equal(ntt_components(x, nb, "copy"),
                       ntt_components_plain(x, nb, "copy")):
        raise AssertionError("B16 copy: != its plain version")
    y = torch.empty_like(x)
    runs = {f"B16 copy M={M}": lambda: ntt_components(x, nb, "copy"),
            f"copy_ M={M}": lambda: y.copy_(x)}
    times = {k: [] for k in runs}
    for _ in range(COPY_TURNS):  # in turns: the two differ by a few %
        for k, fn in runs.items():
            times[k].append(benchlib.device_ms(fn))
    out["copy"] = {k: statistics.median(t) for k, t in times.items()}
    for k, v in out["copy"].items():
        print(f"# {k}: {v:.5f} ms (median of {COPY_TURNS} turns: "
              + ", ".join(f"{t:.5f}" for t in times[k]) + ")")
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
