#!/usr/bin/env python3
"""Width study of the coefficient-sharded compute units: the phase-split
NTT kernels and the base conversion against a shard's column width c.

    python3 scripts/bench_ntt_width_torch.py [--out WIDTH_SCALING_H100.json]

The counterpart of scripts/bench_ntt_width.py at set B (N = 2^16, 256 x
256 tiles), 35 rows (level 35's main primes), on rank 0's sharded basis
at ns = 1, 2, 4, 8 shards (c = 256, 128, 64, 32 columns): µs per row of
B6 (`ntt_phase1`, [35, n1, c]) and B7 (`ntt_phase2`, [35, n2, n1/ns]),
and µs per call of B3 on ModUp digit 0 (15+1 rows -> 35, on [15, n1, c]);
then the lane-packed B10 and B11 at ns = 4 (k = 2 limbs a 128-lane
group, a packing no dispatch takes: `pack_k_for` gives 0 there) and ns =
8 (k = 4) on Mp = 32 limbs, the basis packed as the context packs it
(dataclasses.replace(..., pack=k)); and each width's time over the full
width's (`*_vs_full`). Every shape is checked bit for bit against its
plain version before it is timed (device time, CUDA-graph replay,
benchlib.device_ms). Writes one JSON object with the card's name and
power limit to --out. Needs the card; imports no JAX and nothing of the
JAX package.
"""

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LEVEL = 35
NSS = (1, 2, 4, 8)
PACKED = ((4, 2), (8, 4))  # (ns, k)
MP = 32  # limbs of the packed study: a multiple of every k


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT,
                                                  "WIDTH_SCALING_H100.json"))
    args = ap.parse_args()

    import torch

    from homulator_tpu_torch import benchlib, kernels
    from homulator_tpu_torch.context import DeviceContext
    from homulator_tpu_torch.ops import ntt as ntt_mod
    from homulator_tpu_torch.ops.bconv_fused import bconv_fused, bconv_plain
    from homulator_tpu_torch.params import get_params

    if not torch.cuda.is_available():
        raise SystemExit("bench_ntt_width_torch: needs a CUDA card")
    kernels.build()
    kernels.load()
    card = benchlib.card_line()
    print(card, flush=True)
    dc = DeviceContext(get_params(n=1 << 16, max_level=45, alpha=15),
                       device="cuda")
    n1, n2 = dc.params.ntt.n1, dc.params.ntt.n2
    rows = dc.main_rows(LEVEL)
    dt = dc.keyswitch_tables(LEVEL).digits[0]
    nd = dt.hi - dt.lo

    def timed(name, kernel, plain):
        """Device ms of kernel() after a bit-exact check against plain()."""
        if not torch.equal(kernel(), plain()):
            raise AssertionError(f"{name}: kernel != plain version")
        return benchlib.device_ms(kernel)

    results = []
    for ns in NSS:
        c, cw = n2 // ns, n1 // ns
        nb = dc.ntt_basis(rows, (0, ns))
        x1 = benchlib.residues(nb.q, (LEVEL, n1, c), rng=ns)
        x2 = benchlib.residues(nb.q, (LEVEL, n2, cw), rng=ns + 10)
        xb = benchlib.residues(dt.in_q, (nd, n1, c), rng=ns + 20)
        tag = f"ns={ns} c={c}"
        t_p1 = timed(f"B6 {tag}", lambda: ntt_mod.ntt_phase1(x1, nb, 1),
                     lambda: ntt_mod.ntt_phase1_plain(x1, nb, 1))
        t_p2 = timed(f"B7 {tag}", lambda: ntt_mod.ntt_phase2(x2, nb, 1),
                     lambda: ntt_mod.ntt_phase2_plain(x2, nb, 1))
        tabs = (dt.step1, dt.step1_sh, dt.in_q)
        t_bc = timed(f"B3 {tag}", lambda: bconv_fused(
            xb, *tabs, dt.mat, dt.mat_mma, dt.horner_sh, dt.other_nt.q,
            center=True), lambda: bconv_plain(xb, *tabs, dt.mat,
                                              dt.other_nt.q, True))
        r = {"ns": ns, "c": c,
             "phase1_us_per_row": round(1e3 * t_p1 / LEVEL, 3),
             "phase2_us_per_row": round(1e3 * t_p2 / LEVEL, 3),
             "bconv_digit_us": round(1e3 * t_bc, 2)}
        results.append(r)
        print(r, flush=True)
    for ns, k in PACKED:
        c, cw = n2 // ns, n1 // ns
        nb = dataclasses.replace(dc.ntt_basis(rows[:MP], (0, ns)), pack=k)
        xp1 = ntt_mod._pack_pad(benchlib.residues(nb.q, (MP, n1, c), rng=k),
                                k)
        xp2 = ntt_mod._pack_pad(benchlib.residues(nb.q, (MP, n2, cw),
                                                  rng=k + 10), k)
        tag = f"ns={ns} c={c} k={k}"
        t1 = timed(f"B10 {tag}",
                   lambda: ntt_mod.ntt_phase1_packed(xp1, nb, 1),
                   lambda: ntt_mod.ntt_phase1_packed_plain(xp1, nb, 1))
        t2 = timed(f"B11 {tag}",
                   lambda: ntt_mod.ntt_phase2_packed(xp2, nb, 1),
                   lambda: ntt_mod.ntt_phase2_packed_plain(xp2, nb, 1))
        r = {"ns": ns, "c": c, "packed_k": k,
             "packed_phase1_us_per_row": round(1e3 * t1 / MP, 3),
             "packed_phase2_us_per_row": round(1e3 * t2 / MP, 3)}
        results.append(r)
        print(r, flush=True)
    f0 = results[0]
    for r in results:
        if "phase1_us_per_row" in r:
            for k in ("phase1", "phase2"):
                r[f"{k}_vs_full"] = round(r[f"{k}_us_per_row"]
                                          / f0[f"{k}_us_per_row"], 3)
            r["bconv_vs_full"] = round(r["bconv_digit_us"]
                                       / f0["bconv_digit_us"], 3)
    out = {"card": card, "rows": LEVEL, "n1": n1, "n2": n2,
           "timing": "device time, CUDA-graph replay; each shape bit-exact "
                     "against its plain version first",
           "results": results}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"# wrote {os.path.relpath(args.out, ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
