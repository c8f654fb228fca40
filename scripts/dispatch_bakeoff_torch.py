#!/usr/bin/env python3
"""Dispatch bake-off of the port: exact bytes a shard receives and
collective calls of the limb and coefficient dispatches, and the H100
model's pick, per (op, level, shard count).

    python3 scripts/dispatch_bakeoff_torch.py

The counterpart of scripts/dispatch_bakeoff.py, pure arithmetic over the
port's counters and model (no device): set B (N = 2^16, maxLevel 45,
alpha 15), levels 35, 22, 11, 2, 4 and 8 shards, hmult and hrotate. Bytes:
limb_sharded.ici_bytes_per_op_limb and sharded.ici_bytes_per_op (the JAX
package's figures, which the CPU tests hold the port's ThreadMesh and
StandInMesh counts to); calls: limb_collective_count and the JAX
schedule's coeff_collective_count. `chosen` is the projected-time model's
pick (parallel/dispatch_model.py: the card's per-shard anchors from
scripts/scaling_projection_torch.py, the H100 SXM5 fabric spec, not
measured), among limb, coeff and, from 4 shards, the (ns/2 x 2) hybrid,
as the CLI's --dispatch auto picks; without anchors the axis with fewer
bytes ("volume"). Writes DISPATCH_BAKEOFF_H100.json (DISPATCH_BAKEOFF.json
is the TPU model's) and prints a table. Imports no JAX and nothing of the
JAX package.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from homulator_tpu_torch.params import get_params  # noqa: E402
from homulator_tpu_torch.parallel import dispatch_model as dm  # noqa: E402
from homulator_tpu_torch.parallel.limb_sharded import (  # noqa: E402
    ici_bytes_per_op_limb, limb_collective_count,
)
from homulator_tpu_torch.parallel.sharded import ici_bytes_per_op  # noqa

SET_B = dict(n=1 << 16, max_level=45, alpha=15)
LEVELS = (35, 22, 11)
NSS = (2, 4, 8)


def bakeoff_rows(params):
    """One row a (op, level, ns): the JAX bake-off's columns."""
    rows = []
    for op in ("hmult", "hrotate"):
        for level in LEVELS:
            for ns in NSS:
                limb = ici_bytes_per_op_limb(params, level, ns, op)
                coeff = ici_bytes_per_op(params, level, ns, op)
                t_l = dm.predict_ms(params, op, "limb", ns, level)
                t_c = dm.predict_ms(params, op, "coeff", ns, level)
                t_h = (dm.predict_hybrid_ms(params, op, ns // 2, 2, level)
                       if ns >= 4 else None)
                if t_l is not None and t_c is not None:
                    cands = [("limb", t_l), ("coeff", t_c)]
                    if t_h is not None:
                        cands.append((f"hybrid{ns // 2}x2", t_h))
                    chosen = min(cands, key=lambda kv: kv[1])[0]
                else:
                    chosen = "limb" if limb <= coeff else "coeff"
                rows.append({
                    "op": op, "level": level, "ns": ns,
                    "ici_limb_mb": round(limb / 1e6, 3),
                    "ici_coeff_mb": round(coeff / 1e6, 3),
                    "coeff_over_limb": round(coeff / limb, 2),
                    "collectives_limb": limb_collective_count(
                        params, level, ns, op),
                    "collectives_coeff": dm.coeff_collective_count(
                        params, level, op),
                    "t_model_limb_ms": t_l and round(t_l, 4),
                    "t_model_coeff_ms": t_c and round(t_c, 4),
                    "t_model_hybrid_ms": t_h and round(t_h, 4),
                    "chosen": chosen,
                    "chosen_by": ("model" if t_l is not None
                                  and t_c is not None else "volume"),
                })
    return rows


def main() -> int:
    params = get_params(**SET_B)
    rows = bakeoff_rows(params)
    meta = (dm.MEASURED or {}).get("meta", {})
    out = {
        "params": SET_B,
        "anchors": {"card": meta.get("card"),
                    "measured_at": meta.get("measured_at")},
        "fabric": (f"H100 SXM5 spec, not measured (one card): "
                   f"{dm.BW0 / 1e9:g} GB/s a shard (half of NVLink 4's 450 "
                   f"GB/s a direction a GPU), {dm.TCOLL0 * 1e6:g} us a "
                   "collective over NVSwitch (an assumption)"),
        "note": (
            "exact bytes a shard receives per op (ici_bytes_per_op, "
            "_limb: the JAX package's figures). limb = RNS rows sharded, "
            "whole-limb NTTs (B1, B2), two chunked row-block all_gathers "
            "(the reference's Driver.h:155-191 dispatch); coeff = columns "
            "sharded, one all_to_all per transform (the JAX schedule's "
            "count; the port batches the two keys' calls) and the "
            "automorphism's ppermutes. chosen: the H100 model's pick "
            "(scripts/scaling_projection_torch.py's anchors)"),
        "rows": rows,
    }
    with open(os.path.join(ROOT, "DISPATCH_BAKEOFF_H100.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(f"{'op':8} {'level':5} {'ns':3} {'limb MB':>8} {'coeff MB':>9} "
          f"{'coeff/limb':>10} {'colls l/c':>10} {'T limb/coeff/hyb ms':>24} "
          "chosen")
    for r in rows:
        ts = "/".join("-" if r[k] is None else f"{r[k]:.3f}" for k in (
            "t_model_limb_ms", "t_model_coeff_ms", "t_model_hybrid_ms"))
        print(f"{r['op']:8} {r['level']:5} {r['ns']:3} "
              f"{r['ici_limb_mb']:8.2f} {r['ici_coeff_mb']:9.2f} "
              f"{r['coeff_over_limb']:10.2f} "
              f"{r['collectives_limb']:4}/{r['collectives_coeff']:<5} "
              f"{ts:>24} {r['chosen']} ({r['chosen_by']})")
    print("# wrote DISPATCH_BAKEOFF_H100.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
