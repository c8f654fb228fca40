#!/usr/bin/env python3
"""Hybrid limb x coeff projection of the port from the card's anchors.

    python3 scripts/hybrid_projection_torch.py

The counterpart of scripts/hybrid_projection.py, pure arithmetic (no
device) over the anchors that scripts/scaling_projection_torch.py
measured on the card (parallel/_scaling_measured.py, SCALING_H100.json):
the (ns_l limb x ns_c coeff) meshes 2 x 2, 4 x 2 and 2 x 4 at set B,
level 35, each row from the shared model (dispatch_model.
predict_hybrid_ms: the measured hybrid anchors of 2 x 2 and 4 x 2; for
2 x 4, which no run measured, the composition limb(ns_l) x the coeff
axis's measured column ratio at ns_c, an estimate, stated as such), with
the bytes split by axis (the limb gathers carry column slices, the
transforms run on the shard's row block) and the overlap credit; beside
them the 1-D axes at the same shard count. Then the 2-host rows: with
two hosts, which mesh axis crosses InfiniBand (H100 SXM5 / InfiniBand
NDR spec, not measured: scaling_projection_torch's BW_IB0, TCOLL_IB and
ib_exchange_s): the 2-way coeff axis, keeping the limb gathers on
NVLink, or the limb axis. Appends hybrid_rows and hybrid_note to SCALING_H100.json
(SCALING.json is the TPU's). Imports no JAX and nothing of the JAX
package.
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
from scripts.scaling_projection_torch import (  # noqa: E402
    BW_IB0, TCOLL_IB, ib_exchange_s,
)

LEVEL = 35
COMBOS = ((2, 2), (4, 2), (2, 4))
SET_B = dict(n=1 << 16, max_level=45, alpha=15)


def hybrid_t_ms(params, op, ns_l, ns_c, level, meas):
    """One hybrid row (the JAX function of the same name): the shared
    model's T (predict_hybrid_ms, over dm.MEASURED, at dm.BW0 and
    dm.TCOLL0) with its compute (measured, or the composition estimate
    from meas), bytes by axis, collectives and overlap credit.
    meas["t1_ms"][op] is the one-card ms at `level`."""
    t1_ms = meas["t1_ms"][op]
    hkey = f"{op}|hybrid{ns_l}x{ns_c}|{ns_l * ns_c}"
    if hkey in meas["compute_ms"]:
        comp = dm._interp_level(meas["compute_ms"][hkey], level)
        note = "measured on the card (shard 0's program, StandInMesh)"
    else:
        comp_l = dm._interp_level(meas["compute_ms"][f"{op}|limb|{ns_l}"],
                                  level)
        ratio = min(1.0, dm._interp_level(
            meas["compute_ms"][f"{op}|coeff|{ns_c}"], level) / t1_ms)
        comp = comp_l * ratio
        note = (f"estimate: limb({ns_l})={comp_l:.3f} x "
                f"colratio({ns_c})={ratio:.3f}")
    ici_l = ici_bytes_per_op_limb(params, level, ns_l, op) / ns_c
    ici_c = ici_bytes_per_op(params, level, ns_c, op) / ns_l
    colls = (limb_collective_count(params, level, ns_l, op, ns_c=ns_c)
             + dm.coeff_collective_count(params, level, op))
    t = dm.predict_hybrid_ms(params, op, ns_l, ns_c, level)
    t_no_ov = comp + 1e3 * ((ici_l + ici_c) / dm.BW0 + colls * dm.TCOLL0)
    return {
        "op": op, "axis": f"hybrid_{ns_l}limb_x_{ns_c}coeff",
        "ns": ns_l * ns_c, "ns_l": ns_l, "ns_c": ns_c,
        "compute_ms": round(comp, 4),
        "compute_note": note,
        "ici_mb": round((ici_l + ici_c) / 1e6, 2),
        "ici_limb_mb": round(ici_l / 1e6, 2),
        "ici_coeff_mb": round(ici_c / 1e6, 2),
        "collectives": colls,
        "overlap_credit_ms": round(t_no_ov - t, 4),
        "t_ms": round(t, 4),
        "efficiency": round(t1_ms / (ns_l * ns_c * t), 4),
    }


def two_host(params, r, t1_ms):
    """r's 2-host times (ms), the axis that crosses hosts split as
    scaling_projection_torch.ib_exchange_s splits it: the coeff axis
    across InfiniBand (the limb gathers stay on NVLink) and, for
    contrast, the limb axis across it."""
    op, ns_l, ns_c = r["op"], r["ns_l"], r["ns_c"]
    comp, h = r["compute_ms"] / 1e3, r["overlap_credit_ms"] / 1e3
    ici_l, ici_c = r["ici_limb_mb"] * 1e6, r["ici_coeff_mb"] * 1e6
    colls_l = limb_collective_count(params, LEVEL, ns_l, op, ns_c=ns_c)
    colls_c = dm.coeff_collective_count(params, LEVEL, op)
    t_c = (comp + ib_exchange_s(ici_c, ns_c, BW_IB0, ici_l)
           + colls_l * dm.TCOLL0 + colls_c * TCOLL_IB - h)
    t_l = (comp + ib_exchange_s(ici_l, ns_l, BW_IB0, ici_c)
           + colls_l * TCOLL_IB + colls_c * dm.TCOLL0 - h)
    ns = ns_l * ns_c
    return {"t_ms_2host_coeff_ib": round(1e3 * t_c, 4),
            "eff_2host_coeff_ib": round(t1_ms / 1e3 / (ns * t_c), 4),
            "t_ms_2host_limb_ib": round(1e3 * t_l, 4),
            "eff_2host_limb_ib": round(t1_ms / 1e3 / (ns * t_l), 4)}


def main() -> int:
    if dm.MEASURED is None:
        print("no parallel/_scaling_measured.py: run "
              "scripts/scaling_projection_torch.py on the card first",
              file=sys.stderr)
        return 1
    params = get_params(**SET_B)
    path = os.path.join(ROOT, "SCALING_H100.json")
    with open(path) as f:
        scaling = json.load(f)
    meas = dict(dm.MEASURED)
    meas["t1_ms"] = {"hmult": scaling["t1_hmult_ms"],
                     "hrotate": scaling["t1_hrotate_ms"]}
    rows = [hybrid_t_ms(params, op, nl, nc, LEVEL, meas)
            for op in ("hmult", "hrotate") for nl, nc in COMBOS]
    print(f"{'op':8} {'shape':22} {'comp':>7} {'ici MB':>7} {'T(ms)':>7} "
          f"{'eff':>7}")
    for op in ("hmult", "hrotate"):
        t1 = meas["t1_ms"][op]
        for ns in (4, 8):
            for axis in ("limb", "coeff"):
                t = dm.predict_ms(params, op, axis, ns, LEVEL)
                print(f"{op:8} 1-D {axis:5} ns={ns:<2}        {'':>7} "
                      f"{'':>7} {t:7.3f} {t1 / (ns * t):7.2%}")
        for r in rows:
            if r["op"] == op:
                print(f"{op:8} {r['axis']:22} {r['compute_ms']:7.3f} "
                      f"{r['ici_mb']:7.2f} {r['t_ms']:7.3f} "
                      f"{r['efficiency']:7.2%}")
    for r in rows:
        if r["ns_c"] == 2:
            r.update(two_host(params, r, meas["t1_ms"][r["op"]]))
            print(f"2host {r['op']:8} {r['axis']:22} coeff over IB "
                  f"T={r['t_ms_2host_coeff_ib']:7.3f} ms "
                  f"eff={r['eff_2host_coeff_ib']:.2%} | limb over IB "
                  f"T={r['t_ms_2host_limb_ib']:7.3f} "
                  f"eff={r['eff_2host_limb_ib']:.2%}")
    scaling["hybrid_rows"] = rows
    scaling["hybrid_note"] = (
        "the shared model at level 35 over the card's anchors (2 x 2 and "
        "4 x 2 measured; 2 x 4 the composition limb(ns_l) x the coeff "
        "axis's measured column ratio, an estimate); bytes exact per axis; "
        "the reference's 2-D analog is Driver.h:209-285. 2-host columns: "
        f"InfiniBand NDR spec, not measured ({BW_IB0 / 1e9:g} GB/s, "
        f"{TCOLL_IB * 1e6:g} us) on whichever mesh axis crosses hosts, "
        "NVLink's spec on the other")
    with open(path, "w") as f:
        json.dump(scaling, f, indent=1)
    print("# appended hybrid_rows to SCALING_H100.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
