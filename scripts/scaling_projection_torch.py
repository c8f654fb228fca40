#!/usr/bin/env python3
"""Multi-card scaling projection of the port from one card's measurements.

    python3 scripts/scaling_projection_torch.py          # on the card
    python3 scripts/scaling_projection_torch.py --smoke  # CPU check

The counterpart of scripts/scaling_projection.py. The machine has one
H100, so no collective crosses a link; every input of the projection is
measured on that card or counted:

  per-shard compute  shard 0's program of each sharded dispatch run alone
                     on the card at its exact per-shard shapes, every
                     collective replaced by a local copy of the real
                     result's shape (parallel.comm.StandInMesh and
                     standin_programs), captured in a CUDA graph and timed
                     by replay (benchlib.device_ms): device time without
                     the host.
                     Coefficient (make_shardmap_*, lane-packed as the JAX
                     package routes it), limb (make_limb_*) and hybrid
                     (make_hybrid_*) hmult and hrotate(1) at 2, 4, 8 shards
                     and 2 x 2, 4 x 2, at levels 35 and 11 (the model
                     interpolates in level). The eager time of one call is
                     printed and kept beside it; only device time is an
                     anchor. Shard 0 is measured, as the JAX script
                     measures device 0: at these shapes it never owns the
                     rescale's last limb.
  overlappable       the limb axis's sections that can run while a chunked
  compute            gather is in flight, each timed alone at level 35 on
                     the port's own functions (parallel/limb_sharded.py):
                     (a) ModUp's conversions over the gathered chunks
                     (_modup_convs), (b) the d0/d1 tensor product
                     (_tensor_d01), (c) the main rows' inner product
                     (_ip_slice), (d) hmult's tail conversion
                     (_tail_convs), (e) hrotate's ModDown conversion
                     (_moddown_convs); combined into the credit H with the
                     JAX arithmetic, (G-1)/G of a chunked section, G =
                     pick_gchunks.
  ns = 1             hmult and hrotate(1) on one card, device time
                     (benchlib.hmult_ms / hrotate_ms, the piecewise route,
                     which the shard programs run).
  bytes, calls       exact: ici_bytes_per_op(_limb, _hybrid),
                     limb_collective_count, coeff_collective_count.
  fabric             the published figures of an HGX H100 SXM5 node, not
                     measured (one card): NVLink 4, 450 GB/s a direction a
                     GPU, swept as a grid around half of it; a collective's
                     launch cost over NVSwitch, an assumption, swept too.
                     The 2-host rows cross InfiniBand NDR, 400 Gb/s = 50
                     GB/s a GPU, swept below it.

Model (parallel/dispatch_model.py, shared with the CLI's --dispatch auto):
T = T_compute + bytes/BW + calls * t_coll - H (H = 0 off the limb axis).
Efficiency = T(1) / (ns * T(ns)). 2-host rows: a mesh axis of ns split
over two hosts sends ns/2 of a shard's ns-1 received blocks over
InfiniBand; NVLink and InfiniBand are distinct fabrics, so the exchange
takes max(intra/BW, inter/BW_ib) and every collective pays t_coll_ib.

Writes SCALING_H100.json and generates
homulator_tpu_torch/parallel/_scaling_measured.py (the anchors that
dispatch_model loads), each with the card's name and power limit. With
--smoke it runs on the CPU at n = 256, maxLevel 8, alpha 4, one level,
4 shards and the 2 x 2 hybrid, each program once on the plain versions
(placeholder times, no measurement), and writes nothing. Imports no JAX
and nothing of the JAX package.
"""

import argparse
import json
import os
import pprint
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

LEVELS = (35, 11)  # compute anchors: set B's headline level, a low one
NSS = (2, 4, 8)
HYBRIDS = ((2, 2), (4, 2))  # (limb, coeff) shards
SET_B = dict(n=1 << 16, max_level=45, alpha=15)
SMOKE = dict(params=dict(n=256, max_level=8, alpha=4), levels=(8,),
             nss=(4,), hybrids=((2, 2),))
SCALE = 2.0**29
# H100 SXM5 spec, not measured (one card). NVLink 4: 450 GB/s a direction
# a GPU; the centre is half of it, the grid's top the spec.
BW_GRID = (112.5e9, 225e9, 450e9)
# a collective's launch cost over NVSwitch: an assumption, swept
TCOLL_GRID = (5e-6, 10e-6, 20e-6)
# the 2-host boundary, InfiniBand NDR: 400 Gb/s = 50 GB/s a GPU (spec,
# not measured), centre half of it; 25 us a collective that crosses it
BW_IB_GRID = (12.5e9, 25e9, 50e9)
BW_IB0 = BW_IB_GRID[1]
TCOLL_IB = 25e-6
GENERATED = os.path.join(ROOT, "homulator_tpu_torch", "parallel",
                         "_scaling_measured.py")


def _uniform(shape, bound: int, rng, device):
    """int32 tensor of `shape` on device, uniform below bound."""
    import torch

    x = rng.integers(0, bound, size=shape, dtype=np.int64).astype(np.int32)
    return torch.from_numpy(x).to(device)


def overlap_sections(eng, level: int, ns: int, timed) -> dict:
    """The limb axis's overlappable sections at `level` on ns shards,
    shard 0's tables, each timed alone by timed(fn): {section: seconds}."""
    from homulator_tpu_torch.ops.modmath import col
    from homulator_tpu_torch.parallel import limb_sharded as ls

    dc, p = eng.dc, eng.params
    T = ls.build_limb_tables(dc, level, ns, 0)
    G, n1, n2 = T.gchunks, p.ntt.n1, p.ntt.n2
    sa, sm, B = T.sa, T.sm, T.sa + T.sm
    beta = len(T.digits)
    bound = int(p.q_arr.min())  # below every prime: a residue of each row
    rng = np.random.default_rng(0)
    dev = dc.device

    def chunks(x, dim):
        return [c.contiguous() for c in x.chunk(G, dim)]

    gparts = chunks(_uniform((ns * sm, n1, n2), bound, rng, dev), 1)
    a, b = (_uniform((2, sm, n2, n1), bound, rng, dev) for _ in range(2))
    ev = _uniform((beta * B, n2, n1), bound, rng, dev)
    key = ls.limb_key(eng.relin_key, p, level, ns)[0]
    gf_h = chunks(_uniform((2, ns * (sa + 1), n1, n2), bound, rng, dev), 2)
    gf_r = chunks(_uniform((2, ns * sa, n1, n2), bound, rng, dev), 2)
    q = col(T.q_main)
    return {
        "modup_conv": timed(lambda: ls._modup_convs(gparts, T)),
        "d01": timed(lambda: ls._tensor_d01(a, b, q)),
        "ip_main": timed(lambda: ls._ip_slice(ev, key, T, sa, sa + sm)),
        "tail_conv": timed(lambda: ls._tail_convs(gf_h, T)),
        "md_conv": timed(lambda: ls._moddown_convs(gf_r, T)),
    }


def overlap_entries(sec: dict, G: int, level: int) -> dict:
    """{"hmult": ..., "hrotate": ...} overlap_ms entries from the sections'
    seconds, the JAX arithmetic: a chunked section counts (G-1)/G."""
    f = (G - 1) / G if G > 1 else 0.0
    ms = {k: round(1e3 * v, 4) for k, v in sec.items()}
    return {
        "hmult": {"modup": round(1e3 * (sec["modup_conv"] * f + sec["d01"]),
                                 4),
                  "tail": round(1e3 * (sec["ip_main"]
                                       + sec["tail_conv"] * f), 4),
                  "level": level,
                  "sections_ms": {k: ms[k] for k in ("modup_conv", "d01",
                                                     "ip_main", "tail_conv")}},
        "hrotate": {"modup": round(1e3 * sec["modup_conv"] * f, 4),
                    "tail": round(1e3 * (sec["ip_main"]
                                         + sec["md_conv"] * f), 4),
                    "level": level,
                    "sections_ms": {k: ms[k] for k in ("modup_conv",
                                                       "ip_main", "md_conv")}},
    }


def ib_exchange_s(ici_cross, ns_cross, bw_ib, ici_other=0.0):
    """Seconds of a shard's exchange with the mesh axis of ns_cross shards
    split over two hosts: of the ns_cross-1 blocks of ici_cross bytes a
    shard receives over it, ns_cross/2 cross InfiniBand at bw_ib; the rest
    and the bytes of the other mesh axis (ici_other) stay on NVLink
    (dispatch_model.BW0). The two are distinct fabrics, so the exchange
    takes the longer of the two."""
    from homulator_tpu_torch.parallel import dispatch_model as dm

    inter = ici_cross * (ns_cross // 2) / (ns_cross - 1)
    return max((ici_cross - inter + ici_other) / dm.BW0, inter / bw_ib)


def two_host_t(params, measured, op, axis, ns, level, bw_ib, G):
    """Seconds of one op with the mesh axis split over two hosts: the
    exchange of ib_exchange_s, every collective paying TCOLL_IB, the limb
    axis's credit against that exchange (the JAX script's dcn_t)."""
    from homulator_tpu_torch.parallel import dispatch_model as dm
    from homulator_tpu_torch.parallel.limb_sharded import (
        ici_bytes_per_op_limb, limb_collective_count,
    )
    from homulator_tpu_torch.parallel.sharded import ici_bytes_per_op

    comp = dm._interp_level(measured["compute_ms"][f"{op}|{axis}|{ns}"],
                            level) / 1e3
    if axis == "limb":
        ici = ici_bytes_per_op_limb(params, level, ns, op)
        colls = limb_collective_count(params, level, ns, op)
    else:
        ici = ici_bytes_per_op(params, level, ns, op)
        colls = dm.coeff_collective_count(params, level, op)
    comm = ib_exchange_s(ici, ns, bw_ib)
    t = comp + comm + colls * TCOLL_IB
    ov = measured["overlap_ms"].get(f"{op}|{ns}")
    if axis == "limb" and ov and G > 1:
        t -= min(comm * (G - 1) / G, (ov["modup"] + ov["tail"]) / 1e3)
    return t


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CPU check at tiny params; writes nothing")
    args = ap.parse_args(argv)
    smoke = args.smoke
    levels = SMOKE["levels"] if smoke else LEVELS
    nss = SMOKE["nss"] if smoke else NSS
    hybrids = SMOKE["hybrids"] if smoke else HYBRIDS

    import torch

    from homulator_tpu_torch import benchlib
    from homulator_tpu_torch.params import get_params
    from homulator_tpu_torch.parallel import dispatch_model as dm
    from homulator_tpu_torch.parallel.comm import standin_programs
    from homulator_tpu_torch.parallel.limb_sharded import (
        ici_bytes_per_op_limb, limb_collective_count, pick_gchunks,
    )
    from homulator_tpu_torch.parallel.sharded import ici_bytes_per_op

    if smoke:
        from homulator_tpu_torch.api import CkksEngine

        params = get_params(**SMOKE["params"])
        eng = CkksEngine(params, seed=1, device="cpu")
        card = device = "cpu (smoke: placeholder times, not measured)"
    else:
        from homulator_tpu_torch import kernels
        from homulator_tpu_torch.workloads import native_engine

        if not torch.cuda.is_available():
            raise SystemExit("scaling_projection_torch: needs a CUDA card "
                             "(--smoke runs on the CPU)")
        kernels.build()
        kernels.load()
        params = get_params(**SET_B)
        eng = native_engine(params, seed=1)
        card, device = benchlib.card_line(), torch.cuda.get_device_name(0)
        print(card, flush=True)
    eng.keygen()
    eng.gen_rotation_key(1)
    G = pick_gchunks(params.ntt.n1, params.ntt.n2)
    rng = np.random.default_rng(7)

    def cts_at(level):
        return [eng.encrypt_complex(rng.uniform(-1, 1, params.n // 2), level,
                                    SCALE) for _ in range(2)]

    def timed(fn):
        """Device seconds of one fn() (CUDA-graph replay); in smoke mode
        one call and a placeholder 1 ms."""
        if smoke:
            fn()
            return 1e-3
        return 1e-3 * benchlib.device_ms(fn, calls=2)

    def eager(fn):
        return None if smoke else benchlib.latency_ms(fn, iters=10)

    out = {"levels": list(levels),
           "params": {"n": params.n, "max_level": params.max_level,
                      "alpha": params.alpha},
           "card": card, "device": device, "gchunks": G,
           "bw_grid_GBps": [b / 1e9 for b in BW_GRID],
           "tcoll_grid_us": [t * 1e6 for t in TCOLL_GRID],
           "bw_ib_grid_GBps": [b / 1e9 for b in BW_IB_GRID],
           "tcoll_ib_us": TCOLL_IB * 1e6,
           "fabric": ("H100 SXM5 spec, not measured (one card): NVLink 4 "
                      "450 GB/s a direction a GPU (grid 112.5-450 GB/s, "
                      "centre 225); t_coll over NVSwitch an assumption "
                      "(5-20 us); 2-host rows over InfiniBand NDR, 400 Gb/s "
                      "= 50 GB/s a GPU (grid 12.5-50, centre 25), 25 us a "
                      "collective"),
           "measured": ("shard 0's program alone on one card, collectives "
                        "as local copies (parallel.comm.StandInMesh), device "
                        "ms by CUDA-graph replay; limb shard 0 never owns "
                        "the rescale's last limb at these shapes"),
           "model": ("T = T_compute(measured, level-interpolated) + bytes/BW"
                     " + colls*t_coll - H; H = limb-axis overlap credit "
                     "min(hideable_bytes/BW, measured overlappable compute)"
                     " per gather site (parallel/dispatch_model.py)")}

    # ---- ns = 1 baselines --------------------------------------------------
    t1, cts = {}, {}
    for lvl in levels:
        cts[lvl] = cts_at(lvl)
        c1, c2 = cts[lvl]
        t1[lvl] = ((1e-3, 1e-3) if smoke else
                   (1e-3 * benchlib.hmult_ms(eng, c1, c2),
                    1e-3 * benchlib.hrotate_ms(eng, c1, 1)))
        print(f"# one card, level {lvl}: hmult {1e3 * t1[lvl][0]:.4f} ms, "
              f"hrotate {1e3 * t1[lvl][1]:.4f} ms device", flush=True)
    lvl0 = levels[0]
    out["t1_hmult_ms"] = round(1e3 * t1[lvl0][0], 4)
    out["t1_hrotate_ms"] = round(1e3 * t1[lvl0][1], 4)

    # ---- per-shard compute --------------------------------------------------
    compute_ms, eager_ms, overlap_ms = {}, {}, {}
    meshes = [("coeff", ns, 1) for ns in nss] + [
        ("limb", ns, 1) for ns in nss] + [
        ("hybrid", nl, nc) for nl, nc in hybrids]
    for axis, ns, nc in meshes:
        tag = (f"hybrid{ns}x{nc}" if axis == "hybrid" else axis)
        total = ns * nc
        for lvl in levels:
            _, fns = standin_programs(eng, lvl, axis, ns, nc, cts[lvl])
            line = []
            for op, fn in fns.items():
                key = f"{op}|{tag}|{total}"
                compute_ms.setdefault(key, {})[lvl] = round(
                    1e3 * timed(fn), 4)
                e = eager(fn)
                eager_ms.setdefault(key, {})[lvl] = e and round(e, 4)
                line.append(f"{op} {compute_ms[key][lvl]:.4f} device"
                            + (f" / {e:.3f} eager" if e else ""))
            print(f"# {tag} x{total} level {lvl}, shard 0: "
                  + ", ".join(line) + " ms", flush=True)
    for ns in nss:
        sec = overlap_sections(eng, lvl0, ns, timed)
        for op, entry in overlap_entries(sec, G, lvl0).items():
            overlap_ms[f"{op}|{ns}"] = entry
        print(f"# ns={ns} overlappable sections (ms): " + ", ".join(
            f"{k} {1e3 * v:.4f}" for k, v in sec.items()), flush=True)

    measured = {"compute_ms": compute_ms, "overlap_ms": overlap_ms,
                "t1_ms": {"hmult": {lv: round(1e3 * t1[lv][0], 4)
                                    for lv in levels},
                          "hrotate": {lv: round(1e3 * t1[lv][1], 4)
                                      for lv in levels}},
                "meta": {"gchunks": G, "params": out["params"],
                         "card": card, "device": device,
                         "measured_at": time.strftime("%Y-%m-%d %H:%M:%S")}}
    dm.MEASURED = measured

    # ---- projection ---------------------------------------------------------
    rows = []
    for ns in nss:
        for op, t1s in (("hmult", t1[lvl0][0]), ("hrotate", t1[lvl0][1])):
            for axis in ("coeff", "limb"):
                ici = (ici_bytes_per_op_limb(params, lvl0, ns, op)
                       if axis == "limb"
                       else ici_bytes_per_op(params, lvl0, ns, op))
                colls = (limb_collective_count(params, lvl0, ns, op)
                         if axis == "limb"
                         else dm.coeff_collective_count(params, lvl0, op))
                key = f"{op}|{axis}|{ns}"
                r = {"op": op, "axis": axis, "ns": ns,
                     "compute_ms": compute_ms[key][lvl0],
                     "compute_ms_by_level": compute_ms[key],
                     "eager_ms_by_level": eager_ms[key],
                     "ici_mb": round(ici / 1e6, 2), "collectives": colls}
                for bw in BW_GRID:
                    for tl in TCOLL_GRID:
                        t = dm.predict_ms(params, op, axis, ns, lvl0, bw=bw,
                                          tcoll=tl)
                        grid = f"bw{bw / 1e9:g}_tl{tl * 1e6:g}us"
                        r[f"t_ms[{grid}]"] = round(t, 4)
                        r[f"eff[{grid}]"] = round(1e3 * t1s / (ns * t), 4)
                t0 = dm.predict_ms(params, op, axis, ns, lvl0)
                t0_no = dm.predict_ms(params, op, axis, ns, lvl0,
                                      overlap=False)
                r.update(t_ms=round(t0, 4), t_ms_no_overlap=round(t0_no, 4),
                         overlap_credit_ms=round(t0_no - t0, 4),
                         ops_per_s=round(1e3 / t0, 1),
                         efficiency=round(1e3 * t1s / (ns * t0), 4),
                         efficiency_no_overlap=round(1e3 * t1s / (ns * t0_no),
                                                     4))
                if ns >= 4:
                    for bwi in BW_IB_GRID:
                        td = two_host_t(params, measured, op, axis, ns, lvl0,
                                        bwi, G)
                        grid = f"2host_bwib{bwi / 1e9:g}"
                        r[f"t_ms[{grid}]"] = round(1e3 * td, 4)
                        r[f"eff[{grid}]"] = round(t1s / (ns * td), 4)
                    td0 = two_host_t(params, measured, op, axis, ns, lvl0,
                                     BW_IB0, G)
                    r["t_ms_2host"] = round(1e3 * td0, 4)
                    r["efficiency_2host"] = round(t1s / (ns * td0), 4)
                rows.append(r)
                print(f"ns={ns} {op:8} {axis:5} compute="
                      f"{r['compute_ms']:7.4f} ms ici={ici / 1e6:6.2f} MB "
                      f"colls={colls:3} -> T={r['t_ms']:7.4f} ms (no-ov "
                      f"{r['t_ms_no_overlap']:7.4f}) eff="
                      f"{r['efficiency']:.2%}", flush=True)
    hyb_rows = []
    for nl, nc in hybrids:
        for op, t1s in (("hmult", t1[lvl0][0]), ("hrotate", t1[lvl0][1])):
            th = dm.predict_hybrid_ms(params, op, nl, nc, lvl0)
            key = f"{op}|hybrid{nl}x{nc}|{nl * nc}"
            hyb_rows.append({
                "op": op, "axis": f"hybrid_{nl}limb_x_{nc}coeff",
                "ns": nl * nc, "ns_l": nl, "ns_c": nc,
                "compute_ms": compute_ms[key][lvl0],
                "eager_ms_by_level": eager_ms[key],
                "t_ms": round(th, 4),
                "efficiency": round(1e3 * t1s / (nl * nc * th), 4)})
            print(f"hybrid {nl}x{nc} {op:8} T={th:7.4f} ms "
                  f"eff={1e3 * t1s / (nl * nc * th):.2%}", flush=True)
    out.update(rows=rows, hybrid_rows_measured=hyb_rows,
               overlap_sections=overlap_ms,
               measured_at=measured["meta"]["measured_at"])
    if smoke:
        print("# smoke OK (placeholder times; nothing written)")
        return 0
    with open(os.path.join(ROOT, "SCALING_H100.json"), "w") as f:
        json.dump(out, f, indent=1)
    with open(GENERATED, "w") as f:
        f.write('"""GENERATED by scripts/scaling_projection_torch.py on '
                'the card named in\nmeta: per-shard compute anchors '
                '(device ms, CUDA-graph replay) and\noverlappable-section '
                'times of the dispatch model\n(parallel/dispatch_model.py). '
                'Do not edit by hand; re-run the script on\nthe card to '
                'refresh."""\n\nMEASURED = '
                + pprint.pformat(measured, width=76) + "\n")
    print("# wrote SCALING_H100.json and "
          "homulator_tpu_torch/parallel/_scaling_measured.py")
    return 0


if __name__ == "__main__":
    sys.exit(main())
