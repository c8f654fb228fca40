"""Projected-time dispatch model of the CLI's `--dispatch auto`: the port's
copy of `homulator_tpu/parallel/dispatch_model.py`.

    T(op, axis, ns, level) = T_compute + ICI_bytes/BW + colls * t_coll - H

T_compute is per-shard compute measured on the device at two levels and
interpolated in level (`_interp_level`); ICI_bytes the exact bytes a
shard receives (sharded.ici_bytes_per_op, limb_sharded.ici_bytes_per_op_limb
/ _hybrid); colls the collective calls (limb_collective_count,
coeff_collective_count); H the limb axis's credit for the chunked gathers'
overlap with the compute they feed, per gather site the lesser of the
transfer's (G-1)/G and the measured overlappable compute.

The anchors are the card's own: `scripts/scaling_projection_torch.py`
runs shard 0's program of each dispatch alone on one card, its
collectives replaced by the shape-preserving local copies of
`comm.StandInMesh`, times it by CUDA-graph replay (device time, no host)
at levels 35 and 11, and generates `_scaling_measured.py`, which this
module loads. Without that file, or at other params than the anchors'
(compute scales with N and alpha), `predict_ms` and `predict_hybrid_ms`
return None and `choose_axis` picks the axis with fewer bytes exchanged a
shard (`how` = "volume"). `MEASURED` takes the JAX module's format:
{"compute_ms": {"op|axis|ns": {level: ms}}, "overlap_ms": {"op|ns":
{"modup": ms, "tail": ms, "level": L}}, "t1_ms": {op: {level: ms}},
"meta": {"params": {...}, ...}}.

The fabric constants are the published figures of an HGX H100 SXM5 node,
not measured (the machine has one card): BW0 is half of NVLink 4's 450
GB/s a direction a GPU, TCOLL0 an assumed launch cost of one collective
over NVSwitch. The scaling projection sweeps both. `bw` and `tcoll`
override them a call; their defaults are read from the module when
called.
"""

from __future__ import annotations

from typing import Optional

# H100 SXM5 spec, not measured (one card): a shard's receive rate over
# NVLink 4 (half of 450 GB/s a direction a GPU) and an assumed launch cost
# of one collective over NVSwitch
BW0 = 225e9
TCOLL0 = 10e-6

MEASURED: Optional[dict]
try:
    from ._scaling_measured import MEASURED
except ImportError:  # not generated in this checkout
    MEASURED = None


def coeff_collective_count(params, level: int, op: str, *,
                           route_identity: bool = False) -> int:
    """Collective calls of one coefficient-sharded op in the JAX package's
    schedule: one all_to_all per transform call (ModUp: 1 iNTT + beta digit
    NTTs; hmult tails 3 calls x 2 keys; hrotate ModDown 2 x 2) and, in
    hrotate, two automorphism ppermutes, none where the route's block map
    is the identity (route_identity; the JAX function bills two there)."""
    beta = params.beta(level)
    if op == "hmult":
        return 1 + beta + 2 * 3
    return 1 + beta + 2 * 2 + (0 if route_identity else 2)


def _interp_level(anchors: dict, level: int) -> Optional[float]:
    """compute_ms at `level` from {level: ms} anchors: proportional from
    one anchor, else linear on the segment that holds level (the outermost
    one beyond the anchors), floored at 0."""
    if not anchors:
        return None
    pts = sorted((int(lv), ms) for lv, ms in anchors.items())
    if len(pts) == 1:
        lv0, ms0 = pts[0]
        return ms0 * level / lv0
    for (l0, m0), (l1, m1) in zip(pts, pts[1:]):
        if level <= l1 or (l0, m0) == pts[-2]:
            return max(0.0, m0 + (level - l0) / (l1 - l0) * (m1 - m0))
    return pts[-1][1]


def _anchors_fit(params) -> bool:
    """MEASURED exists and was measured at params' (n, max_level, alpha)."""
    if MEASURED is None:
        return False
    mp = MEASURED.get("meta", {}).get("params", {})
    return not mp or (mp.get("n"), mp.get("max_level"), mp.get("alpha")) \
        == (params.n, params.max_level, params.alpha)


def _overlap_credit(params, op, ns_l, ns_c, level, ov_scale, bw) -> float:
    """H in seconds: per gather site min(bytes/bw * (G-1)/G, measured
    overlappable ms), the sites' bytes and compute on ns_c-column slices."""
    from .limb_sharded import _ceil_div, pick_gchunks

    t = params.ntt
    G = pick_gchunks(t.n1, t.n2 // ns_c)
    ov = MEASURED["overlap_ms"].get(f"{op}|{ns_l}")
    if not ov or G == 1:
        return 0.0
    n = params.n // ns_c
    sm, sa = _ceil_div(level, ns_l), _ceil_div(params.alpha, ns_l)
    rows_tail = 2 * (sa + 1) if op == "hmult" else 2 * sa
    scale = level / ov.get("level", level) * ov_scale
    return sum(min((ns_l - 1) * rows * n * 4 / bw * (G - 1) / G,
                   ov[site] * scale / 1e3)
               for rows, site in ((sm, "modup"), (rows_tail, "tail")))


def predict_ms(params, op: str, axis: str, ns: int, level: int, *,
               bw: Optional[float] = None, tcoll: Optional[float] = None,
               route_identity: bool = False,
               overlap: bool = True) -> Optional[float]:
    """Projected ms of one op on `axis` ("limb" or "coeff") at ns shards,
    or None without anchors for (op, axis, ns) at these params. bw (bytes
    a second a shard receives) and tcoll (seconds a collective) default to
    BW0 and TCOLL0; overlap=False leaves out the limb axis's credit H."""
    bw = BW0 if bw is None else bw
    tcoll = TCOLL0 if tcoll is None else tcoll
    if not _anchors_fit(params):
        return None
    anchors = MEASURED["compute_ms"].get(f"{op}|{axis}|{ns}")
    if not anchors:
        return None
    compute = _interp_level(anchors, level) / 1e3
    if axis == "limb":
        from .limb_sharded import ici_bytes_per_op_limb, limb_collective_count

        t = (compute + ici_bytes_per_op_limb(params, level, ns, op) / bw
             + limb_collective_count(params, level, ns, op) * tcoll)
        if overlap:
            t -= _overlap_credit(params, op, ns, 1, level, 1.0, bw)
    else:
        from .sharded import ici_bytes_per_op

        t = (compute + ici_bytes_per_op(params, level, ns, op,
                                        route_identity=route_identity) / bw
             + coeff_collective_count(params, level, op,
                                      route_identity=route_identity) * tcoll)
    return 1e3 * t


def predict_hybrid_ms(params, op: str, ns_l: int, ns_c: int, level: int, *,
                      bw: Optional[float] = None,
                      tcoll: Optional[float] = None,
                      route_identity: bool = False) -> Optional[float]:
    """Projected ms on the (ns_l limb x ns_c coeff) mesh: compute from the
    hybrid anchors ("op|hybrid{ns_l}x{ns_c}|{ns}"), else limb(ns_l) times
    the coeff axis's measured column ratio at ns_c; None without them. bw
    and tcoll as in predict_ms."""
    bw = BW0 if bw is None else bw
    tcoll = TCOLL0 if tcoll is None else tcoll
    if not _anchors_fit(params):
        return None
    comp = MEASURED["compute_ms"]
    anchors_h = comp.get(f"{op}|hybrid{ns_l}x{ns_c}|{ns_l * ns_c}")
    anchors_l = comp.get(f"{op}|limb|{ns_l}")
    anchors_c = comp.get(f"{op}|coeff|{ns_c}")
    t1 = MEASURED.get("t1_ms", {}).get(op)
    if anchors_h:
        compute = _interp_level(anchors_h, level)
    elif anchors_l and anchors_c and t1:
        ratio = _interp_level(anchors_c, level) / _interp_level(t1, level)
        compute = _interp_level(anchors_l, level) * min(1.0, ratio)
    else:
        return None
    from .limb_sharded import ici_bytes_per_op_hybrid, limb_collective_count

    colls = (limb_collective_count(params, level, ns_l, op, ns_c=ns_c)
             + coeff_collective_count(params, level, op,
                                      route_identity=route_identity))
    t = (compute / 1e3 + ici_bytes_per_op_hybrid(
        params, level, ns_l, ns_c, op, route_identity=route_identity) / bw
         + colls * tcoll
         - _overlap_credit(params, op, ns_l, ns_c, level, 1.0 / ns_c, bw))
    return 1e3 * t


def choose_axis(params, op: str, ns: int, level: int, *,
                coeff_ok: bool = True, route_identity: bool = False):
    """(axis, t_limb_ms, t_coeff_ms, how): by the model where anchors
    exist (how "model"), else the axis with fewer bytes exchanged a shard,
    limb on a tie or where coeff cannot run (how "volume")."""
    t_limb = predict_ms(params, op, "limb", ns, level)
    t_coeff = (predict_ms(params, op, "coeff", ns, level,
                          route_identity=route_identity)
               if coeff_ok else None)
    if t_limb is not None and (t_coeff is not None or not coeff_ok):
        axis = "coeff" if t_coeff is not None and t_coeff < t_limb \
            else "limb"
        return axis, t_limb, t_coeff, "model"
    from .limb_sharded import ici_bytes_per_op_limb
    from .sharded import ici_bytes_per_op

    ici_limb = ici_bytes_per_op_limb(params, level, ns, op)
    ici_coeff = (ici_bytes_per_op(params, level, ns, op,
                                  route_identity=route_identity)
                 if coeff_ok else None)
    axis = "coeff" if ici_coeff is not None and ici_coeff < ici_limb \
        else "limb"
    return axis, None, None, "volume"
