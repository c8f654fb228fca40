"""The port's dispatch studies on the CPU, at n = 256, maxLevel 8, alpha 4
(the engine of tests/test_torch_limb_shard.py) unless set B is named:

  * parallel.comm.StandInMesh (shard 0 alone, its collectives local copies
    of the real result's shape) against ThreadMesh(device="cpu") rank 0,
    through parallel.comm.standin_programs, for
    the coefficient, limb and hybrid hmult and hrotate: equal output
    shapes, bytes received (also equal to ici_bytes_per_op / _limb /
    _hybrid) and collective calls on every axis (the limb axis's also
    limb_collective_count);
  * scripts/scaling_projection_torch.py --smoke exits 0 and writes
    nothing;
  * the port's dispatch model (predict_ms with and without the overlap
    credit, predict_hybrid_ms) and scripts/hybrid_projection_torch.py's
    hybrid_t_ms equal the JAX model's and the JAX script's at set B, on
    the same made-up anchors and the JAX model's fabric constants (passed
    as bw / tcoll, and set as the module's BW0 / TCOLL0 for hybrid_t_ms);
  * scripts/dispatch_bakeoff_torch.py's bytes and collective counts equal
    the rows of the JAX package's committed DISPATCH_BAKEOFF.json;
  * the committed anchors (parallel/_scaling_measured.py, generated on
    the card) hold every key the projection writes, and route set B by
    the model to the axis that it predicts faster;
  * scripts/bench_data_axis_torch.py's data-axis cases (coeff, limb,
    hybrid, make_sharded_hmult; chip_smoke's B = 4 checks): B = 4 on 2
    data rows equals four single-device hmults with B = 2's collective and
    kernel-wrapper calls a shard and twice its bytes;
  * each new script imports neither jax nor the JAX package.
"""

import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from homulator_tpu.parallel import dispatch_model as jax_dm
from homulator_tpu_torch.api import CkksEngine, get_params
from homulator_tpu_torch.parallel import dispatch_model as dm
from homulator_tpu_torch.parallel import limb_sharded as ls
from homulator_tpu_torch.parallel import sharded as sh
from homulator_tpu_torch.parallel.comm import ThreadMesh, standin_programs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SET_B = dict(n=1 << 16, max_level=45, alpha=15)
LEVEL = 7  # pad rows at 2 and 4 limb shards
NEW_SCRIPTS = ("scaling_projection_torch", "hybrid_projection_torch",
               "dispatch_bakeoff_torch", "bench_ntt_grid_torch",
               "bench_ntt_width_torch", "bench_data_axis_torch")
DATA_LABELS = ("coeff 2x4", "limb 2x4", "hybrid 2x(2x2)", "gspmd (2,2,2)")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _script(name):
    return _load(os.path.join(ROOT, "scripts", f"{name}.py"), name)


@pytest.fixture(scope="module")
def eng():
    e = CkksEngine(get_params(n=256, max_level=8, alpha=4), seed=5,
                   device="cpu")
    e.keygen()
    e.gen_rotation_key(1)
    return e


def _thread_run(eng, axis, nl, nc, op, cts):
    """(ThreadMesh, its results) of one real run of the dispatch."""
    dc, p = eng.dc, eng.params
    g = p.galois_elt(1)
    a, b = (c.data for c in cts)
    key = eng.relin_key if op == "hmult" else eng.rot_keys[1]
    if axis == "coeff":
        mesh = ThreadMesh(nl, "cpu")
        if op == "hmult":
            f = sh.make_shardmap_hmult(dc, LEVEL, mesh)
            return mesh, f(sh.shard_cols(a, nl), sh.shard_cols(b, nl),
                           sh.shard_cols(key, nl))
        f = sh.make_shardmap_hrotate(dc, LEVEL, mesh)
        return mesh, f(sh.shard_cols(a, nl), dc.automorph_shard_route(g, nl),
                       sh.shard_cols(key, nl))
    if nc == 1:
        mesh = ThreadMesh(nl, "cpu", names=("limb",))
        make = ls.make_limb_hmult if op == "hmult" else ls.make_limb_hrotate
        route = dc.automorph_perm(g)
    else:
        mesh = ThreadMesh((nl, nc), "cpu", names=("limb", "coeff"))
        make = (ls.make_hybrid_hmult if op == "hmult"
                else ls.make_hybrid_hrotate)
        route = dc.automorph_shard_route(g, nc)
    f = make(dc, LEVEL, mesh)
    other = (ls.shard_rows(b, LEVEL, nl, nc) if op == "hmult" else route)
    return mesh, f(ls.shard_rows(a, LEVEL, nl, nc), other,
                   ls.limb_key(key, p, LEVEL, nl, nc))


def _bytes(p, dc, axis, nl, nc, op):
    g = p.galois_elt(1)
    if axis == "coeff":
        ident = op == "hrotate" and dc.automorph_shard_route(g, nl)[2]
        return sh.ici_bytes_per_op(p, LEVEL, nl, op, route_identity=ident)
    if axis == "limb":
        return ls.ici_bytes_per_op_limb(p, LEVEL, nl, op)
    ident = op == "hrotate" and dc.automorph_shard_route(g, nc)[2]
    return ls.ici_bytes_per_op_hybrid(p, LEVEL, nl, nc, op,
                                      route_identity=ident)


@pytest.mark.parametrize("op", ["hmult", "hrotate"])
@pytest.mark.parametrize("axis", ["coeff", "limb", "hybrid"])
@pytest.mark.parametrize("ns", [2, 4])
def test_stand_in_matches_thread_mesh_rank0(eng, axis, ns, op):
    """Shard 0's program on a StandInMesh gives the ThreadMesh rank 0's
    output shape, bytes and calls (hybrid: ns limb x 2 coeff shards)."""
    p = eng.params
    nc = 2 if axis == "hybrid" else 1
    rng = np.random.default_rng(ns)
    cts = [eng.encrypt_complex(rng.normal(size=p.n // 2), LEVEL, 2.0**29)
           for _ in range(2)]
    mesh, fns = standin_programs(eng, LEVEL, axis, ns, nc, cts)
    got = fns[op]()
    tmesh, want = _thread_run(eng, axis, ns, nc, op, cts)
    assert len(got) == 1 and got[0].shape == want[0].shape
    nbytes = _bytes(p, eng.dc, axis, ns, nc, op)
    assert mesh.recv_bytes == [nbytes] == tmesh.recv_bytes[:1]
    axes = mesh.names or (None,)
    assert {a: mesh.calls(a) for a in axes} == \
        {a: tmesh.calls(a)[:1] for a in axes}
    if axis != "coeff":
        assert mesh.calls("limb") == [ls.limb_collective_count(
            p, LEVEL, ns, op, ns_c=nc)]
    mesh.reset_counts()
    assert mesh.recv_bytes == [0] and mesh.calls() == [0]


def test_scaling_projection_smoke_writes_nothing():
    """--smoke runs every program and section once on the CPU plain path
    and leaves the committed outputs as they were."""
    outs = [os.path.join(ROOT, "SCALING_H100.json"),
            os.path.join(ROOT, "homulator_tpu_torch", "parallel",
                         "_scaling_measured.py")]

    def digest():
        return [hashlib.sha256(open(f, "rb").read()).hexdigest()
                if os.path.exists(f) else None for f in outs]

    before = digest()
    r = subprocess.run([sys.executable, "scripts/scaling_projection_torch.py",
                        "--smoke"], cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "smoke OK" in r.stdout
    assert digest() == before


def _anchors(p):
    """Made-up anchors in the JAX module's format (not a measurement)."""
    comp = {}
    for op in ("hmult", "hrotate"):
        for ns in (2, 4, 8):
            comp[f"{op}|limb|{ns}"] = {11: 0.3 / ns, 35: 1.0 / ns}
            comp[f"{op}|coeff|{ns}"] = {11: 0.25 / ns, 35: 1.1 / ns}
        comp[f"{op}|hybrid2x2|4"] = {11: 0.1, 35: 0.6}
        comp[f"{op}|hybrid4x2|8"] = {11: 0.05, 35: 0.35}
    return {
        "compute_ms": comp,
        "overlap_ms": {f"{op}|{ns}": {"modup": 0.05, "tail": 0.04,
                                      "level": 35}
                       for op in ("hmult", "hrotate") for ns in (2, 4, 8)},
        "t1_ms": {op: {11: 0.5, 35: 1.6} for op in ("hmult", "hrotate")},
        "meta": {"params": {"n": p.n, "max_level": p.max_level,
                            "alpha": p.alpha}},
    }


@pytest.mark.parametrize("op", ["hmult", "hrotate"])
def test_model_and_hybrid_rows_match_jax(op, monkeypatch):
    """Same anchors, the JAX fabric constants passed as bw / tcoll (and
    set as dm.BW0 / dm.TCOLL0 for hybrid_t_ms, which reads them): the
    port's predict_ms (overlap on and off), predict_hybrid_ms and
    hybrid_t_ms rows equal the JAX ones at set B."""
    p = get_params(**SET_B)
    meas = _anchors(p)
    monkeypatch.setattr(jax_dm, "MEASURED", meas)
    monkeypatch.setattr(dm, "MEASURED", meas)
    fabric = dict(bw=jax_dm.BW0, tcoll=jax_dm.TCOLL0)
    for level in (11, 22, 35):
        for ns in (2, 4, 8):
            for axis in ("limb", "coeff"):
                for overlap in (True, False):
                    assert dm.predict_ms(p, op, axis, ns, level,
                                         overlap=overlap, **fabric) == \
                        pytest.approx(jax_dm.predict_ms(
                            p, op, axis, ns, level, overlap=overlap),
                            rel=1e-12)
        for nl, nc in ((2, 2), (4, 2), (2, 4)):
            assert dm.predict_hybrid_ms(p, op, nl, nc, level, **fabric) == \
                pytest.approx(jax_dm.predict_hybrid_ms(p, op, nl, nc, level),
                              rel=1e-12)
    port = _script("hybrid_projection_torch")
    jax_script = _load(os.path.join(ROOT, "scripts", "hybrid_projection.py"),
                       "hybrid_projection")
    rows_meas = dict(meas, t1_ms={"hmult": 1.6, "hrotate": 1.7})
    monkeypatch.setattr(dm, "BW0", jax_dm.BW0)
    monkeypatch.setattr(dm, "TCOLL0", jax_dm.TCOLL0)
    for nl, nc in ((2, 2), (4, 2), (2, 4)):
        got = port.hybrid_t_ms(p, op, nl, nc, 35, rows_meas)
        want = jax_script.hybrid_t_ms(p, op, nl, nc, 35, rows_meas)
        assert got.keys() == want.keys()
        for k in want:
            if k != "compute_note":  # prose
                assert got[k] == pytest.approx(want[k], rel=1e-12), k


def test_bakeoff_counts_match_jax_file():
    """The bake-off's bytes and collective counts equal the JAX package's
    committed DISPATCH_BAKEOFF.json, row for row (read only)."""
    with open(os.path.join(ROOT, "DISPATCH_BAKEOFF.json")) as f:
        want = {(r["op"], r["level"], r["ns"]): r
                for r in json.load(f)["rows"]}
    rows = _script("dispatch_bakeoff_torch").bakeoff_rows(
        get_params(**SET_B))
    assert {(r["op"], r["level"], r["ns"]) for r in rows} == set(want)
    for r in rows:
        w = want[r["op"], r["level"], r["ns"]]
        for k in ("ici_limb_mb", "ici_coeff_mb", "collectives_limb",
                  "collectives_coeff", "coeff_over_limb"):
            assert r[k] == w[k], (r, k)


def test_committed_anchors_route_set_b():
    """The generated module holds every key the projection writes, at
    set B, with the card's name; dispatch_model loads it, and
    choose_axis routes set B by the model to the axis it predicts
    faster (the axis itself is the card's to decide)."""
    from homulator_tpu_torch.parallel import _scaling_measured as gen

    meas = gen.MEASURED
    assert dm.MEASURED is meas
    for op in ("hmult", "hrotate"):
        keys = [f"{op}|{axis}|{ns}" for axis in ("coeff", "limb")
                for ns in (2, 4, 8)]
        keys += [f"{op}|hybrid2x2|4", f"{op}|hybrid4x2|8"]
        for k in keys:
            assert set(meas["compute_ms"][k]) == {35, 11}, k
            assert all(v > 0 for v in meas["compute_ms"][k].values()), k
        for ns in (2, 4, 8):
            ov = meas["overlap_ms"][f"{op}|{ns}"]
            assert ov["level"] == 35 and ov["modup"] >= 0 and \
                ov["tail"] > 0
        assert set(meas["t1_ms"][op]) == {35, 11}
    meta = meas["meta"]
    assert meta["params"] == SET_B
    assert re.search(r"H100", meta["card"]) and meta["gchunks"] == 4
    p = get_params(**SET_B)
    for op in ("hmult", "hrotate"):
        for ns in (2, 4, 8):
            axis, t_l, t_c, how = dm.choose_axis(p, op, ns, 35)
            assert how == "model"
            assert t_l == dm.predict_ms(p, op, "limb", ns, 35)
            assert t_c == dm.predict_ms(p, op, "coeff", ns, 35)
            assert axis == ("coeff" if t_c < t_l else "limb")


@pytest.mark.parametrize("label", DATA_LABELS)
def test_data_axis_cases(eng, label):
    """scripts/bench_data_axis_torch.py's cases (chip_smoke's data-axis
    checks) on the CPU at level 7: a batch of 4 on 2 data rows equals four
    single-device hmults, and beside B = 2 (one element a shard) it makes
    the same collective calls on every axis and kernel-wrapper calls a
    shard, and each shard receives twice the bytes."""
    from homulator_tpu_torch import kernels

    from .test_torch_limb_shard import _kernel_calls

    mod = _script("bench_data_axis_torch")
    assert mod.LABELS == DATA_LABELS
    rng = np.random.default_rng(23)
    cts = [eng.encrypt_complex(rng.normal(size=eng.params.n // 2), LEVEL,
                               2.0**29) for _ in range(2)]
    a, b, want = mod.hmult_operands(torch, eng, cts)
    case = mod.data_cases(eng, LEVEL, (label,))[label]
    seen = {}
    for B in (2, 4):
        ((got, _, calls, nbytes), _), by_shard = _kernel_calls(
            lambda: mod.run_case(torch, kernels, case, a[:B], b[:B]))
        assert torch.equal(got, want[:B])
        seen[B] = calls, nbytes, by_shard
    assert seen[4][0] == seen[2][0]
    assert seen[4][1] == [2 * x for x in seen[2][1]]
    assert seen[4][2] == seen[2][2] and len(set(seen[2][2].values())) == 1
    assert len(seen[2][2]) == len(case[0].comms) == 8


@pytest.mark.parametrize("name", NEW_SCRIPTS)
def test_new_script_imports_no_jax(name):
    """Loading the script in a fresh interpreter imports neither jax nor
    the JAX package, and no import statement of it names either."""
    with open(os.path.join(ROOT, "scripts", f"{name}.py")) as f:
        src = f.read()
    assert not re.search(r"^\s*(from|import)\s+(jax|homulator_tpu)\b", src,
                         re.M)
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location({name!r}, "
        f"'scripts/{name}.py')\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "assert callable(mod.main)\n"
        "bad = sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'homulator_tpu'))\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
