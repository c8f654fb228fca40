"""The port's limb-sharded hmult and hrotate (parallel/limb_sharded.py) and
the dispatch model of `--dispatch auto` (parallel/dispatch_model.py) on
the CPU (the kernels' plain versions), bit for bit (tolerance 0), at
n = 256, maxLevel 8, alpha 4 (the engine of tests/test_sharding.py):

  * vs the JAX package's make_limb_hmult / make_limb_hrotate on the
    conftest's CPU mesh in interpret mode, with the JAX engine's keys and
    ciphertexts carried across (from_jax_state);
  * vs the port's single-device ops on ThreadMesh(ns, "cpu") at the JAX
    tests' grid of (shards, level), real rows equal and pad rows zero, and
    a data x limb batch, also vs the JAX data-axis program, one program a
    shard (one element's collective and kernel-wrapper calls);
  * in two processes through torch.distributed (gloo, DistMesh), and the
    data x limb batch in four;
  * the exchanged bytes and collective calls vs ici_bytes_per_op_limb and
    limb_collective_count, and those, evk_limb_row_order and choose_axis
    vs the JAX functions (at this size and at set B);
  * coeff_collective_count's identity route, where the port deliberately
    differs from the JAX function, and the model's predictions vs the JAX
    model's on the same (made-up) anchors.
"""

import collections
import os
import socket
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homulator_tpu.api import CkksEngine as JaxEngine
from homulator_tpu.parallel import dispatch_model as jax_dm
from homulator_tpu.parallel import limb_sharded as jax_ls
from homulator_tpu.parallel.mesh import make_mesh
from homulator_tpu.params import get_params
from homulator_tpu_torch import kernels
from homulator_tpu_torch.api import CkksEngine
from homulator_tpu_torch.context import from_jax_state
from homulator_tpu_torch.parallel import dispatch_model as dm
from homulator_tpu_torch.parallel import limb_sharded as ls
from homulator_tpu_torch.parallel.comm import ThreadMesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 2.0**29
STEP = 3
SET_B = dict(n=1 << 16, max_level=45, alpha=15)


@pytest.fixture(scope="module")
def engines():
    """(JAX interpret-mode engine, port engine on the CPU), same seed and
    key order, so their keys are equal."""
    params = get_params(n=256, max_level=8, alpha=4)
    jeng = JaxEngine(params, seed=5, ntt_mode="interpret")
    eng = CkksEngine(params, seed=5, device="cpu")
    for e in (jeng, eng):
        e.keygen()
        e.gen_rotation_key(STEP)
    return jeng, eng


def _u32(t):
    return t.numpy().view(np.uint32)


def _mesh(ns, **kw):
    return ThreadMesh(ns, "cpu", timeout=60, names=("limb",), **kw)


def _check_counts(mesh, params, level, ns, op):
    assert mesh.recv_bytes == [ls.ici_bytes_per_op_limb(
        params, level, ns, op)] * len(mesh.comms)
    assert mesh.calls("limb") == [ls.limb_collective_count(
        params, level, ns, op)] * len(mesh.comms)


def test_limb_hmult_matches_jax(engines):
    """4 shards, level 8: the port's limb hmult == the JAX make_limb_hmult
    on every padded row (the pad rows zero on both)."""
    jeng, eng = engines
    ns, level = 4, 8
    rng = np.random.default_rng(1)
    ja, jb = (jeng.encrypt_complex(rng.normal(size=128), level, SCALE)
              for _ in range(2))
    mesh = make_mesh(shape=(ns,), n_devices=ns, axis_names=("limb",))
    order = jnp.asarray(jax_ls.evk_limb_row_order(jeng.params, level, ns))
    want = np.asarray(jax_ls.make_limb_hmult(jeng.dc, level, mesh)(
        jax_ls.pad_main_rows(ja.data, level, ns),
        jax_ls.pad_main_rows(jb.data, level, ns),
        jnp.take(jeng.relin_key, order, axis=2)))
    t = from_jax_state({"a": np.asarray(ja.data), "b": np.asarray(jb.data),
                        "k": np.asarray(jeng.relin_key)}, eng.dc)
    tmesh = _mesh(ns)
    got = ls.gather_rows(ls.make_limb_hmult(eng.dc, level, tmesh)(
        ls.shard_rows(t["a"], level, ns), ls.shard_rows(t["b"], level, ns),
        ls.limb_key(t["k"], eng.params, level, ns)), ns)
    assert np.array_equal(_u32(got), want)
    _check_counts(tmesh, eng.params, level, ns, "hmult")


def test_limb_hrotate_matches_jax(engines):
    """4 shards, level 6 (two pad rows): the port's limb hrotate == the
    JAX make_limb_hrotate on every padded row."""
    jeng, eng = engines
    ns, level = 4, 6
    ja = jeng.encrypt_complex(np.random.default_rng(2).normal(size=128),
                              level, SCALE)
    mesh = make_mesh(shape=(ns,), n_devices=ns, axis_names=("limb",))
    order = jnp.asarray(jax_ls.evk_limb_row_order(jeng.params, level, ns))
    g = jeng.params.galois_elt(STEP)
    want = np.asarray(jax_ls.make_limb_hrotate(jeng.dc, level, mesh)(
        jax_ls.pad_main_rows(ja.data, level, ns), jeng.dc.automorph_perm(g),
        jnp.take(jeng.rot_keys[STEP], order, axis=2)))
    t = from_jax_state({"a": np.asarray(ja.data),
                        "k": np.asarray(jeng.rot_keys[STEP])}, eng.dc)
    tmesh = _mesh(ns)
    got = ls.gather_rows(ls.make_limb_hrotate(eng.dc, level, tmesh)(
        ls.shard_rows(t["a"], level, ns), eng.dc.automorph_perm(g),
        ls.limb_key(t["k"], eng.params, level, ns)), ns)
    assert np.array_equal(_u32(got), want)
    _check_counts(tmesh, eng.params, level, ns, "hrotate")


@pytest.mark.parametrize("ns,level", [
    (2, 8), (4, 8), (8, 8), (4, 7), (8, 5),
    (4, 4),  # one digit (level == alpha), no pad rows
    (4, 3),  # one partial digit and pad rows
])
def test_limb_hmult_matches_single_device(engines, ns, level):
    """Real rows == the single-device hmult, pad rows zero, at the JAX
    tests' grid (levels 7, 5, 3: blocks with pad rows; 8 shards at level
    5: shards holding pad rows only)."""
    _, eng = engines
    rng = np.random.default_rng(10 * ns + level)
    a, b = (eng.encrypt_complex(rng.normal(size=128), level, SCALE)
            for _ in range(2))
    mesh = _mesh(ns)
    got = ls.gather_rows(ls.make_limb_hmult(eng.dc, level, mesh)(
        ls.shard_rows(a.data, level, ns), ls.shard_rows(b.data, level, ns),
        ls.limb_key(eng.relin_key, eng.params, level, ns)), ns)
    assert torch.equal(got[:, :level - 1], eng.hmult(a, b).data)
    assert not got[:, level - 1:].any(), "pad rows must be zero"
    _check_counts(mesh, eng.params, level, ns, "hmult")


@pytest.mark.parametrize("ns,level", [(2, 8), (4, 8), (4, 6)])
def test_limb_hrotate_matches_single_device(engines, ns, level):
    _, eng = engines
    a = eng.encrypt_complex(np.random.default_rng(ns + level).normal(
        size=128), level, SCALE)
    mesh = _mesh(ns)
    perm = eng.dc.automorph_perm(eng.params.galois_elt(STEP))
    got = ls.gather_rows(ls.make_limb_hrotate(eng.dc, level, mesh)(
        ls.shard_rows(a.data, level, ns), perm,
        ls.limb_key(eng.rot_keys[STEP], eng.params, level, ns)), ns)
    assert torch.equal(got[:, :level], eng.hrotate(a, STEP).data)
    assert not got[:, level:].any(), "pad rows must be zero"
    _check_counts(mesh, eng.params, level, ns, "hrotate")


def _kernel_calls(fn):
    """fn()'s result and its kernel-wrapper calls by shard thread: on the
    CPU each wrapper runs its kernel's plain version inside
    kernels.as_kernel, once where the card launches the kernel once (the
    count kernels.LAUNCHES keeps there)."""
    calls = collections.Counter()
    real = kernels.as_kernel

    def spy(*args, **kw):
        calls[threading.current_thread().name] += 1
        return real(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kernels, "as_kernel", spy)
        out = fn()
    return out, calls


def test_limb_hmult_data_axis(engines):
    """A batch of 4 hmults on 2 data rows x 4 limb shards (level 7: pad
    rows) == the single-device hmults and the JAX data-axis program (its
    vmap inside shard_map) on every padded row; each shard runs its 2
    elements as one program: one element's collective calls and kernel
    calls (one hmult on a 1-row mesh), its 2 elements' bytes."""
    jeng, eng = engines
    ns, d, level = 4, 2, 7
    rng = np.random.default_rng(11)
    a, b = ([eng.encrypt_complex(rng.normal(size=128), level, SCALE)
             for _ in range(4)] for _ in range(2))
    ab, bb = (torch.stack([x.data for x in v]) for v in (a, b))
    key = ls.limb_key(eng.relin_key, eng.params, level, ns)
    mesh = _mesh(ns, data=d)
    f = ls.make_limb_hmult(eng.dc, level, mesh, data_axis="data")
    out, calls = _kernel_calls(lambda: f(
        ls.shard_rows(ab, level, ns, data=d),
        ls.shard_rows(bb, level, ns, data=d), key))
    got = ls.gather_rows(out, ns, data=d)
    want = torch.stack([eng.hmult(x, y).data for x, y in zip(a, b)])
    assert torch.equal(got[:, :, :level - 1], want)
    assert not got[:, :, level - 1:].any()
    jmesh = make_mesh(shape=(d, ns), n_devices=d * ns,
                      axis_names=("data", "limb"))
    order = jnp.asarray(jax_ls.evk_limb_row_order(jeng.params, level, ns))
    jax_out = jax_ls.make_limb_hmult(jeng.dc, level, jmesh,
                                     data_axis="data")(
        *(jax_ls.pad_main_rows(jnp.asarray(_u32(x)), level, ns)
          for x in (ab, bb)),
        jnp.take(jeng.relin_key, order, axis=2))
    assert np.array_equal(_u32(got), np.asarray(jax_out))
    assert mesh.recv_bytes == [2 * ls.ici_bytes_per_op_limb(
        eng.params, level, ns, "hmult")] * (d * ns)
    assert mesh.calls("limb") == [ls.limb_collective_count(
        eng.params, level, ns, "hmult")] * (d * ns)
    one = _mesh(ns)
    _, one_calls = _kernel_calls(lambda: ls.make_limb_hmult(
        eng.dc, level, one)(ls.shard_rows(ab[0], level, ns),
                            ls.shard_rows(bb[0], level, ns), key))
    assert mesh.calls("limb") == one.calls("limb") * d
    assert len(set(one_calls.values())) == 1
    assert sorted(calls) == [f"shard{r}.{k}" for r in range(d)
                             for k in range(ns)]
    assert set(calls.values()) == set(one_calls.values())
    with pytest.raises(ValueError, match="data_axis"):
        ls.make_limb_hmult(eng.dc, level, mesh)


def test_limb_rejects_wrong_mesh(engines):
    """A mesh without a 'limb' axis, or with a coeff axis too, is refused
    (make_hybrid_* takes the latter)."""
    _, eng = engines
    with pytest.raises(ValueError, match="mesh axes"):
        ls.make_limb_hmult(eng.dc, 8, ThreadMesh(2, "cpu"))
    with pytest.raises(ValueError, match="mesh axes"):
        ls.make_limb_hrotate(eng.dc, 8, ThreadMesh(
            (2, 2), "cpu", names=("limb", "coeff")))


@pytest.mark.parametrize("op", ["hmult", "hrotate"])
@pytest.mark.parametrize("ns", [2, 4, 8])
def test_counts_match_jax(op, ns):
    """ici_bytes_per_op_limb, ici_bytes_per_op_hybrid (ns limb x 2 coeff,
    both routes), limb_collective_count on the limb mesh and
    evk_limb_row_order == the JAX functions, at the test shape (levels 8
    and 5) and at set B (level 35, alpha 15; the figures of the limb
    path's chip run)."""
    cases = [(get_params(n=256, max_level=8, alpha=4), lv) for lv in (8, 5)]
    cases.append((get_params(**SET_B), 35))
    for p, level in cases:
        assert ls.ici_bytes_per_op_limb(p, level, ns, op) == \
            jax_ls.ici_bytes_per_op_limb(p, level, ns, op)
        for ident in (False, True):
            assert ls.ici_bytes_per_op_hybrid(
                p, level, ns, 2, op, route_identity=ident) == \
                jax_ls.ici_bytes_per_op_hybrid(p, level, ns, 2, op,
                                               route_identity=ident)
        assert ls.limb_collective_count(p, level, ns, op) == \
            jax_ls.limb_collective_count(p, level, ns, op)
        assert np.array_equal(ls.evk_limb_row_order(p, level, ns),
                              jax_ls.evk_limb_row_order(p, level, ns))
    p = get_params(**SET_B)
    want = {2: (9437184, 8912896), 4: (14942208, 13369344),
            8: (20185088, 16515072)}[ns]
    assert ls.ici_bytes_per_op_limb(p, 35, ns, op) == \
        want[op == "hrotate"]


@pytest.mark.parametrize("op", ["hmult", "hrotate"])
@pytest.mark.parametrize("ns", [2, 4, 8])
def test_choose_axis_matches_jax(op, ns, monkeypatch):
    """Without anchors (MEASURED None on both sides: each side's
    generated module set aside) the port's choose_axis picks what the JAX
    one picks, by bytes exchanged, at the test shape and at set B, on
    either route and with coeff ruled out."""
    from homulator_tpu_torch.parallel.mesh import coeff_shard_ok

    monkeypatch.setattr(jax_dm, "MEASURED", None)
    monkeypatch.setattr(dm, "MEASURED", None)
    for p, level in ((get_params(n=256, max_level=8, alpha=4), 4),
                     (get_params(**SET_B), 35)):
        ok = coeff_shard_ok(p.ntt.n1, p.ntt.n2, ns)
        for ident in (False, True):
            kw = dict(coeff_ok=ok, route_identity=ident)
            assert dm.choose_axis(p, op, ns, level, **kw) == \
                jax_dm.choose_axis(p, op, ns, level, **kw)
        assert dm.choose_axis(p, op, ns, level, coeff_ok=False)[0] == "limb"
        assert dm.predict_ms(p, op, "limb", ns, level) is None
        assert dm.predict_hybrid_ms(p, op, ns, 2, level) is None


def test_coeff_collective_count_identity_route():
    """The second latent gate bug: on the identity route the coefficient
    dispatch's hrotate runs no automorphism ppermute, so the port bills
    none there; the JAX function bills two. Everywhere else they agree."""
    for p in (get_params(n=256, max_level=8, alpha=4),
              get_params(**SET_B)):
        for level in range(2, p.max_level + 1):
            for op in ("hmult", "hrotate"):
                assert dm.coeff_collective_count(p, level, op) == \
                    jax_dm.coeff_collective_count(p, level, op)
            assert dm.coeff_collective_count(p, level, "hmult",
                                             route_identity=True) == \
                jax_dm.coeff_collective_count(p, level, "hmult")
            assert dm.coeff_collective_count(
                p, level, "hrotate", route_identity=True) == \
                jax_dm.coeff_collective_count(p, level, "hrotate") - 2


def _anchors(p):
    """A made-up MEASURED in the JAX module's format (not a measurement):
    compute anchors at two levels for every op, axis and shard count the
    CLI asks about, overlap sections, and the single-device times."""
    comp = {}
    for op in ("hmult", "hrotate"):
        for ns in (2, 4, 8):
            comp[f"{op}|limb|{ns}"] = {11: 0.3 / ns, 35: 1.0 / ns}
            comp[f"{op}|coeff|{ns}"] = {11: 0.25 / ns, 35: 1.1 / ns}
        comp[f"{op}|hybrid2x2|4"] = {11: 0.1, 35: 0.6}
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
def test_model_matches_jax_on_same_anchors(op, monkeypatch):
    """With the same anchors and the JAX model's fabric constants on both
    sides (passed as bw / tcoll, and set as the port's BW0 / TCOLL0 for
    choose_axis), predict_ms, predict_hybrid_ms (measured 2 x 2 and
    composed 4 x 2) and choose_axis equal the JAX model's at set B, where
    its gather depth agrees (both G = 4 at n2/2 = 128 columns) and off the
    identity route; other parameters find no anchors (None)."""
    p = get_params(**SET_B)
    meas = _anchors(p)
    monkeypatch.setattr(jax_dm, "MEASURED", meas)
    monkeypatch.setattr(dm, "MEASURED", meas)
    fabric = dict(bw=jax_dm.BW0, tcoll=jax_dm.TCOLL0)
    monkeypatch.setattr(dm, "BW0", jax_dm.BW0)
    monkeypatch.setattr(dm, "TCOLL0", jax_dm.TCOLL0)
    for level in (11, 20, 35, 40):
        for ns in (2, 4, 8):
            for axis in ("limb", "coeff"):
                assert dm.predict_ms(p, op, axis, ns, level, **fabric) == \
                    pytest.approx(jax_dm.predict_ms(p, op, axis, ns, level),
                                  rel=1e-12)
            assert dm.choose_axis(p, op, ns, level) == pytest.approx(
                jax_dm.choose_axis(p, op, ns, level))
        for ns_l in (2, 4):
            assert dm.predict_hybrid_ms(p, op, ns_l, 2, level,
                                        **fabric) == \
                pytest.approx(jax_dm.predict_hybrid_ms(p, op, ns_l, 2,
                                                       level), rel=1e-12)
    other = get_params(n=256, max_level=8, alpha=4)
    assert dm.predict_ms(other, op, "limb", 2, 8) is None
    assert dm.predict_hybrid_ms(other, op, 2, 2, 8) is None


_DIST_WORKER = r"""
import sys
import numpy as np, torch, torch.distributed as dist
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
from homulator_tpu_torch.api import CkksEngine, get_params
from homulator_tpu_torch.parallel import limb_sharded as ls
from homulator_tpu_torch.parallel.comm import DistMesh
eng = CkksEngine(get_params(n=256, max_level=8, alpha=4), seed=5,
                 device="cpu")
eng.keygen()
rng = np.random.default_rng(9)
a, b = (eng.encrypt_complex(rng.normal(size=128), 7, 2.0**29)
        for _ in range(2))
mesh = DistMesh.grid(2, ("limb",))
f = ls.make_limb_hmult(eng.dc, 7, mesh)
res = f({rank: ls.shard_rows(a.data, 7, 2)[rank]},
        {rank: ls.shard_rows(b.data, 7, 2)[rank]},
        {rank: ls.limb_key(eng.relin_key, eng.params, 7, 2)[rank]})
torch.save({"out": res[0], "bytes": mesh.total_recv_bytes,
            "calls": mesh.calls}, out)
dist.destroy_process_group()
"""


def test_dist_mesh_gloo_two_processes(engines, tmp_path):
    """A limb hmult at level 7 (a pad row) in 2 CPU processes (gloo,
    DistMesh.grid): each rank's row block equals the single-device
    result's, and each received ici_bytes_per_op_limb bytes in
    limb_collective_count collectives."""
    _, eng = engines
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT)
    outs = [tmp_path / f"rank{r}.pt" for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DIST_WORKER, str(r), str(port), str(outs[r])],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    # the same engine, seed and call order as the workers
    ref = CkksEngine(eng.params, seed=5, device="cpu")
    ref.keygen()
    rng = np.random.default_rng(9)
    a, b = (ref.encrypt_complex(rng.normal(size=128), 7, SCALE)
            for _ in range(2))
    hm = ref.hmult(a, b).data  # 6 rows: 8 padded, 2 of them pad
    want = torch.cat([hm, hm.new_zeros((2, 2) + hm.shape[2:])], dim=1)
    for r in range(2):
        res = torch.load(outs[r])
        assert torch.equal(res["out"], want[:, 4 * r:4 * (r + 1)])
        assert res["bytes"] == ls.ici_bytes_per_op_limb(eng.params, 7, 2)
        assert res["calls"] == ls.limb_collective_count(eng.params, 7, 2)


_DIST_DATA_WORKER = r"""
import sys
import numpy as np, torch, torch.distributed as dist
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=4)
from homulator_tpu_torch.api import CkksEngine, get_params
from homulator_tpu_torch.parallel import limb_sharded as ls
from homulator_tpu_torch.parallel.comm import DistMesh
eng = CkksEngine(get_params(n=256, max_level=8, alpha=4), seed=5,
                 device="cpu")
eng.keygen()
rng = np.random.default_rng(9)
a, b = (torch.stack([eng.encrypt_complex(rng.normal(size=128), 7,
                                         2.0**29).data for _ in range(4)])
        for _ in range(2))
mesh = DistMesh.grid(2, ("limb",), data=2)
i = mesh.index
f = ls.make_limb_hmult(eng.dc, 7, mesh, data_axis="data")
res = f({i: ls.shard_rows(a, 7, 2, data=2)[i]},
        {i: ls.shard_rows(b, 7, 2, data=2)[i]},
        {mesh.rank: ls.limb_key(eng.relin_key, eng.params, 7, 2)[mesh.rank]})
torch.save({"out": res[0], "index": i, "bytes": mesh.total_recv_bytes,
            "calls": mesh.calls}, out)
dist.destroy_process_group()
"""


def test_dist_mesh_data_axis_gloo_four_processes(engines, tmp_path):
    """A batch of 4 limb hmults at level 7 (a pad row) on 2 data rows x 2
    limb shards as 4 gloo processes (DistMesh.grid with data=2), two
    elements a shard: each shard's [2, 2, 4, n2, n1] block equals the
    single-device results' (pad rows zero), and each received 2 x
    ici_bytes_per_op_limb bytes in one element's limb_collective_count
    collectives."""
    _, eng = engines
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT)
    outs = [tmp_path / f"rank{r}.pt" for r in range(4)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DIST_DATA_WORKER, str(r), str(port),
         str(outs[r])], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    # the same engine, seed and call order as the workers
    ref = CkksEngine(eng.params, seed=5, device="cpu")
    ref.keygen()
    rng = np.random.default_rng(9)
    a, b = ([ref.encrypt_complex(rng.normal(size=128), 7, SCALE)
             for _ in range(4)] for _ in range(2))
    hm = torch.stack([ref.hmult(x, y).data for x, y in zip(a, b)])
    # 6 rows, 8 padded: rank 1's last two are zero
    want = torch.cat([hm, hm.new_zeros((4, 2, 2) + hm.shape[3:])], dim=2)
    for r in range(4):
        res = torch.load(outs[r])
        row, lr = divmod(r, 2)
        assert res["index"] == r
        assert torch.equal(res["out"], want[2 * row:2 * (row + 1), :,
                                            4 * lr:4 * (lr + 1)])
        assert res["bytes"] == 2 * ls.ici_bytes_per_op_limb(eng.params, 7, 2)
        assert res["calls"] == ls.limb_collective_count(eng.params, 7, 2)


def test_thread_mesh_named_axes():
    """ThreadMesh with named axes: each axis's Comm exchanges within the
    shards that share the other coordinates, in that axis's rank order;
    bytes and calls are counted per Comm and summed per shard; a failing
    shard aborts the shards waiting on another axis, and run() re-raises
    its error."""
    mesh = ThreadMesh((2, 3), "cpu", timeout=30, data=2,
                      names=("limb", "coeff"))
    assert (mesh.size, mesh.extent("limb"), mesh.extent("coeff")) == (6, 2, 3)

    def body(comm):
        x = torch.tensor([comm.index], dtype=torch.int32)
        lc, cc = comm.axis("limb"), comm.axis("coeff")
        return (lc.rank, cc.rank, lc.all_gather(x, 0).tolist(),
                cc.all_gather(x, 0).tolist())

    got = mesh.run(body)
    for i, (l, c, lg, cg) in enumerate(got):
        row, r = divmod(i, 6)
        assert (l, c) == divmod(r, 3)
        assert lg == [row * 6 + j * 3 + c for j in range(2)]
        assert cg == [row * 6 + l * 3 + j for j in range(3)]
    assert mesh.recv_bytes == [(1 + 2) * 4] * 12
    assert mesh.calls("limb") == mesh.calls("coeff") == [1] * 12
    assert mesh.calls() == [0] * 12
    mesh.reset_counts()
    assert mesh.recv_bytes == [0] * 12

    def failing(comm):
        if comm.index == 7:
            raise KeyError("shard 7")
        comm.axis("coeff").all_gather(torch.zeros(1), 0)
        return comm.axis("limb").all_gather(torch.zeros(1), 0)

    with pytest.raises(KeyError, match="shard 7"):
        mesh.run(failing)
    with pytest.raises(ValueError, match="no axis"):
        mesh.extent("data")
    with pytest.raises(ValueError, match="names them"):
        ThreadMesh((2, 2), "cpu")
