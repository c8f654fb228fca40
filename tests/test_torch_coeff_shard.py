"""The port's coefficient-sharded hmult and hrotate (parallel/sharded.py)
on the CPU (the kernels' plain versions), bit for bit (tolerance 0), at
n = 256, maxLevel 8, alpha 4 (the engine of tests/test_sharding.py):

  * at 4 shards vs the JAX package's make_shardmap_hmult /
    make_shardmap_hrotate on the conftest's CPU mesh in interpret mode,
    with the JAX engine's keys and ciphertexts carried across;
  * at 2 and 8 shards vs the port's single-device ops;
  * in two processes through torch.distributed (gloo, DistMesh);
  * the automorphism routes and the exchanged bytes vs the JAX tables
    and `ici_bytes_per_op`;
  * the CLI's `--dispatch coeff`.
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from homulator_tpu.api import CkksEngine as JaxEngine
from homulator_tpu.ops.automorph import build_shard_route as jax_route
from homulator_tpu.parallel.mesh import make_mesh
from homulator_tpu.parallel.sharded import (
    ici_bytes_per_op as jax_ici_bytes, make_shardmap_hmult as jax_hmult,
    make_shardmap_hrotate as jax_hrotate,
)
from homulator_tpu.params import get_params
from homulator_tpu_torch import cli
from homulator_tpu_torch.api import CkksEngine
from homulator_tpu_torch.context import Ciphertext, from_jax_state
from homulator_tpu_torch.ops.automorph import (
    automorph_eval, automorph_eval_sharded, automorph_eval_shardperm,
    build_shard_route,
)
from homulator_tpu_torch.parallel.comm import ThreadMesh
from homulator_tpu_torch.parallel.sharded import (
    gather_cols, ici_bytes_per_op, make_shardmap_hmult, make_shardmap_hrotate,
    shard_cols,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 2.0**29
LEVEL = 8
STEP = 3


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


def _ct(jeng, eng, seed):
    """A JAX ciphertext of random slots at LEVEL and its port copy."""
    v = np.random.default_rng(seed).normal(size=jeng.params.n // 2)
    jct = jeng.encrypt_complex(v, LEVEL, SCALE)
    return jct, from_jax_state({"c": np.asarray(jct.data)}, eng.dc)["c"]


def _key(jkey, eng):
    """The JAX engine's key carried across (equal to the port's own)."""
    key = from_jax_state({"k": np.asarray(jkey)}, eng.dc)["k"]
    return key


def _u32(t):
    return t.numpy().view(np.uint32)


def test_keys_cross_from_jax(engines):
    jeng, eng = engines
    assert torch.equal(_key(jeng.relin_key, eng), eng.relin_key)
    assert torch.equal(_key(jeng.rot_keys[STEP], eng), eng.rot_keys[STEP])


def test_hmult_matches_jax_shardmap(engines):
    """4 shards: the port's sharded hmult == the JAX shard_map hmult."""
    jeng, eng = engines
    ns = 4
    ja, a = _ct(jeng, eng, 1)
    jb, b = _ct(jeng, eng, 2)
    mesh = make_mesh(shape=(1, ns), n_devices=ns, axis_names=("data", "coeff"))
    want = np.asarray(jax_hmult(jeng.dc, LEVEL, mesh)(ja.data, jb.data,
                                                      jeng.relin_key))
    tmesh = ThreadMesh(ns, "cpu", timeout=60)
    f = make_shardmap_hmult(eng.dc, LEVEL, tmesh)
    got = gather_cols(f(shard_cols(a, ns), shard_cols(b, ns),
                        shard_cols(_key(jeng.relin_key, eng), ns)))
    assert np.array_equal(_u32(got), want)
    assert tmesh.recv_bytes == [ici_bytes_per_op(eng.params, LEVEL, ns,
                                                 "hmult")] * ns


@pytest.mark.parametrize("gather", [False, True], ids=["ppermute", "gather"])
def test_hrotate_matches_jax_shardmap(engines, gather):
    """4 shards: the port's sharded hrotate == the JAX shard_map hrotate,
    on the shard-permutation route and on the gather-route sentinel."""
    jeng, eng = engines
    ns = 4
    ja, a = _ct(jeng, eng, 3)
    g = eng.params.galois_elt(STEP)
    mesh = make_mesh(shape=(1, ns), n_devices=ns, axis_names=("data", "coeff"))
    jroute = jeng.dc.automorph_shard_route(g, ns)
    route = eng.dc.automorph_shard_route(g, ns)
    if gather:
        jroute = (jeng.dc.automorph_perm(g), None, False)
        route = (eng.dc.automorph_perm(g), None, False)
    want = np.asarray(jax_hrotate(jeng.dc, LEVEL, mesh)(
        ja.data, jroute, jeng.rot_keys[STEP]))
    tmesh = ThreadMesh(ns, "cpu", timeout=60)
    f = make_shardmap_hrotate(eng.dc, LEVEL, tmesh)
    got = gather_cols(f(shard_cols(a, ns), route,
                        shard_cols(_key(jeng.rot_keys[STEP], eng), ns)))
    assert np.array_equal(_u32(got), want)
    if not gather:
        assert tmesh.recv_bytes == [ici_bytes_per_op(
            eng.params, LEVEL, ns, "hrotate", route_identity=route[2])] * ns


@pytest.mark.parametrize("ns", [2, 8])
def test_sharded_ops_match_single_device(engines, ns):
    """2 and 8 shards (n1 = 16: pack_k_for is 0, no packing involved)."""
    _, eng = engines
    rng = np.random.default_rng(ns)
    a, b = (eng.encrypt_complex(rng.normal(size=128), LEVEL, SCALE)
            for _ in range(2))
    mesh = ThreadMesh(ns, "cpu", timeout=60)
    out = make_shardmap_hmult(eng.dc, LEVEL, mesh)(
        shard_cols(a.data, ns), shard_cols(b.data, ns),
        shard_cols(eng.relin_key, ns))
    assert torch.equal(gather_cols(out), eng.hmult(a, b).data)
    route = eng.dc.automorph_shard_route(eng.params.galois_elt(STEP), ns)
    rot = make_shardmap_hrotate(eng.dc, LEVEL, mesh)(
        shard_cols(a.data, ns), route, shard_cols(eng.rot_keys[STEP], ns))
    assert torch.equal(gather_cols(rot), eng.hrotate(a, STEP).data)


@pytest.mark.parametrize("ns", [2, 4, 8])
@pytest.mark.parametrize("step", [1, 3, 17, "conj"])
def test_shard_route_matches_jax(engines, ns, step):
    """build_shard_route's tables == the JAX function's; the ppermute
    route and the all_gather form both equal the single-device gather."""
    _, eng = engines
    p = eng.params
    g = p.galois_conj if step == "conj" else p.galois_elt(step)
    perm = p.automorph_eval_perm(g)
    for ours, theirs in zip(build_shard_route(perm, p.ntt.n2, p.ntt.n1, ns),
                            jax_route(perm, p.ntt.n2, p.ntt.n1, ns)):
        assert np.array_equal(ours, theirs)
    local_src, pairs, _ = eng.dc.automorph_shard_route(g, ns)
    x = torch.from_numpy(np.random.default_rng(g).integers(
        0, 2**30, size=(3, p.ntt.n2, p.ntt.n1)).astype(np.int32))
    xs = shard_cols(x, ns)
    full = eng.dc.automorph_perm(g)
    mesh = ThreadMesh(ns, "cpu", timeout=60)
    route = mesh.run(lambda comm: automorph_eval_shardperm(
        xs[comm.rank], local_src[comm.rank], pairs, comm))
    gathered = mesh.run(lambda comm: automorph_eval_sharded(
        xs[comm.rank], full, comm))
    want = automorph_eval(x, full)
    assert torch.equal(gather_cols(route), want)
    assert torch.equal(gather_cols(gathered), want)


@pytest.mark.parametrize("op", ["hmult", "hrotate"])
@pytest.mark.parametrize("ns", [2, 4, 8, 16, 32])
def test_ici_bytes_match_jax(op, ns):
    """The port's ici_bytes_per_op == the JAX one, packed=False and at the
    default routing (lane-packed at set B from 8 shards on), at the test
    shape and at set B (a pure count)."""
    for p, level in ((get_params(n=256, max_level=8, alpha=4), 8),
                     (get_params(n=1 << 16, max_level=45, alpha=15), 35)):
        for ident in (False, True):
            assert ici_bytes_per_op(p, level, ns, op, route_identity=ident,
                                    packed=False) == jax_ici_bytes(
                p, level, ns, op, route_identity=ident, packed=False)
        assert ici_bytes_per_op(p, level, ns, op) == jax_ici_bytes(
            p, level, ns, op)


_DIST_WORKER = r"""
import sys
import numpy as np, torch, torch.distributed as dist
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
from homulator_tpu_torch.api import CkksEngine, get_params
from homulator_tpu_torch.parallel.comm import DistMesh
from homulator_tpu_torch.parallel.sharded import (
    make_shardmap_hmult, make_shardmap_hrotate, shard_cols)
eng = CkksEngine(get_params(n=256, max_level=8, alpha=4), seed=5,
                 device="cpu")
eng.keygen()
g = eng.params.galois_conj
ckey = eng.dc.upload_kskey_mont(eng.ref._gen_galois_key(g).digits)
rng = np.random.default_rng(9)
a, b = (eng.encrypt_complex(rng.normal(size=128), 8, 2.0**29)
        for _ in range(2))
mesh = DistMesh()
mine = lambda t: shard_cols(t, 2)[rank]
res = {}
res["hmult"] = make_shardmap_hmult(eng.dc, 8, mesh)(
    {rank: mine(a.data)}, {rank: mine(b.data)}, {rank: mine(eng.relin_key)})
res["hmult_bytes"] = mesh.recv_bytes
mesh.reset_counts()
fr = make_shardmap_hrotate(eng.dc, 8, mesh)
route = eng.dc.automorph_shard_route(g, 2)
res["conj"] = fr({rank: mine(a.data)}, route, {rank: mine(ckey)})
res["conj_bytes"] = mesh.recv_bytes
res["conj_gather"] = fr({rank: mine(a.data)}, (eng.dc.automorph_perm(g), None,
                                               False), {rank: mine(ckey)})
torch.save(res, out)
dist.destroy_process_group()
"""


def test_dist_mesh_gloo_two_processes(engines, tmp_path):
    """DistMesh in 2 CPU processes (gloo): each rank's slice of hmult and
    of a conjugation (a non-identity 2-shard route, ppermute and gather
    forms) equals the single-device result; the bytes each rank received
    equal ici_bytes_per_op."""
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
    res = [torch.load(o) for o in outs]
    # the same engine, seed and call order as the workers
    ref = CkksEngine(eng.params, seed=5, device="cpu")
    ref.keygen()
    g = ref.params.galois_conj
    ref._conj_keys[g] = ref.dc.upload_kskey_mont(
        ref.ref._gen_galois_key(g).digits)
    rng = np.random.default_rng(9)
    a, b = (ref.encrypt_complex(rng.normal(size=128), 8, SCALE)
            for _ in range(2))
    hm, cj = ref.hmult(a, b).data, ref.conjugate(a).data
    for r in range(2):
        assert torch.equal(res[r]["hmult"][0], shard_cols(hm, 2)[r])
        assert torch.equal(res[r]["conj"][0], shard_cols(cj, 2)[r])
        assert torch.equal(res[r]["conj_gather"][0], shard_cols(cj, 2)[r])
        assert res[r]["hmult_bytes"] == ici_bytes_per_op(
            ref.params, 8, 2, "hmult")
        assert res[r]["conj_bytes"] == ici_bytes_per_op(
            ref.params, 8, 2, "hrotate")


def test_cli_coeff_dispatch(capsys):
    """`run configs/tiny.cfg hmult 8 8 4 2 --dispatch coeff --device cpu
    --verify` (N = 256, n1 = 16: 2 shards is the most coeff_shard_ok
    allows) exits 0 and matches the single-device op; GSPMD, once exit 2,
    runs as the limb dispatch and matches it too; a tile coeff_shard_ok
    rejects and a hybrid mesh on 2 shards are usage errors, exit 1 as in
    the JAX CLI."""
    rc = cli.main(["run", "configs/tiny.cfg", "hmult", "8", "8", "4", "2",
                   "--dispatch", "coeff", "--device", "cpu", "--verify",
                   "--iters", "1"])
    outp = capsys.readouterr().out
    assert rc == 0, outp
    assert "dispatch=coeff" in outp and "bit-exact" in outp
    assert "verify max-abs-err" in outp
    rc = cli.main(["run", "configs/tiny.cfg", "hmult", "8", "8", "4", "2",
                   "--dispatch", "gspmd", "--device", "cpu", "--verify",
                   "--iters", "1"])
    outp = capsys.readouterr().out
    assert rc == 0, outp
    assert "dispatch=gspmd -> limb" in outp and "bit-exact" in outp
    rc = cli.main(["run", "configs/tiny.cfg", "hmult", "8", "8", "4", "2",
                   "--dispatch", "hybrid", "--device", "cpu"])
    assert rc == 1 and "even cluster >= 4" in capsys.readouterr().err
    rc = cli.main(["run", "configs/tiny.cfg", "hmult", "8", "8", "4", "4",
                   "--dispatch", "coeff", "--device", "cpu"])
    assert rc == 1 and "per-shard tiles" in capsys.readouterr().err
