"""The port's hybrid (limb x coeff) hmult and hrotate
(parallel/limb_sharded.py::make_hybrid_*) on the CPU (the kernels' plain
versions), bit for bit (tolerance 0), at n = 256, maxLevel 8, alpha 4:

  * vs the JAX package's make_hybrid_hmult on a 2 x 2 mesh of the
    conftest's CPU devices in interpret mode, with the JAX engine's keys
    and ciphertexts carried across (from_jax_state);
  * vs the port's single-device ops on ThreadMesh((ns_l, ns_c), "cpu",
    names=("limb", "coeff")) at 2 x 2 and 4 x 2, hrotate on the identity,
    the shard-permutation and the gather route of the automorphism, and a
    data x limb x coeff batch, also vs the JAX data-axis program, one
    program a shard (one element's collective and kernel-wrapper calls);
  * in four processes through torch.distributed (gloo, DistMesh.grid
    over dist.new_group subgroups);
  * the exchanged bytes vs ici_bytes_per_op_hybrid and the limb axis's
    collective calls vs limb_collective_count;
  * the gather depth at the columns a hybrid shard holds, where the port
    deliberately differs from the JAX `_pick_gchunks`.
"""

import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homulator_tpu.api import CkksEngine as JaxEngine
from homulator_tpu.parallel import limb_sharded as jax_ls
from homulator_tpu.parallel.mesh import make_mesh
from homulator_tpu.params import get_params
from homulator_tpu_torch.api import CkksEngine, hmult_graph, hrotate_graph
from homulator_tpu_torch.context import from_jax_state
from homulator_tpu_torch.parallel import limb_sharded as ls
from homulator_tpu_torch.parallel.comm import ThreadMesh

from .test_torch_limb_shard import _kernel_calls

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 2.0**29
STEP = 3
LEVEL = 8
# a hybrid hmult's transform calls, each one all_to_all in the coeff
# group: ModUp iNTT, the digits' NTTs (one rep = beta launch), the tail's
# iNTT and NTT (rep 2 each); hrotate's ModDown likewise
TRANSFORM_CALLS = 4


@pytest.fixture(scope="module")
def engines():
    params = get_params(n=256, max_level=8, alpha=4)
    jeng = JaxEngine(params, seed=5, ntt_mode="interpret")
    eng = CkksEngine(params, seed=5, device="cpu")
    for e in (jeng, eng):
        e.keygen()
        e.gen_rotation_key(STEP)
    return jeng, eng


def _mesh(shape, **kw):
    return ThreadMesh(shape, "cpu", timeout=60, names=("limb", "coeff"),
                      **kw)


def _check_counts(mesh, p, level, ns_l, ns_c, op, ident=False, autos=0):
    """Bytes = ici_bytes_per_op_hybrid; limb-axis calls =
    limb_collective_count at the hybrid's width; coeff-axis calls = one a
    transform call plus the automorphism's."""
    n = len(mesh.comms)
    assert mesh.recv_bytes == [ls.ici_bytes_per_op_hybrid(
        p, level, ns_l, ns_c, op, route_identity=ident)] * n
    assert mesh.calls("limb") == [ls.limb_collective_count(
        p, level, ns_l, op, ns_c=ns_c)] * n
    assert mesh.calls("coeff") == [TRANSFORM_CALLS + autos] * n


def test_hybrid_hmult_matches_jax(engines):
    """2 limb x 2 coeff: the port's hybrid hmult == the JAX
    make_hybrid_hmult on every padded row."""
    jeng, eng = engines
    rng = np.random.default_rng(21)
    ja, jb = (jeng.encrypt_complex(rng.normal(size=128), LEVEL, SCALE)
              for _ in range(2))
    mesh = make_mesh(shape=(2, 2), n_devices=4, axis_names=("limb", "coeff"))
    order = jnp.asarray(jax_ls.evk_limb_row_order(jeng.params, LEVEL, 2))
    want = np.asarray(jax_ls.make_hybrid_hmult(jeng.dc, LEVEL, mesh)(
        jax_ls.pad_main_rows(ja.data, LEVEL, 2),
        jax_ls.pad_main_rows(jb.data, LEVEL, 2),
        jnp.take(jeng.relin_key, order, axis=2)))
    t = from_jax_state({"a": np.asarray(ja.data), "b": np.asarray(jb.data),
                        "k": np.asarray(jeng.relin_key)}, eng.dc)
    tmesh = _mesh((2, 2))
    got = ls.gather_rows(ls.make_hybrid_hmult(eng.dc, LEVEL, tmesh)(
        ls.shard_rows(t["a"], LEVEL, 2, 2), ls.shard_rows(t["b"], LEVEL, 2, 2),
        ls.limb_key(t["k"], eng.params, LEVEL, 2, 2)), 2, 2)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    _check_counts(tmesh, eng.params, LEVEL, 2, 2, "hmult")


@pytest.mark.parametrize("shape,level", [((2, 2), 8), ((4, 2), 8),
                                         ((4, 2), 7), ((2, 2), 5)],
                         ids=["2x2-8", "4x2-8", "4x2-7", "2x2-5"])
def test_hybrid_hmult_matches_single_device(engines, shape, level):
    """Real rows == the single-device hmult, pad rows zero (levels 7 and 5
    leave pad rows)."""
    _, eng = engines
    ns_l, ns_c = shape
    rng = np.random.default_rng(level * ns_l)
    a, b = (eng.encrypt_complex(rng.normal(size=128), level, SCALE)
            for _ in range(2))
    mesh = _mesh(shape)
    got = ls.gather_rows(ls.make_hybrid_hmult(eng.dc, level, mesh)(
        ls.shard_rows(a.data, level, ns_l, ns_c),
        ls.shard_rows(b.data, level, ns_l, ns_c),
        ls.limb_key(eng.relin_key, eng.params, level, ns_l, ns_c)),
        ns_l, ns_c)
    assert torch.equal(got[:, :level - 1], eng.hmult(a, b).data)
    assert not got[:, level - 1:].any(), "pad rows must be zero"
    _check_counts(mesh, eng.params, level, ns_l, ns_c, "hmult")


@pytest.mark.parametrize("shape", [(2, 2), (4, 2)], ids=["2x2", "4x2"])
@pytest.mark.parametrize("route", ["identity", "ppermute", "gather"])
def test_hybrid_hrotate_matches_single_device(engines, shape, route):
    """The automorphism in the coeff group on each route: rotation by 3
    (its 2-shard block map is the identity: no exchange), conjugation
    (the two blocks swap: one ppermute a component) and the gather
    sentinel (an all_gather a component), at level 7 (pad rows)."""
    _, eng = engines
    ns_l, ns_c = shape
    level = 7
    p = eng.params
    g = p.galois_conj if route == "ppermute" else p.galois_elt(STEP)
    key = (eng.dc.upload_kskey_mont(eng.ref._gen_galois_key(g).digits)
           if route == "ppermute" else eng.rot_keys[STEP])
    rt = eng.dc.automorph_shard_route(g, ns_c)
    assert rt[2] == (route != "ppermute")  # rotations: identity at 2
    if route == "gather":
        rt = (eng.dc.automorph_perm(g), None, False)
    a = eng.encrypt_complex(np.random.default_rng(ns_l).normal(size=128),
                            level, SCALE)
    mesh = _mesh(shape)
    got = ls.gather_rows(ls.make_hybrid_hrotate(eng.dc, level, mesh)(
        ls.shard_rows(a.data, level, ns_l, ns_c), rt,
        ls.limb_key(key, p, level, ns_l, ns_c)), ns_l, ns_c)
    want = hrotate_graph(a.data, eng.dc.automorph_perm(g), key,
                         eng.dc.keyswitch_tables(level))
    assert torch.equal(got[:, :level], want)
    assert not got[:, level:].any(), "pad rows must be zero"
    _check_counts(mesh, p, level, ns_l, ns_c, "hrotate",
                  ident=route == "identity",
                  autos=0 if route == "identity" else 2)


def test_hybrid_hmult_data_axis(engines):
    """A batch of 4 hmults on 2 data rows x (2 limb x 2 coeff) == the
    single-device hmults and the JAX data-axis program (its vmap inside
    shard_map) on every padded row; each shard runs its 2 elements as one
    program: one element's collective calls on each axis and kernel calls
    (one hmult on a 1-row mesh), its 2 elements' bytes."""
    jeng, eng = engines
    d = 2
    rng = np.random.default_rng(31)
    a, b = (torch.stack([eng.encrypt_complex(rng.normal(size=128), LEVEL,
                                             SCALE).data for _ in range(4)])
            for _ in range(2))
    key = ls.limb_key(eng.relin_key, eng.params, LEVEL, 2, 2)
    mesh = _mesh((2, 2), data=d)
    f = ls.make_hybrid_hmult(eng.dc, LEVEL, mesh, data_axis="data")
    out, calls = _kernel_calls(lambda: f(
        ls.shard_rows(a, LEVEL, 2, 2, data=d),
        ls.shard_rows(b, LEVEL, 2, 2, data=d), key))
    got = ls.gather_rows(out, 2, 2, data=d)
    params, dc = eng.params, eng.dc
    kt = dc.keyswitch_tables(LEVEL)
    want = torch.stack([hmult_graph(x, y, eng.relin_key, kt)
                        for x, y in zip(a, b)])
    assert torch.equal(got[:, :, :LEVEL - 1], want)
    assert not got[:, :, LEVEL - 1:].any()
    jmesh = make_mesh(shape=(d, 2, 2), n_devices=8,
                      axis_names=("data", "limb", "coeff"))
    order = jnp.asarray(jax_ls.evk_limb_row_order(jeng.params, LEVEL, 2))
    jax_out = jax_ls.make_hybrid_hmult(jeng.dc, LEVEL, jmesh,
                                       data_axis="data")(
        *(jax_ls.pad_main_rows(jnp.asarray(x.numpy().view(np.uint32)),
                               LEVEL, 2) for x in (a, b)),
        jnp.take(jeng.relin_key, order, axis=2))
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(jax_out))
    assert mesh.recv_bytes == [2 * ls.ici_bytes_per_op_hybrid(
        params, LEVEL, 2, 2, "hmult")] * 8
    assert mesh.calls("limb") == [ls.limb_collective_count(
        params, LEVEL, 2, "hmult", ns_c=2)] * 8
    assert mesh.calls("coeff") == [TRANSFORM_CALLS] * 8
    one = _mesh((2, 2))
    _, one_calls = _kernel_calls(lambda: ls.make_hybrid_hmult(
        dc, LEVEL, one)(ls.shard_rows(a[0], LEVEL, 2, 2),
                        ls.shard_rows(b[0], LEVEL, 2, 2), key))
    for axis in ("limb", "coeff"):
        assert mesh.calls(axis) == one.calls(axis) * d
    assert len(set(one_calls.values())) == 1
    assert len(calls) == 8
    assert set(calls.values()) == set(one_calls.values())


def test_pick_gchunks_at_the_shards_width():
    """The first latent gate bug: the JAX `_pick_gchunks(n1, n2)` checks
    the full n2 on a hybrid mesh too. At n = 256 (16 x 16 tiles) on 2
    coeff shards it picks G = 2, chunks of 8 x 8 = 64 coefficients, below
    its own 128-lane gate; the port's pick_gchunks at the 8 columns a
    shard holds picks 1. At the limb mesh's full width, and at set B's
    hybrid widths, the two agree everywhere."""
    assert jax_ls._pick_gchunks(16, 16) == 2
    assert ls.pick_gchunks(16, 16 // 2) == 1
    p = get_params(n=256, max_level=8, alpha=4)
    assert ls.limb_collective_count(p, 8, 2, ns_c=2) == 2
    assert jax_ls.limb_collective_count(p, 8, 2) == 4
    for n1 in (4, 8, 16, 32, 64, 128, 256, 512):
        for n2 in (n1 // 2, n1, 2 * n1):
            assert ls.pick_gchunks(n1, n2) == jax_ls._pick_gchunks(n1, n2)
    for ns_c in (2, 4):
        assert ls.pick_gchunks(256, 256 // ns_c) == \
            jax_ls._pick_gchunks(256, 256) == 4
    # the shard's tables carry the depth it runs at
    eng = CkksEngine(p, seed=5, device="cpu")
    assert ls.build_limb_tables(eng.dc, 8, 2, 0, (0, 2)).gchunks == 1
    assert ls.build_limb_tables(eng.dc, 8, 2, 0).gchunks == 2


_DIST_WORKER = r"""
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
g = eng.params.galois_conj
ckey = eng.dc.upload_kskey_mont(eng.ref._gen_galois_key(g).digits)
rng = np.random.default_rng(9)
a, b = (eng.encrypt_complex(rng.normal(size=128), 7, 2.0**29)
        for _ in range(2))
mesh = DistMesh.grid((2, 2), ("limb", "coeff"))
mine = lambda parts: {rank: parts[rank]}
res = {"index": mesh.index}
res["hmult"] = ls.make_hybrid_hmult(eng.dc, 7, mesh)(
    mine(ls.shard_rows(a.data, 7, 2, 2)), mine(ls.shard_rows(b.data, 7, 2, 2)),
    mine(ls.limb_key(eng.relin_key, eng.params, 7, 2, 2)))[0]
res["hmult_bytes"] = mesh.total_recv_bytes
res["calls"] = (mesh.axis("limb").calls, mesh.axis("coeff").calls)
mesh.reset_counts()
res["conj"] = ls.make_hybrid_hrotate(eng.dc, 7, mesh)(
    mine(ls.shard_rows(a.data, 7, 2, 2)), eng.dc.automorph_shard_route(g, 2),
    mine(ls.limb_key(ckey, eng.params, 7, 2, 2)))[0]
res["conj_bytes"] = mesh.total_recv_bytes
torch.save(res, out)
dist.destroy_process_group()
"""


def test_dist_mesh_gloo_four_processes(engines, tmp_path):
    """A 2 x 2 hybrid hmult and conjugation at level 7 in 4 CPU processes
    (gloo), each a DistMesh.grid shard with its limb and coeff Comms over
    dist.new_group subgroups: each shard's block equals the single-device
    result's, and its bytes and calls the hybrid counts."""
    _, eng = engines
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT)
    outs = [tmp_path / f"rank{r}.pt" for r in range(4)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DIST_WORKER, str(r), str(port), str(outs[r])],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(4)]
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
    g = ref.params.galois_conj
    ref._conj_keys[g] = ref.dc.upload_kskey_mont(
        ref.ref._gen_galois_key(g).digits)
    rng = np.random.default_rng(9)
    a, b = (ref.encrypt_complex(rng.normal(size=128), 7, SCALE)
            for _ in range(2))
    hm, cj = ref.hmult(a, b).data, ref.conjugate(a).data
    p = ref.params
    for r in range(4):
        res = torch.load(outs[r])
        assert res["index"] == r
        got = {"hmult": res["hmult"], "conj": res["conj"]}
        for name, full, rows in (("hmult", hm, 6), ("conj", cj, 7)):
            padded = torch.cat([full, full.new_zeros(
                (2, 8 - rows) + full.shape[2:])], dim=1)
            assert torch.equal(got[name], ls.shard_rows(
                padded, 8, 2, 2)[r]), (r, name)
        assert res["hmult_bytes"] == ls.ici_bytes_per_op_hybrid(
            p, 7, 2, 2, "hmult")
        assert res["conj_bytes"] == ls.ici_bytes_per_op_hybrid(
            p, 7, 2, 2, "hrotate")
        assert res["calls"] == (ls.limb_collective_count(p, 7, 2, ns_c=2),
                                TRANSFORM_CALLS)
