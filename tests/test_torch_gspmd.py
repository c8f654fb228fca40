"""The port's counterparts of the JAX package's GSPMD surface on the CPU
(the kernels' plain versions), bit for bit (tolerance 0), at n = 256,
maxLevel 8, alpha 4, level 8 (the engine of tests/test_sharding.py):

  * batched_hmult_fn against the JAX batched_hmult_fn;
  * make_sharded_hmult against the single-device hmult at each mesh shape
    of the JAX tests ((1,4), (2,4), (4,2), (8,1), (2,2,2), (1,2,4)), and
    against the JAX make_sharded_hmult at (2,2,2) on conftest's 8 virtual
    devices;
  * make_coeff_sharded_ntt against the JAX function (n = 1024, 4 rows, 8
    shards, forward then inverse);
  * make_mesh's axes and data rows;
  * hsquare on each key-switch dispatch (the ciphertext as both hmult
    operands) against hsquare_graph;
  * the elementwise ops over rows and over n2 against the single-device
    graphs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from homulator_tpu.api import CkksEngine as JaxEngine
from homulator_tpu.parallel import sharded as jax_sh
from homulator_tpu.parallel.coeff_ntt import (
    make_coeff_sharded_ntt as jax_coeff_ntt,
)
from homulator_tpu.parallel.mesh import make_mesh as jax_make_mesh
from homulator_tpu.params import get_params
from homulator_tpu_torch.api import (
    CkksEngine, hadd_graph, hmult_graph, hsquare_graph, hsub_graph,
    padd_graph, pmult_graph,
)
from homulator_tpu_torch.context import from_jax_state
from homulator_tpu_torch.parallel import limb_sharded as ls
from homulator_tpu_torch.parallel import sharded as sh
from homulator_tpu_torch.parallel.coeff_ntt import make_coeff_sharded_ntt
from homulator_tpu_torch.parallel.comm import ThreadMesh
from homulator_tpu_torch.parallel.mesh import make_mesh

SCALE = 2.0**29
LEVEL = 8


@pytest.fixture(scope="module")
def engines():
    """(JAX graph-route engine, port engine on the CPU), same seed and key
    order, so their keys are equal."""
    params = get_params(n=256, max_level=8, alpha=4)
    jeng = JaxEngine(params, seed=5, ntt_mode="jnp")
    eng = CkksEngine(params, seed=5, device="cpu")
    for e in (jeng, eng):
        e.keygen()
    return jeng, eng


def _batch(eng, B, seed):
    rng = np.random.default_rng(seed)
    return torch.stack([eng.encrypt_complex(rng.normal(size=128), LEVEL,
                                            SCALE).data for _ in range(B)])


def _u32(t):
    return t.numpy().view(np.uint32)


def test_batched_hmult_fn_matches_jax(engines):
    jeng, eng = engines
    rng = np.random.default_rng(1)
    ja, jb = (jnp.stack([jeng.encrypt_complex(rng.normal(size=128), LEVEL,
                                              SCALE).data for _ in range(3)])
              for _ in range(2))
    want = np.asarray(jax.jit(jax_sh.batched_hmult_fn(jeng.dc, LEVEL))(
        ja, jb, jeng.relin_key))
    t = from_jax_state({"a": np.asarray(ja), "b": np.asarray(jb),
                        "k": np.asarray(jeng.relin_key)}, eng.dc)
    got = sh.batched_hmult_fn(eng.dc, LEVEL)(t["a"], t["b"], t["k"])
    assert got.shape == (3, 2, LEVEL - 1, 16, 16)
    assert np.array_equal(_u32(got), want)


@pytest.mark.parametrize("shape", [(1, 4), (2, 4), (4, 2), (8, 1),
                                   (2, 2, 2), (1, 2, 4)])
def test_sharded_hmult_matches_single_device(engines, shape):
    """Each batch element == the single-device hmult; the shards received
    the limb (2 axes) or hybrid (3 axes) dispatch's bytes an element."""
    _, eng = engines
    mesh = make_mesh(shape, device="cpu")
    B = max(2, shape[0])
    a, b = _batch(eng, B, 1), _batch(eng, B, 2)
    got = sh.make_sharded_hmult(eng.dc, LEVEL, mesh)(a, b, eng.relin_key)
    kt = eng.dc.keyswitch_tables(LEVEL)
    want = torch.stack([hmult_graph(x, y, eng.relin_key, kt)
                        for x, y in zip(a, b)])
    assert torch.equal(got, want)
    p = eng.params
    per = (ls.ici_bytes_per_op_limb(p, LEVEL, shape[1]) if len(shape) == 2
           else ls.ici_bytes_per_op_hybrid(p, LEVEL, shape[1], shape[2]))
    assert mesh.recv_bytes == [B // shape[0] * per] * len(mesh.comms)


def test_sharded_hmult_matches_jax_gspmd(engines):
    """(2, 2, 2) on the conftest's 8 virtual devices: the port's explicit
    hybrid program == the JAX make_sharded_hmult under GSPMD."""
    jeng, eng = engines
    shape = (2, 2, 2)
    rng = np.random.default_rng(3)
    ja, jb = (jnp.stack([jeng.encrypt_complex(rng.normal(size=128), LEVEL,
                                              SCALE).data for _ in range(2)])
              for _ in range(2))
    jmesh = jax_make_mesh(shape=shape, n_devices=8)
    ct_shard = NamedSharding(jmesh, P("data", None, "limb", None, "coeff"))
    evk_shard = NamedSharding(jmesh, P(None, None, "limb", None, "coeff"))
    want = np.asarray(jax_sh.make_sharded_hmult(jeng.dc, LEVEL, jmesh)(
        jax.device_put(ja, ct_shard), jax.device_put(jb, ct_shard),
        jax.device_put(jeng.relin_key, evk_shard)))
    t = from_jax_state({"a": np.asarray(ja), "b": np.asarray(jb),
                        "k": np.asarray(jeng.relin_key)}, eng.dc)
    got = sh.make_sharded_hmult(eng.dc, LEVEL, make_mesh(shape, device="cpu"))(
        t["a"], t["b"], t["k"])
    assert np.array_equal(_u32(got), want)


def test_coeff_sharded_ntt_matches_jax():
    """n = 1024 (32 x 32 tiles), 4 rows, 8 shards (4 columns each, the
    per-limb phases): forward == the JAX function, inverse == the JAX
    inverse (x again)."""
    params = get_params(n=1024, max_level=4, alpha=2)
    jeng = JaxEngine(params, seed=6, ntt_mode="jnp")
    nb = jeng.dc.ntt_basis(jeng.dc.main_rows(4))
    n1, n2 = nb.n1, nb.n2
    jmesh = jax_make_mesh(shape=(1, 8), n_devices=8)
    jf, jfi = jax_coeff_ntt(nb, jmesh, axis="limb")
    rng = np.random.default_rng(3)
    x = np.stack([rng.integers(0, int(q), size=params.n, dtype=np.uint64)
                  for q in params.q_arr[:4]]).astype(np.uint32)
    tile = x.reshape(4, n1, n2)
    want = np.asarray(jf(jnp.asarray(tile)))
    jback = np.asarray(jfi(jnp.asarray(want)))

    eng = CkksEngine(params, seed=6, device="cpu")
    mesh = make_mesh((1, 8), device="cpu")
    f, fi = make_coeff_sharded_ntt(eng.dc, eng.dc.main_rows(4), mesh,
                                   axis="limb")
    xt = torch.from_numpy(tile.view(np.int32).copy())
    got = sh.gather_cols(f(sh.shard_cols(xt, 8)))
    assert np.array_equal(_u32(got), want)
    back = sh.gather_cols(fi(sh.shard_cols(got, 8)))
    assert np.array_equal(_u32(back), jback)
    assert torch.equal(back, xt)
    # one all_to_all a transform, 7/8 of each shard's 4 x 32 x 4 words
    assert mesh.calls() == [2] * 8
    assert mesh.recv_bytes == [2 * 4 * 32 * 4 * 4 * 7 // 8] * 8


@pytest.mark.parametrize("shape,names,size,data", [
    ((1, 4), ("limb",), 4, 1), ((2, 4), ("limb",), 4, 2),
    ((8, 1), ("limb",), 1, 8), ((2, 2, 2), ("limb", "coeff"), 4, 2),
    ((1, 2, 4), ("limb", "coeff"), 8, 1)])
def test_make_mesh_axes(shape, names, size, data):
    """The JAX default names, the leading "data" extent as data rows."""
    mesh = make_mesh(shape, device="cpu")
    assert isinstance(mesh, ThreadMesh)
    assert (mesh.names, mesh.size, mesh.data) == (names, size, data)
    assert mesh.shape == tuple(shape[1:])
    assert len(mesh.comms) == size * data


def test_make_mesh_arguments():
    mesh = make_mesh(n_devices=4, device="cpu")  # JAX default (1, n)
    assert (mesh.names, mesh.size, mesh.data) == (("limb",), 4, 1)
    mesh = make_mesh((2, 4), axis_names=("limb", "coeff"), device="cpu")
    assert (mesh.names, mesh.shape, mesh.data) == (("limb", "coeff"),
                                                   (2, 4), 1)
    with pytest.raises(ValueError, match="does not hold"):
        make_mesh((2, 4), n_devices=4, device="cpu")
    with pytest.raises(ValueError, match="axis names"):
        make_mesh((2, 4), axis_names=("data",), device="cpu")


@pytest.mark.parametrize("dispatch", ["limb", "coeff", "hybrid"])
def test_hsquare_on_the_hmult_dispatch(engines, dispatch):
    """hmult's dispatch with the ciphertext as both operands == the
    single-device hsquare_graph: every residue is canonical, so the
    cross term a0*a1 + a1*a0 is 2*a0*a1 mod q, as hsquare computes it."""
    _, eng = engines
    a = _batch(eng, 1, 7)[0]
    want = hsquare_graph(a, eng.relin_key, eng.dc.keyswitch_tables(LEVEL))
    assert torch.equal(want, hmult_graph(a, a, eng.relin_key,
                                         eng.dc.keyswitch_tables(LEVEL)))
    if dispatch == "coeff":
        mesh = ThreadMesh(2, "cpu")
        f = sh.make_shardmap_hmult(eng.dc, LEVEL, mesh)
        s = sh.shard_cols(a, 2)
        got = sh.gather_cols(f(s, s, sh.shard_cols(eng.relin_key, 2)))
    else:
        ns_l, ns_c = (4, 1) if dispatch == "limb" else (2, 2)
        mesh = (ThreadMesh(4, "cpu", names=("limb",)) if dispatch == "limb"
                else ThreadMesh((2, 2), "cpu", names=("limb", "coeff")))
        make = (ls.make_limb_hmult if dispatch == "limb"
                else ls.make_hybrid_hmult)
        s = ls.shard_rows(a, LEVEL, ns_l, ns_c)
        got = ls.gather_rows(make(eng.dc, LEVEL, mesh)(
            s, s, ls.limb_key(eng.relin_key, eng.params, LEVEL, ns_l, ns_c)),
            ns_l, ns_c)[:, :LEVEL - 1]
    assert torch.equal(got, want)


@pytest.mark.parametrize("level,ns,axis", [(8, 4, -3), (6, 4, -2),
                                           (5, 3, -2)])
def test_sharded_elementwise(engines, level, ns, axis):
    """hadd, hsub, padd and pmult over ns shards, the JAX CLI's layout
    (rows where ns divides level, else n2, unevenly where ns does not
    divide n2) == the single-device graphs; no shard receives a byte."""
    _, eng = engines
    assert sh.elementwise_axis(level, ns) == axis
    rng = np.random.default_rng(level)
    a, b = (eng.encrypt_complex(rng.normal(size=128), level, SCALE).data
            for _ in range(2))
    pt = eng.plaintext_complex(rng.normal(size=128), level, SCALE).data
    q = eng.dc.q_level(level)
    mesh = ThreadMesh(ns, "cpu")
    for op, graph, other in (("hadd", hadd_graph, b), ("hsub", hsub_graph, b),
                             ("padd", padd_graph, pt),
                             ("pmult", pmult_graph, pt)):
        f = sh.make_sharded_elementwise(eng.dc, op, level, mesh)
        parts = f(sh.shard_elementwise(a, axis, ns),
                  sh.shard_elementwise(other, axis, ns))
        assert torch.equal(torch.cat(parts, dim=axis), graph(a, other, q)), op
    assert mesh.recv_bytes == [0] * ns
