"""The lane-packed route of the port's coefficient-sharded dispatch (the
JAX package's default at c = n/ns <= 32 columns), on the CPU (the kernels'
plain versions), bit for bit (tolerance 0):

  * pack_limb_lanes / unpack_limb_lanes / _pack_pad vs the JAX functions;
  * the plain versions of the packed phase kernels B10-B13 vs the JAX
    package's `*_packed_pallas` in interpret mode, with the JAX basis's
    packed tables, at n = 4096 (n1 = n2 = 64), (c, k) = (32, 4) and (16, 8),
    5 rows (padded to a multiple of k), on rank 0's and the last rank's
    column slice;
  * the packed sharded ntt_rep / intt_rep on a ThreadMesh of 2, 4 and 8
    shards vs the single-device transform, rep = 2, M = 1 and 15;
  * packed make_shardmap_hmult / make_shardmap_hrotate at n = 4096 on 4
    and 8 shards vs the single-device ops and the packed=False route, with
    the bytes each shard received vs the JAX `ici_bytes_per_op`;
  * the batch axis: make_shardmap_hmult(data_axis="data") on a 2 x 4
    ThreadMesh vs the JAX one on the conftest's 8 virtual CPU devices,
    one program a shard (one element's collective and kernel-wrapper
    calls, B/d elements' bytes), lane-packed on 2 x 8 shards at n = 4096,
    and on 2 x 2 DistMesh processes (gloo) vs the single-device op;
  * the set-B exchange bytes of both routes at 8, 16 and 32 shards.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homulator_tpu.api import CkksEngine as JaxEngine
from homulator_tpu.context import DeviceContext as JaxContext
from homulator_tpu.ops.ntt import _pack_pad as jax_pack_pad
from homulator_tpu.ops.ntt_pallas import (
    intt_phase1_packed_pallas, intt_phase2_packed_pallas,
    ntt_phase1_packed_pallas, ntt_phase2_packed_pallas,
    pack_limb_lanes as jax_pack, unpack_limb_lanes as jax_unpack,
)
from homulator_tpu.parallel.mesh import make_mesh
from homulator_tpu.parallel.sharded import (
    ici_bytes_per_op as jax_ici_bytes, make_shardmap_hmult as jax_hmult,
)
from homulator_tpu.params import get_params
from homulator_tpu_torch.api import CkksEngine
from homulator_tpu_torch.context import DeviceContext, from_jax_state
from homulator_tpu_torch.ops.ntt import (
    _pack_pad, intt_phase1_packed, intt_phase2_packed, intt_rep,
    ntt_phase1_packed, ntt_phase2_packed, ntt_rep, pack_limb_lanes,
    unpack_limb_lanes,
)
from homulator_tpu_torch.parallel.comm import ThreadMesh
from homulator_tpu_torch.parallel.sharded import (
    gather_batch, gather_cols, ici_bytes_per_op, make_shardmap_hmult,
    make_shardmap_hrotate, shard_batch, shard_cols,
)

from .test_torch_limb_shard import _kernel_calls

ROWS = (9, 0, 2, 3, 4)  # a special prime first; 5 rows pad at k = 4 and 8
PHASES = ("ntt1", "ntt2", "intt2", "intt1")  # B10, B11, B12, B13
SCALE = 2.0**29


def _u32(t):
    return t.numpy().view(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _residues(q, shape, seed):
    q = np.asarray(q, dtype=np.int64)
    return np.random.default_rng(seed).integers(
        0, q.reshape((-1,) + (1,) * len(shape)), size=(len(q),) + shape,
        dtype=np.int64).astype(np.uint32)


@pytest.mark.parametrize("k", [2, 4, 8, 16])
def test_pack_helpers_match_jax(k):
    """Packing, unpacking and the last-row padding equal the JAX ones."""
    x = np.random.default_rng(k).integers(0, 2**30, size=(3 * k, 8, 4),
                                          dtype=np.int64).astype(np.uint32)
    packed = pack_limb_lanes(_t(x), k)
    assert np.array_equal(_u32(packed), np.asarray(jax_pack(jnp.asarray(x),
                                                            k)))
    assert torch.equal(unpack_limb_lanes(packed, k, 4), _t(x))
    assert np.array_equal(_u32(unpack_limb_lanes(packed, k, 4)), np.asarray(
        jax_unpack(jax_pack(jnp.asarray(x), k), k, 4)))
    for m in (1, k - 1, k + 1):
        want = np.asarray(jax_pack_pad(jnp.asarray(x[:m]), k))
        assert np.array_equal(_u32(_pack_pad(_t(x[:m]), k)), want)
    # rep copies pad one by one, as the JAX package's per-copy calls do
    m = k + 1
    both = np.concatenate([x[:m], x[m:2 * m]])
    want = np.concatenate([np.asarray(jax_pack_pad(jnp.asarray(c), k))
                           for c in (x[:m], x[m:2 * m])])
    assert np.array_equal(_u32(_pack_pad(_t(both), k, rep=2)), want)


@pytest.fixture(scope="module")
def ctx4096():
    p = get_params(n=4096, max_level=8, alpha=2)
    return p, JaxContext(p, ntt_mode="interpret"), DeviceContext(p, "cpu")


@pytest.mark.parametrize("last", [False, True], ids=["rank0", "last_rank"])
@pytest.mark.parametrize("c,k", [(32, 4), (16, 8)])
@pytest.mark.parametrize("phase", PHASES)
def test_packed_plain_matches_pallas(ctx4096, phase, c, k, last):
    """Each packed plain phase == the JAX packed kernel on the same padded,
    packed input, with the JAX basis's packed tables for that rank."""
    p, jdc, dc = ctx4096
    n1, n2 = p.ntt.n1, p.ntt.n2
    ns = n2 // c
    rank = ns - 1 if last else 0
    jnb = jdc.ntt_basis(ROWS, shard_axis="coeff", pack_ns=ns)
    nb = dc.ntt_basis(ROWS, shard=(rank, ns), packed=True)
    assert nb.pack == k and nb.shard == (rank, ns)
    x = _residues(p.q_arr[list(ROWS)], (n1, c),
                  seed=PHASES.index(phase) * 64 + ns * 2 + last)
    jx = jax_pack_pad(jnp.asarray(x), k)
    tx = _pack_pad(_t(x), k)
    assert np.array_equal(_u32(tx), np.asarray(jx))
    if phase in ("ntt1", "ntt2"):
        qrow, p1p, p1sp, midp, midsp, p2p, p2sp = jnb.pfwd_packed
    else:
        qrow, ip2p, ip2sp, midip, midisp, ip1p, ip1sp = jnb.pinv_packed
    if phase == "ntt1":
        want = ntt_phase1_packed_pallas(jx, qrow, p1p, p1sp, midp[rank],
                                        midsp[rank], n1=n1, interpret=True)
        got = ntt_phase1_packed(tx, nb)
    elif phase == "ntt2":
        want = ntt_phase2_packed_pallas(jx, qrow, p2p, p2sp, n2=n2,
                                        interpret=True)
        got = ntt_phase2_packed(tx, nb)
    elif phase == "intt2":
        want = intt_phase2_packed_pallas(jx, qrow, ip2p, ip2sp, n2=n2,
                                         interpret=True)
        got = intt_phase2_packed(tx, nb)
    else:
        want = intt_phase1_packed_pallas(jx, qrow, midip[rank], midisp[rank],
                                         ip1p, ip1sp, n1=n1, interpret=True)
        got = intt_phase1_packed(tx, nb)
    assert got.dtype == torch.int32 and got.shape == tx.shape
    assert np.array_equal(_u32(got), np.asarray(want))


@pytest.mark.parametrize("M", [1, 15])
@pytest.mark.parametrize("ns", [2, 4, 8])
def test_packed_sharded_transform_matches_single_device(ns, M):
    """Packed ntt_rep / intt_rep at rep = 2 gather to the single-device
    transform and invert each other; each copy's rows pad on their own, so
    each shard receives ceil(M/k)*k rows a copy a transform."""
    p = get_params(n=4096, max_level=14, alpha=2)
    dc = DeviceContext(p, "cpu")
    rows = tuple(range(M))
    k = 128 // (p.ntt.n2 // ns)
    full = dc.ntt_basis(rows)
    nbs = [dc.ntt_basis(rows, shard=(r, ns), packed=True) for r in range(ns)]
    assert all(nb.pack == k for nb in nbs)
    mesh = ThreadMesh(ns, "cpu", timeout=60)
    x = _t(_residues(np.tile(p.q_arr[:M], 2), (p.ntt.n1, p.ntt.n2),
                     seed=ns * 16 + M))
    xs = shard_cols(x, ns)
    ev = mesh.run(lambda comm: ntt_rep(xs[comm.rank], nbs[comm.rank], 2))
    assert torch.equal(gather_cols(ev), ntt_rep(x, full, 2))
    back = mesh.run(lambda comm: intt_rep(ev[comm.rank], nbs[comm.rank], 2))
    assert torch.equal(gather_cols(back), x)
    per_row = (ns - 1) * p.n * 4 // (ns * ns)
    assert mesh.recv_bytes == [2 * 2 * -(-M // k) * k * per_row] * ns


@pytest.fixture(scope="module")
def engine4096():
    eng = CkksEngine(get_params(n=4096, max_level=4, alpha=2), seed=11,
                     device="cpu")
    eng.keygen()
    eng.gen_rotation_key(1)
    return eng


@pytest.mark.parametrize("op", ["hmult", "hrotate"])
@pytest.mark.parametrize("ns", [4, 8])
def test_packed_shardmap_ops(engine4096, ns, op):
    """The default (packed) route == the single-device op == the
    packed=False route; each shard receives the JAX ici_bytes_per_op at
    its default routing (the rows of every call padded to a multiple of k
    per copy, the hmult tail's one-limb iNTT included)."""
    eng = engine4096
    p, level = eng.params, 4
    rng = np.random.default_rng(ns)
    a, b = (eng.encrypt_complex(rng.normal(size=p.n // 2), level, SCALE)
            for _ in range(2))
    mesh = ThreadMesh(ns, "cpu", timeout=120)
    outs = {}
    for packed in (True, False):
        mesh.reset_counts()
        if op == "hmult":
            f = make_shardmap_hmult(eng.dc, level, mesh, packed=packed)
            outs[packed] = gather_cols(f(shard_cols(a.data, ns),
                                         shard_cols(b.data, ns),
                                         shard_cols(eng.relin_key, ns)))
            ident = False
        else:
            route = eng.dc.automorph_shard_route(p.galois_elt(1), ns)
            f = make_shardmap_hrotate(eng.dc, level, mesh, packed=packed)
            outs[packed] = gather_cols(f(shard_cols(a.data, ns), route,
                                         shard_cols(eng.rot_keys[1], ns)))
            ident = route[2]
        jp = get_params(n=4096, max_level=4, alpha=2)
        want = jax_ici_bytes(jp, level, ns, op, route_identity=ident,
                             **({} if packed else {"packed": False}))
        assert mesh.recv_bytes == [want] * ns, packed
    assert jax_ici_bytes(jp, level, ns, op, route_identity=ident) > \
        jax_ici_bytes(jp, level, ns, op, route_identity=ident, packed=False)
    single = eng.hmult(a, b) if op == "hmult" else eng.hrotate(a, 1)
    assert torch.equal(outs[True], single.data)
    assert torch.equal(outs[False], single.data)


def test_data_axis_matches_jax():
    """2 data rows x 4 coefficient shards, B = 4 at n = 256, level 8: the
    port's batched make_shardmap_hmult == the JAX one on a (2, 4) mesh of
    the conftest's virtual CPU devices; each shard runs its 2 elements as
    one program: one element's collective and kernel calls (one hmult on
    a 1-row mesh), its 2 elements' bytes."""
    params = get_params(n=256, max_level=8, alpha=4)
    jeng = JaxEngine(params, seed=5, ntt_mode="interpret")
    eng = CkksEngine(params, seed=5, device="cpu")
    for e in (jeng, eng):
        e.keygen()
    level, B, d, ns = 8, 4, 2, 4
    rng = np.random.default_rng(13)
    ab, bb = (jnp.stack([jeng.encrypt_complex(rng.normal(size=128), level,
                                              SCALE).data
                         for _ in range(B)]) for _ in range(2))
    mesh = make_mesh(shape=(d, ns), n_devices=8,
                     axis_names=("data", "coeff"))
    want = np.asarray(jax_hmult(jeng.dc, level, mesh, data_axis="data")(
        ab, bb, jeng.relin_key))
    t = from_jax_state({"a": np.asarray(ab), "b": np.asarray(bb),
                        "k": np.asarray(jeng.relin_key)}, eng.dc)
    assert torch.equal(t["k"], eng.relin_key)
    key = shard_cols(eng.relin_key, ns)
    tmesh = ThreadMesh(ns, "cpu", timeout=60, data=d)
    f = make_shardmap_hmult(eng.dc, level, tmesh, data_axis="data")
    out, calls = _kernel_calls(lambda: f(
        shard_batch(t["a"], d, ns), shard_batch(t["b"], d, ns), key))
    assert np.array_equal(_u32(gather_batch(out, d)), want)
    assert tmesh.recv_bytes == [B // d * ici_bytes_per_op(
        params, level, ns, "hmult")] * (d * ns)
    one = ThreadMesh(ns, "cpu", timeout=60)
    single, one_calls = _kernel_calls(lambda: make_shardmap_hmult(
        eng.dc, level, one)(shard_cols(t["a"][0], ns),
                            shard_cols(t["b"][0], ns), key))
    assert np.array_equal(_u32(gather_cols(single)), want[0])
    # one all_to_all a transform: the ModUp iNTT, the beta digit NTTs and
    # the tail's three (both keys in each)
    assert one.calls() == [1 + params.beta(level) + 3] * ns
    assert tmesh.calls() == one.calls() * d
    assert len(set(one_calls.values())) == 1
    assert len(calls) == d * ns
    assert set(calls.values()) == set(one_calls.values())
    with pytest.raises(ValueError, match="data_axis"):
        make_shardmap_hmult(eng.dc, level, tmesh)


def test_packed_data_axis(engine4096):
    """The lane-packed route with a batch: 2 data rows x 8 shards (k = 4),
    B = 4 at n = 4096, level 4, == the single-device hmults; each rep copy
    of a batched transform pads to a multiple of k on its own, so a shard
    receives exactly 2 x ici_bytes_per_op bytes in one element's calls."""
    eng = engine4096
    p, level, B, d, ns = eng.params, 4, 4, 2, 8
    rng = np.random.default_rng(17)
    a, b = ([eng.encrypt_complex(rng.normal(size=p.n // 2), level, SCALE)
             for _ in range(B)] for _ in range(2))
    mesh = ThreadMesh(ns, "cpu", timeout=120, data=d)
    f = make_shardmap_hmult(eng.dc, level, mesh, data_axis="data")
    out, calls = _kernel_calls(lambda: f(
        *(shard_batch(torch.stack([x.data for x in v]), d, ns)
          for v in (a, b)), shard_cols(eng.relin_key, ns)))
    want = torch.stack([eng.hmult(x, y).data for x, y in zip(a, b)])
    assert torch.equal(gather_batch(out, d), want)
    assert mesh.recv_bytes == [B // d * ici_bytes_per_op(
        p, level, ns, "hmult")] * (d * ns)
    assert mesh.calls() == [1 + p.beta(level) + 3] * (d * ns)
    one = ThreadMesh(ns, "cpu", timeout=120)
    _, one_calls = _kernel_calls(lambda: make_shardmap_hmult(
        eng.dc, level, one)(shard_cols(a[0].data, ns),
                            shard_cols(b[0].data, ns),
                            shard_cols(eng.relin_key, ns)))
    assert mesh.calls() == one.calls() * d
    assert len(calls) == d * ns
    assert set(calls.values()) == set(one_calls.values())


@pytest.mark.parametrize("ns,k,bytes_", [
    (8, 4, (7684096, 9748480, 7168000, 9461760)),
    (16, 8, (4546560, 5447680, 3840000, 4986880)),
    (32, 16, (2793472, 3112960, 1984000, 2557440)),
])
def test_set_b_exchange_bytes(ns, k, bytes_):
    """Per-shard bytes of hmult and hrotate at set B, level 35: packed
    (the default) and packed=False, equal to the JAX function's."""
    from homulator_tpu_torch.parallel.mesh import pack_k_for

    p = get_params(n=1 << 16, max_level=45, alpha=15)
    assert pack_k_for(p.ntt.n1, p.ntt.n2, ns) == k
    got = (ici_bytes_per_op(p, 35, ns, "hmult"),
           ici_bytes_per_op(p, 35, ns, "hrotate"),
           ici_bytes_per_op(p, 35, ns, "hmult", packed=False),
           ici_bytes_per_op(p, 35, ns, "hrotate", packed=False))
    assert got == bytes_
    assert got == (jax_ici_bytes(p, 35, ns, "hmult"),
                   jax_ici_bytes(p, 35, ns, "hrotate"),
                   jax_ici_bytes(p, 35, ns, "hmult", packed=False),
                   jax_ici_bytes(p, 35, ns, "hrotate", packed=False))


_DIST_DATA_WORKER = r"""
import sys
import numpy as np, torch, torch.distributed as dist
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=4)
rows = [dist.new_group([0, 1]), dist.new_group([2, 3])]
from homulator_tpu_torch.api import CkksEngine, get_params
from homulator_tpu_torch.parallel.comm import DistMesh
from homulator_tpu_torch.parallel.sharded import (
    make_shardmap_hmult, shard_batch, shard_cols)
eng = CkksEngine(get_params(n=256, max_level=8, alpha=4), seed=5,
                 device="cpu")
eng.keygen()
rng = np.random.default_rng(9)
a, b = (torch.stack([eng.encrypt_complex(rng.normal(size=128), 8,
                                         2.0**29).data for _ in range(4)])
        for _ in range(2))
mesh = DistMesh(rows[rank // 2], row=rank // 2, data=2)
i = mesh.index
f = make_shardmap_hmult(eng.dc, 8, mesh, data_axis="data")
res = f({i: shard_batch(a, 2, 2)[i]}, {i: shard_batch(b, 2, 2)[i]},
        {mesh.rank: shard_cols(eng.relin_key, 2)[mesh.rank]})
torch.save({"out": res[0], "index": i, "bytes": mesh.recv_bytes}, out)
dist.destroy_process_group()
"""


def test_dist_mesh_data_axis_gloo_four_processes(tmp_path):
    """2 data rows x 2 coefficient shards as 4 gloo processes, each
    DistMesh over its row's group (dist.new_group): every shard's slice of
    the batched hmult equals the single-device op's, and each received
    (B/d) * ici_bytes_per_op bytes."""
    import os
    import socket
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=root)
    outs = [tmp_path / f"rank{r}.pt" for r in range(4)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DIST_DATA_WORKER, str(r), str(port),
         str(outs[r])], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    eng = CkksEngine(get_params(n=256, max_level=8, alpha=4), seed=5,
                     device="cpu")
    eng.keygen()
    rng = np.random.default_rng(9)
    a, b = ([eng.encrypt_complex(rng.normal(size=128), 8, SCALE)
             for _ in range(4)] for _ in range(2))
    want = torch.stack([eng.hmult(x, y).data for x, y in zip(a, b)])
    parts = shard_batch(want, 2, 2)
    for r in range(4):
        res = torch.load(outs[r])
        assert res["index"] == r
        assert torch.equal(res["out"], parts[r])
        assert res["bytes"] == 2 * ici_bytes_per_op(eng.params, 8, 2, "hmult")


def test_thread_mesh_data_rows():
    """A 2 x 4 ThreadMesh exchanges within each data row only, returns the
    results in row-major order, and a failing shard in one row aborts the
    other row too: run() re-raises that shard's error."""
    ns, d = 4, 2
    mesh = ThreadMesh(ns, "cpu", timeout=30, data=d)
    xs = [torch.arange(8, dtype=torch.int32).view(4, 2) + 100 * i
          for i in range(d * ns)]
    out = mesh.run(lambda comm: comm.all_gather(xs[comm.index], 0))
    for i in range(d * ns):
        row = i // ns
        assert torch.equal(out[i], torch.cat(xs[row * ns:(row + 1) * ns]))
    assert mesh.recv_bytes == [3 * 8 * 4] * (d * ns)

    def body(comm):
        if comm.index == 5:
            raise KeyError("shard 1.1 failed")
        comm.all_to_all(xs[comm.index], 0, 1)
        return comm.all_gather(xs[comm.index], 0)

    with pytest.raises(KeyError, match="shard 1.1"):
        mesh.run(body)
