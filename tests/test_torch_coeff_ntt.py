"""The coefficient-sharded NTT of the port, on the CPU (the kernels' plain
versions), bit for bit (tolerance 0):

  * the plain versions of the phase kernels B6-B9 vs the JAX package's
    `ntt_phase1_pallas`, `ntt_phase2_pallas`, `intt_phase2_pallas` and
    `intt_phase1_pallas` in interpret mode, at n = 4096 (n1 = n2 = 64),
    M = 4, c = 32, on both column slices of a 2-shard split;
  * the sharded ntt_rep / intt_rep on a ThreadMesh of 2 and 4 shards vs
    the port's single-device transform;
  * the shardability predicates vs the JAX package's.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homulator_tpu.context import DeviceContext as JaxContext
from homulator_tpu.ops.ntt_pallas import (
    intt_phase1_pallas, intt_phase2_pallas, ntt_phase1_pallas,
    ntt_phase2_pallas, pack_k_for as jax_pack_k_for,
)
from homulator_tpu.parallel.mesh import coeff_shard_ok as jax_coeff_shard_ok
from homulator_tpu.params import get_params
from homulator_tpu_torch import kernels
from homulator_tpu_torch.context import DeviceContext
from homulator_tpu_torch.ops import ntt_kernels
from homulator_tpu_torch.ops.ntt import (
    intt_phase1, intt_phase2, intt_rep, ntt_phase1, ntt_phase2, ntt_rep,
)
from homulator_tpu_torch.parallel.comm import ThreadMesh
from homulator_tpu_torch.parallel.mesh import coeff_shard_ok, pack_k_for
from homulator_tpu_torch.parallel.sharded import gather_cols, shard_cols

ROWS = (9, 0, 2, 3)  # a special prime first, then mains
NS, C = 2, 32  # n1 = n2 = 64: two shards of 32 columns
PHASES = ("ntt1", "ntt2", "intt2", "intt1")  # B6, B7, B8, B9


@pytest.fixture(scope="module")
def ctx():
    p = get_params(n=4096, max_level=8, alpha=2)
    return p, JaxContext(p, ntt_mode="interpret").ntt_basis(ROWS), \
        DeviceContext(p, "cpu")


def _residues(p, shape, seed, rep=1):
    rng = np.random.default_rng(seed)
    q = np.tile(p.q_arr[list(ROWS)], rep).astype(np.int64)
    return rng.integers(0, q.reshape((-1,) + (1,) * len(shape)),
                        size=(len(q),) + shape,
                        dtype=np.int64).astype(np.uint32)


def _port(fn, x, nb):
    out = fn(torch.from_numpy(x.view(np.int32)), nb)
    assert out.dtype == torch.int32 and out.shape == x.shape
    return out.numpy().view(np.uint32)


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("phase", PHASES)
def test_phase_plain_matches_pallas(ctx, phase, rank):
    """Each plain phase function on rank's column slice == the JAX phase
    kernel fed the same slice of its mid tables."""
    p, jnb, dc = ctx
    nb = dc.ntt_basis(ROWS, shard=(rank, NS))
    n1, n2 = p.ntt.n1, p.ntt.n2
    cols = slice(rank * C, (rank + 1) * C)
    p1, p1s, mid, mids, p2, p2s = jnb.pfwd
    ip1, ip1s, midi, midis, ip2, ip2s = jnb.pinv
    x = _residues(p, (n1 if phase in ("ntt1", "intt1") else n2, C),
                  seed=PHASES.index(phase) * NS + rank)
    jx = jnp.asarray(x)
    if phase == "ntt1":
        want = ntt_phase1_pallas(jx, jnb.q, p1, p1s, mid[:, :, cols],
                                 mids[:, :, cols], n1=n1, c=C, interpret=True)
        got = _port(ntt_phase1, x, nb)
    elif phase == "ntt2":
        want = ntt_phase2_pallas(jx, jnb.q, p2, p2s, n2=n2, c=C,
                                 interpret=True)
        got = _port(ntt_phase2, x, nb)
    elif phase == "intt2":
        want = intt_phase2_pallas(jx, jnb.q, ip2, ip2s, n2=n2, c=C,
                                  interpret=True)
        got = _port(intt_phase2, x, nb)
    else:
        want = intt_phase1_pallas(jx, jnb.q, midi[:, :, cols],
                                  midis[:, :, cols], ip1, ip1s, n1=n1, c=C,
                                  interpret=True)
        got = _port(intt_phase1, x, nb)
    assert np.array_equal(got, np.asarray(want))


def test_shard_basis_tables(ctx):
    """A rank's basis holds the mid tables' column slice, contiguous, and
    shares every other table with the whole basis."""
    p, _, dc = ctx
    full = dc.ntt_basis(ROWS)
    for rank in range(NS):
        nb = dc.ntt_basis(ROWS, shard=(rank, NS))
        assert nb.shard == (rank, NS) and nb.rows == ROWS
        for k in ("mid", "mid_sh", "mid_inv", "mid_inv_sh"):
            t = getattr(nb, k)
            assert t.is_contiguous()
            assert torch.equal(t, getattr(full, k)[:, :, rank * C:(rank + 1) * C])
        assert nb.tw1 is full.tw1 and nb.itw2 is full.itw2
    with pytest.raises(ValueError, match="shard"):
        dc.ntt_basis(ROWS, shard=(0, 3))


@pytest.mark.parametrize("ns", [2, 4])
@pytest.mark.parametrize("rep", [1, 2])
def test_sharded_transform_matches_single_device(ctx, ns, rep):
    """ntt_rep / intt_rep on a sharded basis, run by a ThreadMesh, gather
    to the single-device transform, and invert each other."""
    p, _, dc = ctx
    n1, n2 = p.ntt.n1, p.ntt.n2
    full = dc.ntt_basis(ROWS)
    nbs = [dc.ntt_basis(ROWS, shard=(r, ns)) for r in range(ns)]
    mesh = ThreadMesh(ns, "cpu", timeout=60)
    x = torch.from_numpy(_residues(p, (n1, n2), seed=ns + rep,
                                   rep=rep).view(np.int32))
    xs = shard_cols(x, ns)
    ev = mesh.run(lambda comm: ntt_rep(xs[comm.rank], nbs[comm.rank], rep))
    assert torch.equal(gather_cols(ev), ntt_rep(x, full, rep))
    back = mesh.run(lambda comm: intt_rep(ev[comm.rank], nbs[comm.rank], rep))
    assert torch.equal(gather_cols(back), x)
    per_row = (ns - 1) * p.n * 4 // (ns * ns)
    assert mesh.recv_bytes == [2 * rep * len(ROWS) * per_row] * ns


def test_sharded_transform_needs_its_mesh(ctx):
    """A sharded basis runs only inside a shard program of its rank."""
    p, _, dc = ctx
    nb = dc.ntt_basis(ROWS, shard=(1, NS))
    x = torch.zeros((len(ROWS), p.ntt.n1, C), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no shard program"):
        ntt_rep(x, nb, 1)
    other = dc.ntt_basis(ROWS, shard=(0, NS))
    mesh = ThreadMesh(NS, "cpu", timeout=60)
    with pytest.raises(ValueError, match="run by rank"):
        mesh.run(lambda comm: ntt_rep(x, other if comm.rank else nb, 1))


def test_phase_wrappers_refuse_cpu_tensors(ctx):
    p, _, dc = ctx
    nb = dc.ntt_basis(ROWS, shard=(0, NS))
    x = torch.zeros((len(ROWS), p.ntt.n1, C), dtype=torch.int32)
    for fn in (ntt_kernels.ntt_phase1, ntt_kernels.ntt_phase2,
               ntt_kernels.intt_phase2, ntt_kernels.intt_phase1,
               ntt_kernels.ntt_phase1_packed, ntt_kernels.ntt_phase2_packed,
               ntt_kernels.intt_phase2_packed,
               ntt_kernels.intt_phase1_packed):
        with pytest.raises(ValueError, match="CUDA kernel"):
            fn(x, nb)


def test_thread_mesh_reraises_and_never_hangs():
    """One failing shard aborts the exchange: run() re-raises that shard's
    error (not the others' broken barrier) and returns no partial result."""
    mesh = ThreadMesh(4, "cpu", timeout=30)
    x = torch.arange(16).view(4, 4)

    def body(comm):
        y = comm.all_to_all(x, 0, 1)
        if comm.rank == 2:
            raise KeyError("shard 2 failed")
        return comm.all_gather(y, 0)

    with pytest.raises(KeyError, match="shard 2"):
        mesh.run(body)
    out = mesh.run(lambda comm: comm.all_gather(x[comm.rank:comm.rank + 1], 0))
    assert all(torch.equal(o, x) for o in out)


def test_thread_mesh_collectives():
    """all_to_all, all_gather and ppermute of the ThreadMesh against their
    definitions, with the bytes each rank receives from the others."""
    ns = 4
    mesh = ThreadMesh(ns, "cpu", timeout=30)
    xs = [torch.arange(32, dtype=torch.int32).view(8, 4) + 100 * r
          for r in range(ns)]
    a2a = mesh.run(lambda comm: comm.all_to_all(xs[comm.rank], 0, 1))
    for r in range(ns):
        assert torch.equal(a2a[r], torch.cat([x[2 * r:2 * r + 2] for x in xs],
                                             1))
    assert mesh.recv_bytes == [3 * 2 * 4 * 4] * ns
    mesh.reset_counts()
    pairs = [(1, 0), (0, 1), (3, 2)]  # rank 3 receives nothing
    got = mesh.run(lambda comm: comm.ppermute(xs[comm.rank], pairs))
    assert torch.equal(got[0], xs[1]) and torch.equal(got[1], xs[0])
    assert torch.equal(got[2], xs[3]) and not got[3].any()
    assert mesh.recv_bytes == [128, 128, 128, 0]


def test_launch_count_under_thread_contention():
    """kernels.count from many threads with a short switch interval loses
    no update."""
    import sys

    threads, each = 16, 2000
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        kernels.reset_launch_counts()
        ts = [threading.Thread(target=lambda: [kernels.count("bconv")
                                               for _ in range(each)])
              for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
        assert kernels.LAUNCHES["bconv"] == threads * each
    finally:
        sys.setswitchinterval(prev)
        kernels.reset_launch_counts()


@pytest.mark.parametrize("n", [16, 64, 128, 256])
@pytest.mark.parametrize("ns", [1, 2, 4, 8, 16, 32, 64])
def test_shard_predicates_match_jax(n, ns):
    """coeff_shard_ok and pack_k_for equal the JAX predicates on square
    power-of-two tiles."""
    assert coeff_shard_ok(n, n, ns) == jax_coeff_shard_ok(n, n, ns)
    assert coeff_shard_ok(n, n, ns, min_tile=4) == jax_coeff_shard_ok(
        n, n, ns, min_tile=4)
    assert pack_k_for(n, n, ns) == jax_pack_k_for(n, n, ns)


def test_pack_gate_refuses_non_dividing_shards():
    """The JAX gate floors c = n2 // ns; the port's gives 0 unless ns | n2
    and c | 128."""
    assert jax_pack_k_for(64, 64, 3) == 128 // 21  # the latent JAX fault
    assert pack_k_for(64, 64, 3) == 0
    assert pack_k_for(96, 96, 4) == 0  # c = 24 does not divide 128
    assert pack_k_for(4096 // 64, 4096 // 64, 4) == 8
    assert pack_k_for(256, 256, 4) == 0 and pack_k_for(256, 256, 8) == 4
