"""Coefficient-sharded hmult and hrotate: the port of the JAX package's
shard_map dispatch (`homulator_tpu/parallel/sharded.py:129-320`).

Every array keeps its trailing (coefficient) axis split over ns shards: a
ciphertext [2, level, n2, n1] is ns column slices [2, level, n2, n1/ns],
the key [dnum, 2, K, n2, n1] likewise. Each shard runs the single-device
hmult / hrotate graph (api.hmult_graph, api.hrotate_tail) on its slices
with its own tables (DeviceContext.keyswitch_tables(level, shard=(r, ns))),
and only two things cross shards:

  * every NTT and iNTT splits into two phase kernels around one
    all_to_all (ops/ntt.py): the per-limb B6/B7, B8/B9, or, where the JAX
    package packs (packed=True, the default, and pack_k_for > 0: ns >= 8
    at N = 2^16), their lane-packed forms B10/B11, B12/B13 around a packed
    exchange that carries each call's rows padded to a multiple of k;
  * the automorphism is one whole-shard ppermute and a local gather, or
    the all_gather form where the column map is not block-aligned
    (ops/automorph.py).

Tensor product, base conversions (B3), key inner product, ModDown and
rescale work column by column and stay local. A mesh of parallel/comm.py
runs the shard programs: ThreadMesh(ns, device) runs them as threads on
one device, DistMesh one per process.

The dispatch takes and returns sharded operands, as the JAX functions take
arrays already laid out over the mesh: each operand is indexed by rank (a
list of every rank's column slice, `shard_cols`; in a DistMesh process a
mapping that holds its own rank's), and the result is the list of the
slices of the shards this process ran (`gather_cols` joins a
ThreadMesh's).

make_shardmap_hmult(..., data_axis="data") is the JAX package's batch
axis: a mesh of d data rows of ns shards, operands [B, 2, level, n2, n1]
cut into d batch blocks and ns column slices (`shard_batch`, indexed by
`Comm.index`; the key by rank alone), each shard running one hmult_graph
on its whole [B/d, ...] block, the JAX body's vmap: every kernel launch
and every all_to_all covers the B/d elements (each transform's rep copies,
B3's grid z axis), so a shard makes one element's collective calls and
launches and receives B/d times its bytes; `gather_batch` joins the
result.

The JAX package's GSPMD surface (`homulator_tpu/parallel/sharded.py:
358-390`, `coeff_ntt.py`, the JAX CLI's ops at [cluster] > 1 other than
the key-switch dispatches) hands whole arrays with sharding annotations
to XLA's partitioner. The port expresses each of those layouts with its
explicit per-shard programs instead, not with torch DTensor:

  1. DTensor needs one process-group rank per shard; NCCL puts no two
     ranks on one GPU, so on a one-card machine it could run one shard,
     and it cannot run on a ThreadMesh;
  2. the op path calls the CUDA kernels through ctypes (kernels.py), and
     DTensor cannot propagate a sharding through such calls: around each
     kernel it would gather to a replica, which partitions nothing;
  3. every layout the JAX package annotates already has an explicit,
     bit-exact program here: the batched hmult over ("data", "limb") or
     ("data", "limb", "coeff") is make_limb_hmult / make_hybrid_hmult
     with a data axis (`make_sharded_hmult`), the coefficient-sharded NTT
     is ops/ntt.py's phase-split transform on sharded bases
     (parallel/coeff_ntt.py), and the elementwise ops over rows or n2 are
     local to each shard (`make_sharded_elementwise`).

`ici_bytes_from_lowered` parses the StableHLO of a lowered JAX program
and has no counterpart: the port counts the bytes at each collective
itself (Comm.recv_bytes), which the tests and the CLI hold against
`ici_bytes_per_op` and its limb and hybrid forms.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..api import (
    hadd_graph, hmult_graph, hrotate_tail, hsub_graph, padd_graph,
    pmult_graph,
)
from ..context import DeviceContext
from ..ops.automorph import automorph_eval_sharded, automorph_eval_shardperm
from .mesh import pack_k_for


def shard_cols(x: torch.Tensor, ns: int) -> List[torch.Tensor]:
    """x's trailing axis cut into ns contiguous column slices, rank order."""
    if x.shape[-1] % ns:
        raise ValueError(f"trailing axis of {tuple(x.shape)} does not split "
                         f"into {ns} shards")
    return [p.contiguous() for p in x.chunk(ns, dim=-1)]


def gather_cols(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The whole array from its per-rank column slices."""
    return torch.cat(list(parts), dim=-1)


def shard_batch(x: torch.Tensor, d: int, ns: int) -> List[torch.Tensor]:
    """x [B, ...] cut into d batch blocks (data rows) of B/d elements and
    each block into ns column slices: element row * ns + rank is that
    shard's [B/d, ..., n1/ns] (`Comm.index` order)."""
    if x.shape[0] % d:
        raise ValueError(f"batch of {x.shape[0]} does not split into {d} "
                         "data rows")
    return [p for blk in x.chunk(d, dim=0) for p in shard_cols(blk, ns)]


def gather_batch(parts: Sequence[torch.Tensor], d: int) -> torch.Tensor:
    """The whole batch from shard_batch's row-major list of slices."""
    ns = len(parts) // d
    return torch.cat([gather_cols(parts[r * ns:(r + 1) * ns])
                      for r in range(d)], dim=0)


def _shard_tables(dc: DeviceContext, level: int, mesh, packed: bool):
    """Per-rank key-switch tables, lane-packed where `packed` and
    pack_k_for > 0 (DeviceContext.keyswitch_tables)."""
    ns = mesh.size
    t = dc.params.ntt
    if t.n1 % ns or t.n2 % ns:
        raise ValueError(f"{ns} shards do not divide n1={t.n1}, n2={t.n2}")
    return [dc.keyswitch_tables(level, shard=(r, ns), packed=packed)
            for r in range(ns)]


def _check_data_axis(mesh, data_axis) -> None:
    if data_axis is None and mesh.data > 1:
        raise ValueError(f"mesh has {mesh.data} data rows: pass "
                         "data_axis='data'")
    if data_axis not in (None, "data"):
        raise ValueError(f"data_axis {data_axis!r}: a mesh's batch axis is "
                         "'data'")


def make_shardmap_hmult(dc: DeviceContext, level: int, mesh, *,
                        data_axis: Optional[str] = None,
                        packed: bool = True):
    """hmult at `level` over `mesh` with the coefficient axis sharded.
    Returns f(a, b, key) -> out, each a list of per-rank column slices
    (a, b: [2, level, n2, n1/ns]; key: [dnum, 2, K, n2, n1/ns]; out:
    [2, level-1, n2, n1/ns]). packed=True (the JAX default) takes the
    lane-packed kernels B10-B13 where pack_k_for > 0, packed=False the
    per-limb B6-B9 at any ns that divides n1 and n2.

    With data_axis="data" over a mesh of d data rows: a and b are
    shard_batch lists of [B/d, 2, level, n2, n1/ns] (indexed by
    Comm.index), key is indexed by rank, and out is the list of each
    shard's [B/d, 2, level-1, n2, n1/ns] (gather_batch joins them): one
    hmult_graph on the block, one element's launches and exchanges."""
    if level < 2:
        raise ValueError(f"level {level}: hmult needs level >= 2 (rescale "
                         "drops one limb)")
    _check_data_axis(mesh, data_axis)
    kts = _shard_tables(dc, level, mesh, packed)

    def run(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor],
            key: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return mesh.run(lambda comm: hmult_graph(
            a[comm.index], b[comm.index], key[comm.rank], kts[comm.rank]))

    return run


def make_shardmap_hrotate(dc: DeviceContext, level: int, mesh, *,
                          packed: bool = True):
    """hrotate at `level` over `mesh` with the coefficient axis sharded.
    Returns f(a, route, key) -> out over per-rank column slices, where
    route = dc.automorph_shard_route(galois_elt(step), ns): the
    shard-permutation route, or its gather sentinel (pairs None, local_src
    the whole permutation), which takes the all_gather form. packed as in
    make_shardmap_hmult."""
    _check_data_axis(mesh, None)
    kts = _shard_tables(dc, level, mesh, packed)

    def run(a: Sequence[torch.Tensor], route,
            key: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        local_src, pairs, _ = route

        def body(comm):
            x = a[comm.rank]
            if pairs is None:
                r0, r1 = (automorph_eval_sharded(x[i], local_src, comm)
                          for i in (0, 1))
            else:
                r0, r1 = (automorph_eval_shardperm(
                    x[i], local_src[comm.rank], pairs, comm) for i in (0, 1))
            return hrotate_tail(r0, r1, key[comm.rank], kts[comm.rank])

        return mesh.run(body)

    return run


def transform_calls(params, level: int, op: str) -> List[int]:
    """Row counts of every ntt/intt call of one op in the JAX package's
    sharded graph, in program order: ModUp iNTT, the per-digit NTTs (other
    rows only), then the tails (hmult: per key iNTT(specials), iNTT(last
    limb), NTT(out); hrotate: per key iNTT(specials), NTT(main)). The port
    batches the two keys' calls, which moves the same rows."""
    alpha = params.alpha
    calls = [level]
    calls += [(alpha + level) - (hi - lo)
              for lo, hi in (params.digit_range(level, d)
                             for d in range(params.beta(level)))]
    if op == "hmult":
        calls += [alpha, 1, level - 1] * 2
    elif op == "hrotate":
        calls += [alpha, level] * 2
    else:
        raise ValueError(op)
    return calls


def ici_bytes_per_op(params, level: int, ns: int, op: str = "hmult", *,
                     route_identity: bool = False,
                     packed: "bool | None" = None) -> int:
    """Bytes one rank receives from the others in one sharded op at
    `level` over ns shards, from the collective schedule (the JAX
    function of the same name, whose numbers it gives).

    Each transform's all_to_all keeps 1/ns of a rank's local N/ns
    elements per row and receives the rest: (ns-1)/ns * N/ns * 4 bytes a
    row. Each automorphism is one whole-shard ppermute of [level, n2,
    n1/ns]: level * N/ns * 4 bytes, none when the route's block map is
    the identity (route_identity=True). Where the JAX package takes its
    lane-packed kernels (k = pack_k_for > 0 and packed is not False, as
    make_shardmap_* run by default), each call's rows round up to a
    multiple of k, as its packed exchanges carry. With a data axis, a
    shard receives this once per element of its batch block."""
    n = params.n
    t = params.ntt
    k = 0 if packed is False else pack_k_for(t.n1, t.n2, ns)
    calls = transform_calls(params, level, op)
    rows = sum(calls) if not k else sum(-(-c // k) * k for c in calls)
    autos = 2 if op == "hrotate" and not route_identity else 0
    per_row = (ns - 1) * n * 4 // (ns * ns)
    per_auto = level * n * 4 // ns
    return rows * per_row + autos * per_auto


# ---- the JAX package's GSPMD surface, on the explicit dispatches ----------
def batched_hmult_fn(dc: DeviceContext, level: int):
    """Returns f(a_batch, b_batch, evk) -> out_batch: hmult over int32
    [B, 2, level, n2, n1] batches on one device, out [B, 2, level-1, n2,
    n1]: the JAX function's vmap of hmult_graph. On the piecewise and
    fused routes one call of api.hmult_graph on the whole batch, so every
    kernel launch covers it (B1/B2 over B rep copies, B3/B4 with the
    batch as their grid's z axis) and a batch launches B1-B4 as often as
    one element does. The graph route (ntt_mode="jnp") stays one element
    after another: ROADMAP A5 keeps it to parity with the JAX engine and
    to B5's path, and gives it no new option."""
    kt = dc.keyswitch_tables(level)

    def f(a_batch: torch.Tensor, b_batch: torch.Tensor,
          evk: torch.Tensor) -> torch.Tensor:
        if kt.graph:
            return torch.stack([hmult_graph(a, b, evk, kt)
                                for a, b in zip(a_batch, b_batch)])
        return hmult_graph(a_batch, b_batch, evk, kt)

    return f


def make_sharded_hmult(dc: DeviceContext, level: int, mesh):
    """Batched hmult over a mesh of make_mesh's ("data", "limb") or
    ("data", "limb", "coeff") layout: the batch over the data rows, the
    RNS rows over "limb" and, with a "coeff" axis, every tile's trailing
    axis over "coeff" (the JAX function's input shardings). Runs
    limb_sharded.make_limb_hmult or, with a "coeff" axis,
    make_hybrid_hmult, each with data_axis="data".

    Returns f(a_batch, b_batch, evk): whole operands [B, 2, level, n2,
    n1] and the whole key, as the JAX function takes global arrays; f
    lays them out itself (limb_sharded.shard_rows, with pad rows where
    the limb axis does not divide level, and limb_key). On a ThreadMesh
    it returns the whole [B, 2, level-1, n2, n1] batch; on a DistMesh the
    list of this process's padded slices, as the other dispatches do."""
    from . import limb_sharded as ls
    from .comm import ThreadMesh

    names = tuple(getattr(mesh, "names", ()))
    if names == ("limb",):
        ns_l, ns_c = mesh.extent("limb"), 1
        f = ls.make_limb_hmult(dc, level, mesh, data_axis="data")
    elif names == ("limb", "coeff"):
        ns_l, ns_c = mesh.extent("limb"), mesh.extent("coeff")
        f = ls.make_hybrid_hmult(dc, level, mesh, data_axis="data")
    else:
        raise ValueError(f"mesh axes {names}: make_sharded_hmult takes "
                         "make_mesh's ('data', 'limb') or ('data', 'limb', "
                         "'coeff')")
    d = mesh.data

    def run(a_batch: torch.Tensor, b_batch: torch.Tensor, evk: torch.Tensor):
        out = f(ls.shard_rows(a_batch, level, ns_l, ns_c, data=d),
                ls.shard_rows(b_batch, level, ns_l, ns_c, data=d),
                ls.limb_key(evk, dc.params, level, ns_l, ns_c))
        if not isinstance(mesh, ThreadMesh):
            return out
        return ls.gather_rows(out, ns_l, ns_c, data=d)[:, :, :level - 1]

    return run


ELEMENTWISE = {"hadd": hadd_graph, "hsub": hsub_graph, "padd": padd_graph,
               "pmult": pmult_graph}


def elementwise_axis(level: int, ns: int) -> int:
    """The axis of a ciphertext [2, level, n2, n1] that the JAX CLI shards
    the elementwise ops over at ns devices: the rows where ns divides
    level, else n2 (homulator_tpu/cli.py:318-334); -3 or -2."""
    return -3 if level % ns == 0 else -2


def shard_elementwise(x: torch.Tensor, axis: int,
                      ns: int) -> List[torch.Tensor]:
    """x (a ciphertext [2, level, n2, n1] or a plaintext [level, n2, n1])
    cut along `axis` (elementwise_axis's, counted from the end) into ns
    contiguous slices, rank order; slices differ by at most one row where
    ns does not divide the axis."""
    return [p.contiguous() for p in torch.tensor_split(x, ns, dim=axis)]


def make_sharded_elementwise(dc: DeviceContext, op: str, level: int, mesh):
    """hadd, hsub, padd or pmult at `level` over a mesh of ns shards (one
    axis, no data rows), laid out as the JAX CLI lays them out for GSPMD:
    rows or n2 over the mesh (elementwise_axis). Returns f(a, b) -> out
    over per-rank slices (shard_elementwise of the ciphertext a and of
    the ciphertext or plaintext b); each shard runs the engine's graph
    (api.hadd_graph, ...) on its slice with the primes of its rows. No
    collective runs: a shard receives 0 bytes."""
    if op not in ELEMENTWISE:
        raise ValueError(f"{op!r}: not one of {tuple(ELEMENTWISE)}")
    _check_data_axis(mesh, None)
    ns = mesh.size
    q = dc.q_level(level)
    qs = (shard_elementwise(q, -1, ns) if elementwise_axis(level, ns) == -3
          else [q] * ns)
    graph = ELEMENTWISE[op]

    def run(a: Sequence[torch.Tensor],
            b: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return mesh.run(lambda comm: graph(a[comm.rank], b[comm.rank],
                                           qs[comm.rank]))

    return run
