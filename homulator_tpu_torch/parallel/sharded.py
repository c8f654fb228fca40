"""Coefficient-sharded hmult and hrotate: the port of the JAX package's
shard_map dispatch (`homulator_tpu/parallel/sharded.py:129-320`).

Every array keeps its trailing (coefficient) axis split over ns shards: a
ciphertext [2, level, n2, n1] is ns column slices [2, level, n2, n1/ns],
the key [dnum, 2, K, n2, n1] likewise. Each shard runs the single-device
hmult / hrotate graph (api.hmult_graph, api.hrotate_tail) on its slices
with its own tables (DeviceContext.keyswitch_tables(level, shard=(r, ns))),
and only two things cross shards:

  * every NTT and iNTT splits into two phase kernels (B6/B7, B8/B9) around
    one all_to_all (ops/ntt.py);
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
ThreadMesh's). The JAX package's batch axis (`data_axis`) is not ported
yet (ROADMAP A12); nor are its lane-packed phase kernels B10-B13, which it
runs where `pack_k_for` is non-zero (ns >= 8 at N = 2^16).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..api import hmult_graph, hrotate_tail
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


def _shard_tables(dc: DeviceContext, level: int, mesh, packed: bool):
    """Per-rank key-switch tables, after checking that the mesh can run
    this shape on the per-limb phase kernels."""
    ns = mesh.size
    t = dc.params.ntt
    if t.n1 % ns or t.n2 % ns:
        raise ValueError(f"{ns} shards do not divide n1={t.n1}, n2={t.n2}")
    k = pack_k_for(t.n1, t.n2, ns)
    if packed and k:
        raise NotImplementedError(
            f"packed=True at n1={t.n1}, n2={t.n2}, ns={ns} selects the "
            f"lane-packed phase kernels (k={k}), which are not ported: "
            "ROADMAP B10-B13. packed=False runs the per-limb kernels B6-B9.")
    return [dc.keyswitch_tables(level, shard=(r, ns)) for r in range(ns)]


def make_shardmap_hmult(dc: DeviceContext, level: int, mesh, *,
                        packed: bool = True):
    """hmult at `level` over `mesh` with the coefficient axis sharded.
    Returns f(a, b, key) -> out, each a list of per-rank column slices
    (a, b: [2, level, n2, n1/ns]; key: [dnum, 2, K, n2, n1/ns]; out:
    [2, level-1, n2, n1/ns]). packed=True raises NotImplementedError where
    the JAX package would take its lane-packed kernels (see module
    docstring); packed=False runs B6-B9 at any ns that divides n1 and
    n2."""
    if level < 2:
        raise ValueError(f"level {level}: hmult needs level >= 2 (rescale "
                         "drops one limb)")
    kts = _shard_tables(dc, level, mesh, packed)

    def run(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor],
            key: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return mesh.run(lambda comm: hmult_graph(
            a[comm.rank], b[comm.rank], key[comm.rank], kts[comm.rank]))

    return run


def make_shardmap_hrotate(dc: DeviceContext, level: int, mesh, *,
                          packed: bool = True):
    """hrotate at `level` over `mesh` with the coefficient axis sharded.
    Returns f(a, route, key) -> out over per-rank column slices, where
    route = dc.automorph_shard_route(galois_elt(step), ns): the
    shard-permutation route, or its gather sentinel (pairs None, local_src
    the whole permutation), which takes the all_gather form."""
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
    lane-packed kernels (k = pack_k_for > 0 and packed is not False), each
    call's rows round up to a multiple of k, as its packed exchanges
    carry."""
    n = params.n
    t = params.ntt
    k = 0 if packed is False else pack_k_for(t.n1, t.n2, ns)
    calls = transform_calls(params, level, op)
    rows = sum(calls) if not k else sum(-(-c // k) * k for c in calls)
    autos = 2 if op == "hrotate" and not route_identity else 0
    per_row = (ns - 1) * n * 4 // (ns * ns)
    per_auto = level * n * 4 // ns
    return rows * per_row + autos * per_auto
