"""Coefficient-axis-sharded NTT: the port of
`homulator_tpu/parallel/coeff_ntt.py::make_coeff_sharded_ntt`.

The JAX function jits the 4-step transform with the tile's column axis
annotated as sharded and lets the partitioner turn the transpose into an
all_to_all. Here it is the explicit program of the coefficient dispatch:
each shard runs ops/ntt.py's `ntt_rep` / `intt_rep` on its column slice
with the basis `DeviceContext.ntt_basis(rows, shard=(rank, ns))`, so the
transform is two phase kernels around one all_to_all over the mesh axis
(B6/B7 forward, B8/B9 inverse on the card; the lane-packed B10-B13 where
`mesh.pack_k_for` gives k > 0, as the JAX coefficient dispatch packs).
This is the accelerated route's transform: the graph route
(`ntt_mode="jnp"`) has no sharded form (context.py, ROADMAP A5).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..context import DeviceContext
from ..ops.ntt import intt_rep, ntt_rep
from .comm import bound


def make_coeff_sharded_ntt(dc: DeviceContext, rows: Tuple[int, ...], mesh,
                           axis: str = "coeff"):
    """Returns (ntt_fn, intt_fn) over the basis of `rows` with the tile's
    trailing (column) axis sharded over mesh axis `axis` of ns shards:
    ntt_fn takes the per-shard column slices [M, n1, n2/ns] of a coeff
    tile (sharded.shard_cols, indexed by Comm.index) and returns each
    shard's [M, n2, n1/ns] slice of the eval tile (gather_cols joins a
    ThreadMesh's); intt_fn the inverse. The JAX function takes a jnp
    NttBasis; this one takes dc and rows, because the shard bases come
    from DeviceContext.ntt_basis(rows, shard=(rank, ns), packed=True)."""
    ns = mesh.extent(axis)
    t = dc.params.ntt
    if t.n1 % ns or t.n2 % ns:
        raise ValueError(f"{ns} shards do not divide n1={t.n1}, n2={t.n2}")
    bases = [dc.ntt_basis(tuple(rows), shard=(r, ns), packed=True)
             for r in range(ns)]

    def over(transform):
        def run(x: Sequence[torch.Tensor]) -> List[torch.Tensor]:
            def body(comm):
                ac = comm.axis(axis)
                with bound(ac):
                    return transform(x[comm.index], bases[ac.rank], 1)
            return mesh.run(body)
        return run

    return over(ntt_rep), over(intt_rep)
