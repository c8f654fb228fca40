"""Shardability predicates of the coefficient-sharded dispatch.

The port's own copies of `homulator_tpu/parallel/mesh.py::coeff_shard_ok`
and of the lane-packing gate `homulator_tpu/ops/ntt_pallas.py::pack_k_for`
(numpy-free, JAX-free). The port has no device-mesh object: the mesh is the
runner of `parallel/comm.py` that executes one program per shard.
"""

from __future__ import annotations


def coeff_shard_ok(n1: int, n2: int, ns: int, *, min_tile: int = 8) -> bool:
    """Whether the coefficient dispatch runs at ns shards: both NTT tile
    axes divide evenly and the per-shard slice of the smaller one keeps at
    least `min_tile` columns (the CLI's gate, as in the JAX package)."""
    return (ns >= 1 and n1 % ns == 0 and n2 % ns == 0
            and min(n1, n2) // ns >= min_tile)


def pack_k_for(n1: int, n2: int, ns: int) -> int:
    """Lane-group size k of the JAX package's lane-packed phase kernels
    (B10-B13) at this shape, or 0 where it runs the per-limb phase kernels
    (B6-B9): square tiles with n >= 64 and a shard width c = n2/ns of at
    most 32 columns, k = 128/c. Unlike the JAX gate it also requires
    ns | n2 and c | 128, so a non-power-of-two ns gives 0 rather than a
    floored c and a bogus k."""
    if not (n1 == n2 and n1 >= 64 and ns > 0 and n2 % ns == 0):
        return 0
    c = n2 // ns
    if c > 32 or 128 % c:
        return 0
    return 128 // c
