"""Meshes and shardability predicates of the sharded dispatches.

The port's own copies of `homulator_tpu/parallel/mesh.py::coeff_shard_ok`
and of the lane-packing gate `homulator_tpu/ops/ntt_pallas.py::pack_k_for`
(numpy-free, JAX-free), and `make_mesh`, the counterpart of the JAX
`make_mesh`: the port has no device-mesh object, so the mesh it returns is
the runner of `parallel/comm.py` that executes one program per shard.

The JAX module's `ct_batch_sharding`, `limb_sharding` and `replicated`
return `NamedSharding` objects for the partitioner and have no
counterpart: the port's dispatches take operands already cut per shard,
and `sharded.shard_cols`, `sharded.shard_batch` and
`limb_sharded.shard_rows` / `limb_key` lay them out.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

AXES = ("data", "limb", "coeff")


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              n_devices: Optional[int] = None,
              axis_names: Optional[Tuple[str, ...]] = None,
              device="cuda"):
    """A ThreadMesh of n_devices shards on `device` laid out as `shape`
    (default (1, n_devices)), with the JAX default axis names: ("data",
    "limb") for two axes, ("data", "limb", "coeff") for three. A leading
    "data" axis becomes the mesh's data rows; the other axes are its
    named axes (row-major). All shards run on the one device: a mesh of
    shard programs, not of devices."""
    from .comm import ThreadMesh

    if shape is None:
        if n_devices is None:
            raise ValueError("make_mesh needs shape or n_devices")
        shape = (1, n_devices)
    shape = tuple(shape)
    if n_devices is None:
        n_devices = math.prod(shape)
    if axis_names is None:
        if len(shape) > len(AXES):
            raise ValueError(f"mesh of {len(shape)} axes: name them")
        axis_names = AXES[:len(shape)]
    axis_names = tuple(axis_names)
    if len(axis_names) != len(shape):
        raise ValueError(f"{len(axis_names)} axis names {axis_names} for "
                         f"shape {shape}")
    if math.prod(shape) != n_devices:
        raise ValueError(f"shape {shape} does not hold {n_devices} shards")
    data = 1
    if axis_names[0] == "data":
        data, shape, axis_names = shape[0], shape[1:], axis_names[1:]
    if not shape:  # a mesh of data rows only: one unnamed shard a row
        return ThreadMesh(1, device, data=data)
    return ThreadMesh(shape, device, data=data, names=axis_names)


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
