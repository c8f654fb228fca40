"""Galois automorphism (rotation / conjugation) in the evaluation domain.

The counterpart of `homulator_tpu/ops/automorph.py:27-33`: sigma_g is a
fixed slot permutation in the NTT's evaluation order
(`DeviceContext.automorph_perm`), one gather along the flat coefficient
axis, the same for every limb. The JAX package runs it as a plain
`jnp.take` outside any Pallas kernel, so a torch gather is its port. The
sharded forms (`:36-126`) belong to the multi-device dispatch.
"""

from __future__ import annotations

import torch


def automorph_eval(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """x: [..., n2, n1] eval tiles; perm: int64 [N] gather indices over
    the flat eval order (out[p] = x[perm[p]]). Returns x's shape and
    dtype."""
    r, c = x.shape[-2:]
    flat = x.reshape(x.shape[:-2] + (r * c,))
    return flat.index_select(-1, perm).view(x.shape)
