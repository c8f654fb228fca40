"""Galois automorphism (rotation / conjugation) in the evaluation domain.

The counterpart of `homulator_tpu/ops/automorph.py`: sigma_g is a fixed
slot permutation in the NTT's evaluation order
(`DeviceContext.automorph_perm`), one gather along the flat coefficient
axis, the same for every limb. The JAX package runs it as a plain
`jnp.take` outside any Pallas kernel, so a torch gather is its port. Its
three-stage form (`automorph_eval_staged`: sublane, lane, sublane gathers
on the [n2, n1] tile, maps from ops/perm_decomp.py through
`DeviceContext.automorph_stage_maps`) is the JAX package's
`take_along_axis` form, here `torch.take_along_dim`.

On a coefficient-sharded eval tile ([..., n2, n1/ns] per shard) it is one
whole-shard ppermute and a local gather (`build_shard_route`,
`automorph_eval_shardperm`), or, where the column map is not
block-aligned, the all_gather form (`automorph_eval_sharded`). The
collectives are those of a parallel/comm.py Comm.
"""

from __future__ import annotations

import numpy as np
import torch


class BlockAlignmentError(ValueError):
    """sigma_g's column map is not block-aligned at this shard count: the
    shard-permutation route does not exist and the caller falls back to
    the all_gather form (automorph_eval_sharded)."""


def automorph_eval(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """x: [..., n2, n1] eval tiles; perm: int64 [N] gather indices over
    the flat eval order (out[p] = x[perm[p]]). Returns x's shape and
    dtype."""
    r, c = x.shape[-2:]
    flat = x.reshape(x.shape[:-2] + (r * c,))
    return flat.index_select(-1, perm).view(x.shape)


def automorph_eval_staged(x: torch.Tensor, s1: torch.Tensor,
                          s2: torch.Tensor, s3: torch.Tensor) -> torch.Tensor:
    """sigma_g on x [..., n2, n1] as three gathers, in order: along n2
    (t1[r, c] = x[s1[r, c], c]), along n1 (t2[r, c] = t1[r, s2[r, c]]),
    along n2 (out[r, c] = t2[s3[r, c], c]). s1, s2, s3: int64 [n2, n1]
    stage maps (DeviceContext.automorph_stage_maps, which converts
    perm_decomp's int32 maps once). Bit-identical to automorph_eval(x,
    perm) for maps built from the same perm."""
    lead = (1,) * (x.ndim - 2)
    t1 = torch.take_along_dim(x, s1.view(lead + s1.shape), dim=-2)
    t2 = torch.take_along_dim(t1, s2.view(lead + s2.shape), dim=-1)
    return torch.take_along_dim(t2, s3.view(lead + s3.shape), dim=-2)


def automorph_eval_sharded(x: torch.Tensor, perm: torch.Tensor,
                           comm) -> torch.Tensor:
    """sigma_g on this shard's column slice x [..., n2, n1/ns]: all_gather
    of the slices, the whole-tile gather, and this rank's slice of the
    result. Receives (ns-1) x the local slice."""
    full = comm.all_gather(x, x.ndim - 1)
    c = x.shape[-1]
    rot = automorph_eval(full, perm)
    return rot[..., comm.rank * c:(comm.rank + 1) * c].contiguous()


def build_shard_route(perm: np.ndarray, n2: int, n1: int, ns: int):
    """Host precompute: sigma_g across an ns-way column-sharded [n2, n1]
    eval tile as ONE whole-shard ppermute and one local gather.

    Flat position p = s*n1 + r holds eval index perm1[r] + n1*perm2[s];
    sigma_g is affine on eval indices, so an output column depends only on
    an input column, and in the sub-NTT's bit-reversed order each block of
    n1/ns columns maps wholesale onto one destination block (checked
    here; raises BlockAlignmentError where it does not hold).

    Returns (src_dev [ns]: the source rank of each destination rank, so
    the ppermute pairs are (src_dev[i], i); local_src int32 [ns,
    n2*(n1/ns)]: out_local[p] = received_flat[local_src[i][p]] on rank i;
    is_identity: every block stays on its rank)."""
    n = n2 * n1
    if n1 % ns:
        raise ValueError(f"n1={n1} does not split into {ns} shards")
    c = n1 // ns
    perm = np.asarray(perm, dtype=np.int64)
    k = np.arange(n, dtype=np.int64)
    col_out = k % n1
    col_src = perm % n1
    dj = col_src // c  # source rank of each output element
    di = col_out // c  # destination rank
    src_dev = np.full(ns, -1, dtype=np.int64)
    for i in range(ns):
        js = np.unique(dj[di == i])
        if len(js) != 1:
            raise BlockAlignmentError(
                f"column map not block-aligned (dest block {i} pulls from "
                f"source blocks {js.tolist()}): use automorph_eval_sharded")
        src_dev[i] = js[0]
    if sorted(src_dev.tolist()) != list(range(ns)):
        raise BlockAlignmentError(f"block map {src_dev.tolist()} is not a "
                                  "permutation of the shards")
    local_src = np.zeros((ns, n2 * c), dtype=np.int32)
    local_dst = (k // n1) * c + (col_out - di * c)
    srcpos = (perm // n1) * c + (col_src - dj * c)
    local_src[di, local_dst] = srcpos.astype(np.int32)
    return src_dev, local_src, bool((src_dev == np.arange(ns)).all())


def automorph_eval_shardperm(x: torch.Tensor, local_src: torch.Tensor,
                             pairs, comm) -> torch.Tensor:
    """sigma_g on this shard's column slice x [..., n2, n1/ns] through
    the shard-permutation route: local_src is this rank's int64 gather
    table [n2*(n1/ns)], pairs the ppermute pairs (empty when the block map
    is the identity: no exchange). Equal to automorph_eval_sharded."""
    if pairs:
        x = comm.ppermute(x, pairs)
    flat = x.reshape(x.shape[:-2] + (-1,))
    return flat.index_select(-1, local_src).view(x.shape)
