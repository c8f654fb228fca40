"""Host-side 3-stage decomposition of grid permutations.

Any permutation of an [R, C] grid factors as

    out = col_gather(row_gather(col_gather(in, s1), s2), s3)

i.e. a sublane gather, a lane gather, and a second sublane gather — the
routing-network form of the reference's AUTOU log-stage swap network
(include/Components.h:201-238; its `auto_stages` serial stages are exactly
such a fixed routing fabric). Existence follows from König/Hall: the
bipartite multigraph between input columns and output columns (one edge
per grid cell) is R-regular, hence decomposes into R perfect matchings;
matching k routes through row k of the intermediate array.

For R a power of two the decomposition runs in O(E log R) via recursive
Euler splitting (split a d-regular multigraph into two d/2-regular halves
by alternating edges along Euler circuits). This is a one-time host
precompute per rotation step, cached by DeviceContext
(`automorph_stage_maps`).

Gather stages use numpy/jnp.take_along_axis semantics:
    t1[r, c]  = in[s1[r, c], c]
    t2[r, c]  = t1[r, s2[r, c]]
    out[r, c] = t2[s3[r, c], c]

The port's own copy of `homulator_tpu/ops/perm_decomp.py`, arithmetic
unchanged (numpy only); `ops/automorph.py::automorph_eval_staged` applies
the maps on the device.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _euler_split(c_in: np.ndarray, c_out: np.ndarray, C: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Split a d-regular bipartite multigraph (edges c_in[e] -> c_out[e],
    d even) into two d/2-regular halves. Returns (idx_a, idx_b): edge-index
    arrays of the halves. Walks Euler circuits (all degrees even) and
    alternates edges between halves; each circuit alternates sides, so
    every node's edges split evenly."""
    E = len(c_in)
    # adjacency: per node, list of (edge_id, is_forward). Left nodes
    # 0..C-1 (input columns), right nodes C..2C-1 (output columns).
    adj: List[List[Tuple[int, bool]]] = [[] for _ in range(2 * C)]
    for e in range(E):
        adj[c_in[e]].append((e, True))
        adj[C + c_out[e]].append((e, False))
    ptr = [0] * (2 * C)
    used = np.zeros(E, dtype=bool)
    side_a: List[int] = []
    side_b: List[int] = []
    for start in range(2 * C):
        while ptr[start] < len(adj[start]):
            # Hierholzer: walk until we return to start; edges alternate
            # L->R / R->L, so assign by traversal direction.
            v = start
            path: List[Tuple[int, bool]] = []
            while True:
                advanced = False
                while ptr[v] < len(adj[v]):
                    e, fwd = adj[v][ptr[v]]
                    ptr[v] += 1
                    if used[e]:
                        continue
                    used[e] = True
                    path.append((e, fwd))
                    v = (C + c_out[e]) if fwd else c_in[e]
                    advanced = True
                    break
                if not advanced:
                    break
            for e, fwd in path:
                (side_a if fwd else side_b).append(e)
    assert len(side_a) == len(side_b) == E // 2, (len(side_a), len(side_b))
    return np.array(side_a, dtype=np.int64), np.array(side_b, dtype=np.int64)


def _matchings(c_in: np.ndarray, c_out: np.ndarray, C: int, d: int
               ) -> List[np.ndarray]:
    """Decompose a d-regular bipartite multigraph into d perfect matchings
    (d a power of two). Returns a list of edge-index arrays, each of
    length C."""
    if d == 1:
        return [np.arange(len(c_in), dtype=np.int64)]
    ia, ib = _euler_split(c_in, c_out, C)
    out = []
    for idx in (ia, ib):
        for m in _matchings(c_in[idx], c_out[idx], C, d // 2):
            out.append(idx[m])
    return out


def decompose_grid_perm(perm: np.ndarray, R: int, C: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """perm: int[R*C], out_flat[k] = in_flat[perm[k]], flat = r*C + c.
    Returns (s1, s2, s3) int32[R, C] stage index maps (see module doc).
    Requires R to be a power of two (true for all our n2 tiles)."""
    assert R & (R - 1) == 0, "R must be a power of two (Euler splitting)"
    src = np.asarray(perm, dtype=np.int64).reshape(R, C)
    r_in = src // C
    c_in_grid = src % C
    # one edge per output cell, ordered e = r_out*C + c_out
    c_in = c_in_grid.ravel()
    c_out = np.tile(np.arange(C, dtype=np.int64), R)
    r_out = np.repeat(np.arange(R, dtype=np.int64), C)
    s1 = np.zeros((R, C), dtype=np.int32)
    s2 = np.zeros((R, C), dtype=np.int32)
    s3 = np.zeros((R, C), dtype=np.int32)
    for slot, m in enumerate(_matchings(c_in, c_out, C, R)):
        # matching `m`: one edge per input column and per output column,
        # routed through intermediate row `slot`.
        ci = c_in[m]
        co = c_out[m]
        s1[slot, ci] = r_in.ravel()[m]       # t1[slot, ci] = in[r_in, ci]
        s2[slot, co] = ci                    # t2[slot, co] = t1[slot, ci]
        s3[r_out[m], co] = slot              # out[r_out, co] = t2[slot, co]
    return s1, s2, s3


def apply_staged_np(x: np.ndarray, s1, s2, s3) -> np.ndarray:
    """Reference application (numpy), for tests."""
    t1 = np.take_along_axis(x, s1.astype(np.int64)[None]
                            if x.ndim == 3 else s1.astype(np.int64), axis=-2)
    t2 = np.take_along_axis(t1, s2.astype(np.int64)[None]
                            if x.ndim == 3 else s2.astype(np.int64), axis=-1)
    return np.take_along_axis(t2, s3.astype(np.int64)[None]
                              if x.ndim == 3 else s3.astype(np.int64), axis=-2)
