"""The requests of portbench's traffic, computed plainly on `ckks.RefCkks`.

  bsgs_diagonals(M, g, slots)  the d diagonals of M in BSGS order, each
                               pre-rotated by -g*j and tiled over the slots
  matvec_bsgs(ref, ct, pts, d, g, level)
                               y = sum_j rot(sum_i pt_{g*j+i} * rot(x, i), g*j)
                               with one whole hrotate per rotation (no
                               hoisting), [2, level, N], no rescale

The order of the BSGS sum is the one the encoded diagonals need (the
pre-rotation makes one giant rotation finish a group); everything else is
each operation's definition. Imports nothing of the measured program.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def bsgs_diagonals(M: np.ndarray, g: int, slots: int) -> np.ndarray:
    """[d, slots]: row g*j + i is M's diagonal k = g*j + i (entry t is
    M[t, (t + k) mod d]), rolled by g*j and tiled d-periodically."""
    d = M.shape[0]
    t = np.arange(d)
    rows = []
    for k in range(d):
        diag = M[t, (t + k) % d]
        rows.append(np.tile(np.roll(diag, g * (k // g)), slots // d))
    return np.stack(rows)


def matvec_bsgs(ref, ct: torch.Tensor, pts: Sequence[torch.Tensor], d: int,
                g: int, level: int) -> torch.Tensor:
    """ct [2, level, N], pts the d encoded diagonals [level, N] each."""
    baby = [ct] + [ref.hrotate(ct, i, level) for i in range(1, g)]
    acc = None
    for j in range(d // g):
        group = None
        for i in range(g):
            term = ref.pmult(baby[i], pts[g * j + i], level)
            group = term if group is None else ref.hadd(group, term, level)
        if j:
            group = ref.hrotate(group, g * j, level)
        acc = group if acc is None else ref.hadd(acc, group, level)
    return acc
