"""Encrypted linear algebra built on the engine op surface.

The port's copy of `homulator_tpu/linalg.py`, duck-typed on the engine
(any object with the CkksEngine op surface), so the same code runs on the
port's engine on either key-switch route:

  pack_vector / encrypt_vector   d-periodic slot packing (slot rotation
                                 by k realises the length-d cyclic
                                 rotation of the vector in every copy)
  bsgs_diagonals                 M's diagonals in BSGS order, each
                                 pre-rotated in the clear and packed
  bsgs_matvec                    y = M @ x, diagonal method with
                                 baby-step/giant-step rotations; the
                                 baby rotations share ONE ModUp via
                                 Halevi-Shoup hoisting
  sum_slots                      rotate-and-add reduction over all slots
  dot                            <x, w> replicated into every slot, with
                                 the reduction run at the PRE-rescale
                                 scale, so the key-switch noise of the
                                 log2(slots) rotations lands ~4 orders
                                 below the working scale

All functions are engine-level (one call per op) and exact about
level/scale bookkeeping.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .context import Ciphertext, Plaintext


def pack_vector(x: np.ndarray, slots: int) -> np.ndarray:
    """Tile a length-d vector d-periodically into `slots` slots
    (d must divide slots)."""
    x = np.asarray(x)
    d = x.shape[0]
    assert slots % d == 0, (d, slots)
    return np.tile(x, slots // d)


def bsgs_diagonals(M: np.ndarray, g: int, slots: int) -> np.ndarray:
    """The d diagonals of the d x d matrix M in BSGS order: row g*j + i
    is diagonal g*j + i, pre-rotated by -g*j so that one giant rotation
    finishes group j, packed d-periodically: [d, slots]."""
    d = M.shape[0]
    out = []
    for j in range(d // g):
        for i in range(g):
            k = g * j + i
            diag_k = np.array([M[t % d, (t + k) % d] for t in range(d)])
            out.append(pack_vector(np.roll(diag_k, g * j), slots))
    return np.stack(out)


def encrypt_vector(eng, x: np.ndarray, level: int,
                   scale: float) -> Ciphertext:
    """Encrypt a length-d vector packed d-periodically across all slots."""
    return eng.encrypt_complex(
        pack_vector(x, eng.params.n // 2), level, scale)


def bsgs_matvec(eng, ct_x: Ciphertext, M: np.ndarray, *,
                g: Optional[int] = None,
                rescale_out: bool = True) -> Ciphertext:
    """Encrypted y = M @ x for a public d x d matrix M and ct_x packed by
    encrypt_vector. Diagonal method with BSGS:

        y = sum_j rot( sum_i pdiag_{g*j+i} * rot(x, i), g*j )

    The g-1 baby rotations share one ModUp (eng.hrotate_hoisted); each
    giant group pays one key switch — d = g*(d/g) diagonals cost
    (g-1) hoisted + (d/g - 1) plain key switches instead of d-1. Returns
    level-1 (rescaled) unless rescale_out=False."""
    M = np.asarray(M)
    d = M.shape[0]
    assert M.shape == (d, d), M.shape
    slots = eng.params.n // 2
    assert slots % d == 0, (d, slots)
    if g is None:
        g = 1 << ((d.bit_length() - 1) // 2)
    assert d % g == 0, (d, g)
    level, scale = ct_x.level, ct_x.scale

    baby = {0: ct_x}
    steps = list(range(1, g))
    if steps:
        for s, ct in zip(steps, eng.hrotate_hoisted(ct_x, steps)):
            baby[s] = ct

    diags = bsgs_diagonals(M, g, slots)
    acc = None
    for j in range(d // g):
        group = None
        for i in range(g):
            pt = eng.plaintext_complex(diags[g * j + i], level, scale)
            term = eng.pmult(baby[i], pt)
            group = term if group is None else eng.hadd(group, term)
        if g * j != 0:
            group = eng.hrotate(group, g * j)
        acc = group if acc is None else eng.hadd(acc, group)
    return eng.rescale(acc) if rescale_out else acc


def sum_slots(eng, ct: Ciphertext) -> Ciphertext:
    """Rotate-and-add reduction: every slot becomes the sum over all
    slots (log2(slots) rotations)."""
    slots = eng.params.n // 2
    step = 1
    while step < slots:
        ct = eng.hadd(ct, eng.hrotate(ct, step))
        step <<= 1
    return ct


def dot(eng, ct_x: Ciphertext, w: np.ndarray, *,
        bias: float = 0.0) -> Ciphertext:
    """<x, w> + bias replicated into every slot. w is a cleartext vector
    over ALL slots (length n/2; use pack_vector for shorter vectors: the
    result is then (slots/d) x the length-d dot product).

    The reduction runs BEFORE the rescale, at the product scale^2, so
    the log2(slots) rotation key switches contribute ~1e-10 of slot
    error instead of ~1e-2 (see module docstring). One rescale drops to
    the working scale; level decreases by 1."""
    slots = eng.params.n // 2
    w = np.asarray(w)
    assert w.shape == (slots,), w.shape
    pt_w = eng.plaintext_complex(w, ct_x.level, ct_x.scale)
    prod = eng.pmult(ct_x, pt_w)           # scale^2, same level
    total = sum_slots(eng, prod)           # reduction at scale^2
    if bias:
        pt_b = eng.plaintext_complex(
            np.full(slots, bias), ct_x.level, total.scale)
        total = eng.padd(total, pt_b)
    return eng.rescale(total)
