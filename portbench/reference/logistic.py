"""Logistic regression under encryption, computed plainly on `ckks.RefCkks`:
the requests of the `helr_iter` and `logreg_sigmoid3` traffic.

  helr_steps(rows, features)   the rotation steps of HELR's sums
  helr_prep(ref, level, scale, rows, features, blocks, gamma, eta)
                               its rotation keys (in helr_steps' order),
                               mask, constants and scales
  helr_iteration(ref, Z, beta, v, prep)
                               one NAG iteration of HELR (Han, Hong, Cheon,
                               Park, AAAI-19) on the mini-batch Z, a list
                               of block ciphertexts: (beta', v'), [2,
                               level-6, N] each
  helr_float(z, beta, v, gamma, eta)
                               the same step in float64 on the clear data
  logreg_prep(ref, w, b, level, scale), logreg_sigmoid3(ref, ct, prep)
                               logistic-regression inference: the slot sum
                               of w x + b, then the degree-3 sigmoid,
                               [2, level-3, N]

Every operation is one whole ciphertext operation of RefCkks at a time
(no batch over the blocks, no hoisting), and the squaring, the products
by constants, the adds and the mod-drop are written here from RefCkks's
primitives. The scale bookkeeping is HELR's: each product's scale is the
product of its operands' over the prime a rescale drops, and a constant is
encoded at the scale that makes the terms of a sum meet. Imports nothing
of the measured program.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

# the sigmoid's degree-3 polynomial: c0 + c1 t + c3 t^3 (|t| <~ 6)
SIGMOID3 = (0.5, 0.197, -0.004)


# ---- operations from RefCkks's primitives --------------------------------

def const_col(ref, value: float, level: int, mult: float) -> torch.Tensor:
    """round(value * mult) mod each of the first `level` primes: int64
    [level, 1]."""
    c = int(round(value * mult))
    return torch.tensor([c % int(q) for q in ref.p.qs[:level]],
                        dtype=torch.int64, device=ref.dev)[:, None]


def const_pt(ref, value: float, level: int, scale: float) -> torch.Tensor:
    """The plaintext of `value` in every slot at (level, scale): round(value
    * scale) as the constant coefficient, eval domain [level, N]."""
    m = np.zeros(ref.p.n, dtype=np.int64)
    m[0] = int(round(value * scale))
    idx = ref.main_idx(level)
    return ref.ntt(ref.signed_to_rns(m, idx), idx)


def cmult(ref, ct: torch.Tensor, c: torch.Tensor, level: int) -> torch.Tensor:
    """Both components times a constant column (const_col), no rescale."""
    return ref.mulmod(ct, c[None], ref.qcol(ref.main_idx(level))[None])


def padd(ref, ct: torch.Tensor, pt: torch.Tensor, level: int) -> torch.Tensor:
    """The plaintext pt added to c0."""
    q = ref.qcol(ref.main_idx(level))
    return torch.stack([ref.addmod(ct[0], pt, q), ct[1]])


def mod_drop(ct: torch.Tensor, level: int) -> torch.Tensor:
    """The ciphertext on its first `level` primes (no rescale)."""
    return ct[:, :level]


def hsquare(ref, a: torch.Tensor, level: int) -> torch.Tensor:
    """d0 = c0^2, d1 = 2 c0 c1, d2 = c1^2, the key switch of d2, the
    relinearisation add, the rescale: [2, level, N] -> [2, level-1, N]."""
    q = ref.qcol(ref.main_idx(level))
    d0 = ref.mulmod(a[0], a[0], q)
    cross = ref.mulmod(a[0], a[1], q)
    d1 = ref.addmod(cross, cross, q)
    d2 = ref.mulmod(a[1], a[1], q)
    e0, e1 = ref.keyswitch(d2, ref.relin_key, level)
    return ref.rescale(torch.stack([ref.addmod(d0, e0, q),
                                    ref.addmod(d1, e1, q)]), level)


def rotate_add(ref, a: torch.Tensor, steps: Sequence[int],
               level: int) -> torch.Tensor:
    """a + rot(a, s) for each step s in turn."""
    for s in steps:
        a = ref.hadd(a, ref.hrotate(a, s, level), level)
    return a


def sigmoid3_scales(qs, scale_bits: int, level_t: int, s_t: float):
    """(delta, delta_adj, s_cub) of the sigmoid on t at (level_t, s_t): t^2
    by a squaring (-> level_t-1), t^3 = t t^2 (-> level_t-2), the cubic
    coefficient at delta, the linear one at delta_adj = s_cub / s_t."""
    s_t2 = s_t * s_t / qs[level_t - 1]
    s_t3 = s_t2 * s_t / qs[level_t - 2]
    delta = float(1 << scale_bits)
    s_cub = s_t3 * delta
    return delta, s_cub / s_t, s_cub


def sigmoid3(ref, t: torch.Tensor, level: int, lin: torch.Tensor,
             cub: torch.Tensor, half: torch.Tensor) -> torch.Tensor:
    """half + lin t + cub t^3 of t [2, level, N] (lin and cub: constant
    columns at level-2, half: a constant plaintext): [2, level-2, N]."""
    t2 = hsquare(ref, t, level)
    t3 = ref.hmult(mod_drop(t, level - 1), t2, level - 1)
    y = ref.hadd(cmult(ref, mod_drop(t, level - 2), lin, level - 2),
                 cmult(ref, t3, cub, level - 2), level - 2)
    return padd(ref, y, half, level - 2)


# ---- HELR ----------------------------------------------------------------

def helr_steps(rows: int, features: int):
    """(row sum, replication, sample sum) steps: 1, 2, .., features/2;
    their negatives; features, 2 features, .., rows/2 features."""
    row = [1 << j for j in range(features.bit_length() - 1)]
    return (row, [-s for s in row],
            [features << j for j in range(rows.bit_length() - 1)])


def helr_scales(qs, scale_bits: int, level: int, scale: float):
    """(delta, s_t, delta_adj, s_cub, s_g, s_out) for Z, beta and v at
    (level, scale): the scores (-> level-1), the mask at delta and a
    rescale (-> level-2: t), the sigmoid (-> level-4), the gradient
    (-> level-5), the update's terms at s_g delta and a rescale
    (-> level-6)."""
    delta = float(1 << scale_bits)
    s_a = scale * scale / qs[level - 1]
    s_t = s_a * delta / qs[level - 2]
    _, delta_adj, s_cub = sigmoid3_scales(qs, scale_bits, level - 2, s_t)
    s_g = s_cub * scale / qs[level - 5]
    s_out = s_g * delta / qs[level - 6]
    return delta, s_t, delta_adj, s_cub, s_g, s_out


@dataclasses.dataclass
class HelrPrep:
    level: int
    steps: tuple
    pt_mask: torch.Tensor
    lin: torch.Tensor
    cub: torch.Tensor
    half: torch.Tensor
    k_g: List[torch.Tensor]  # beta', v'
    k_v: List[torch.Tensor]
    k_b: torch.Tensor
    s_out: float


def helr_prep(ref, level: int, scale: float, rows: int, features: int,
              blocks: int, gamma: float, eta: float) -> HelrPrep:
    """The rotation keys (row sum, replication, sample sum), the column
    mask at level-1, and the constants of helr_iteration; RefCkks holds
    its relinearisation key."""
    qs = ref.p.qs
    steps = helr_steps(rows, features)
    for group in steps:
        for s in group:
            ref.gen_rotation_key(s)
    delta, s_t, delta_adj, s_cub, s_g, s_out = helr_scales(
        qs, ref.p.scale_bits, level, scale)
    c0, c1, c3 = SIGMOID3
    n = blocks * rows
    L4, L5 = level - 4, level - 5
    mask = np.zeros(ref.p.n // 2)
    mask[::features] = 1.0
    s_sum = s_g * delta
    return HelrPrep(
        level, steps, ref.encode_complex(mask, level - 1, delta),
        const_col(ref, -c1, L4, delta_adj), const_col(ref, -c3, L4, delta),
        const_pt(ref, c0, L4, s_cub),
        [const_col(ref, gamma / n, L5, delta),
         const_col(ref, (1 - eta) * gamma / n, L5, delta)],
        [const_col(ref, 1.0, L5, s_sum / scale),
         const_col(ref, 1 - eta, L5, s_sum / scale)],
        const_col(ref, eta, L5, s_sum / scale), s_out)


def helr_iteration(ref, Z: Sequence[torch.Tensor], beta: torch.Tensor,
                   v: torch.Tensor, prep: HelrPrep):
    """One NAG iteration on the blocks Z ([2, level, N] each, row r of
    block k holding z_i = y_i (1, x_i) of sample i = k rows + r) from
    beta, v ([2, level, N], the weights tiled over the rows):
    t = z . v, s = sigmoid3(-t), G = sum_i s_i z_i, beta' = v + gamma/n G,
    v' = (1-eta) beta' + eta beta. Returns (beta', v') at level-6."""
    L = prep.level
    row, rep, ssum = prep.steps
    gs = []
    for z in Z:
        a = rotate_add(ref, ref.hmult(z, v, L), row, L - 1)
        t = ref.rescale(ref.pmult(a, prep.pt_mask, L - 1), L - 1)
        t = rotate_add(ref, t, rep, L - 2)
        s = sigmoid3(ref, t, L - 2, prep.lin, prep.cub, prep.half)
        gs.append(ref.hmult(s, mod_drop(z, L - 4), L - 4))
    L5 = L - 5
    G = gs[0]
    for g in gs[1:]:
        G = ref.hadd(G, g, L5)
    G = rotate_add(ref, G, ssum, L5)
    v5, b5 = mod_drop(v, L5), mod_drop(beta, L5)
    beta_pre = ref.hadd(cmult(ref, G, prep.k_g[0], L5),
                        cmult(ref, v5, prep.k_v[0], L5), L5)
    v_pre = ref.hadd(ref.hadd(cmult(ref, G, prep.k_g[1], L5),
                              cmult(ref, v5, prep.k_v[1], L5), L5),
                     cmult(ref, b5, prep.k_b, L5), L5)
    return ref.rescale(beta_pre, L5), ref.rescale(v_pre, L5)


def helr_float(z: np.ndarray, beta: np.ndarray, v: np.ndarray, gamma: float,
               eta: float):
    """The same step in float64: z [n, features] the samples' y_i (1, x_i),
    beta and v [features]. Returns (beta', v')."""
    c0, c1, c3 = SIGMOID3
    t = z @ v
    s = c0 - c1 * t - c3 * t ** 3
    beta1 = v + gamma / z.shape[0] * (s @ z)
    return beta1, (1 - eta) * beta1 + eta * beta


# ---- logistic-regression inference ---------------------------------------

@dataclasses.dataclass
class LogregPrep:
    level: int
    pt_w: torch.Tensor
    pt_b: torch.Tensor
    lin: torch.Tensor
    cub: torch.Tensor
    half: torch.Tensor
    s_out: float


def logreg_prep(ref, w: np.ndarray, b: float, level: int,
                scale: float) -> LogregPrep:
    """The rotation keys 1, 2, .., slots/2, the weights' plaintext, the
    bias at scale^2 and the sigmoid's constants."""
    p = ref.p
    for j in range((p.n // 2).bit_length() - 1):
        ref.gen_rotation_key(1 << j)
    s_prod = scale * scale / p.qs[level - 1]
    _, delta_adj, s_cub = sigmoid3_scales(p.qs, p.scale_bits, level - 1,
                                          s_prod)
    c0, c1, c3 = SIGMOID3
    L4 = level - 3
    return LogregPrep(level, ref.encode_complex(w, level, scale),
                      const_pt(ref, b, level, scale * scale),
                      const_col(ref, c1, L4, delta_adj),
                      const_col(ref, c3, L4, 1 << p.scale_bits),
                      const_pt(ref, c0, L4, s_cub), s_cub)


def logreg_sigmoid3(ref, ct: torch.Tensor, prep: LogregPrep) -> torch.Tensor:
    """The score t = sum over the slots of w x, + b (the rotations before
    the one rescale), then c0 + c1 t + c3 t^3: [2, level-3, N]."""
    L = prep.level
    acc = ref.pmult(ct, prep.pt_w, L)
    acc = rotate_add(ref, acc, [1 << j for j in
                                range((ref.p.n // 2).bit_length() - 1)], L)
    t = ref.rescale(padd(ref, acc, prep.pt_b, L), L)
    return sigmoid3(ref, t, L - 1, prep.lin, prep.cub, prep.half)

