"""The encrypted workloads of the JAX package's set-B programs, on the port.

The counterparts of the two programs that `scripts/bench_workload.py`
(a d x d BSGS matrix-vector product, one dense layer under encryption)
and `scripts/bench_logreg.py` (logistic-regression inference: a slot-sum
score and a degree-3 sigmoid) hold as closures inside `main()`, and one
the JAX package does not have: an iteration of HELR, logistic-regression
training by Nesterov's accelerated gradient on an encrypted mini-batch
(Han, Hong, Cheon and Park, "Logistic Regression on Homomorphic Encrypted
Data at Scale", AAAI-19), its blocks of samples run as batched ops. Each
workload is a host-prep function, which makes the keys of its rotation
steps, encodes its plaintexts and constants and takes the per-level
tables from the engine's context (all on the engine's device), and a
device function, plain eager torch over the port's op graphs
(`api.hrotate_hoisted_graph`, `hrotate_graph`, `hsquare_graph`,
`hmult_graph`, `ops/rescale.rescale_poly`) and `ops/modmath.py`. The
device functions make no host tensor and never synchronise, so a CUDA
graph can capture them. They follow the engine's key-switch route
(`api.USE_FUSED_HPIP`, the context's `ntt_mode`) and give the same bits
on every route. On the accelerated route each records its span
(stats.span: `matvec_bsgs`, `logreg_sigmoid3`) around the op graphs'
own, and the matvec's plaintext products are `pt_products` spans. These
spans and every span under them take no CUDA events: a workload's launches
pace its device, so an event pair there would time the device's waits,
and no reader takes a device time inside a workload. HELR's iteration is
the exception: its batched ops keep the device busy beyond the host's
enqueue, so its span `helr_iteration`, its steps (`helr_rowsum`,
`helr_replicate`, `helr_sigmoid`, `helr_gradient`, `helr_update`) and the
op and phase spans under them are timed.

The JAX programs' Montgomery products by pre-lifted plaintexts and
constants (`to_mont`, `mont_mul`) are products of standard residues here
(`mulmod`): the same bits. Their TPU workarounds (the `lax.scan` over
giant groups and rotations, the `fori_loop` of chained timing, and the
re-extension of logreg's output to the input level that lets the loop
chain) have no counterpart.

  native_engine(params, seed, device) a CkksEngine on the native host core
  matvec_prep(eng, M, level, scale, g) -> MatvecPrep
  matvec_bsgs(ct, prep)     y = M @ x, [2, level] at scale^2 (no rescale)
  logreg_prep(eng, w, b, level, scale) -> LogregPrep
  logreg_sigmoid3(ct, prep) 0.5 + 0.197 t - 0.004 t^3 of t = <x, w> + b
                            in every slot, [2, level - 3] at prep.s_out
  helr_prep(eng, level, scale, rows, features, blocks, gamma, eta)
                            -> HelrPrep
  helr_iteration(Z, beta, v, prep)
                            one NAG step on the mini-batch Z [blocks, 2,
                            level]: beta' and v' stacked, [2, 2, level - 6]
                            at prep.s_out
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from .api import (
    CkksEngine, hmult_graph, hrotate_graph, hrotate_hoisted_graph,
    hsquare_graph, route_span,
)
from .context import KeySwitchLevelTables, RescaleTables
from .linalg import bsgs_diagonals
from .ops.modmath import col, modadd, mulmod
from .ops.rescale import rescale_poly
from .refimpl import RefCkks

# the sigmoid's degree-3 polynomial (|t| <~ 6)
SIGMOID3 = (0.5, 0.197, -0.004)


def native_engine(params, seed: int = 0, device="cuda",
                  ntt_mode: str = "auto") -> CkksEngine:
    """CkksEngine(params, seed, device, ntt_mode) whose host engine (key
    generation, encoding, encryption, decryption) runs the native core:
    RefCkks(use_native=True), which builds it first if it is not built
    and raises if that fails. The same bits as the numpy path."""
    eng = CkksEngine(params, seed, device, ntt_mode)
    eng.ref = RefCkks(params, seed, use_native=True)
    return eng


def _rotation_keys(eng, steps: Sequence[int]):
    """(perms, keys) of the rotations by `steps`, making missing keys."""
    for s in steps:
        if s not in eng.rot_keys:
            eng.gen_rotation_key(s)
    perms = [eng.dc.automorph_perm(eng.params.galois_elt(s)) for s in steps]
    return perms, [eng.rot_keys[s] for s in steps]


@dataclasses.dataclass
class MatvecPrep:
    """matvec_bsgs's inputs besides the ciphertext, on the engine's
    device. pt_groups: int32 [d/g, g, level, n2, n1] diagonal plaintexts;
    baby_*: the rotations by 1..g-1; giant_*: by g*j, j = 1..d/g-1."""

    level: int
    scale: float
    d: int
    pt_groups: torch.Tensor
    baby_perms: List[torch.Tensor]
    baby_keys: List[torch.Tensor]
    giant_perms: List[torch.Tensor]
    giant_keys: List[torch.Tensor]
    kt: KeySwitchLevelTables
    q: torch.Tensor  # int64 [level, 1, 1]

    @property
    def out_scale(self) -> float:
        return self.scale * self.scale

    @property
    def keyswitches(self) -> int:
        return len(self.baby_keys) + len(self.giant_keys)


def matvec_steps(d: int, g: int):
    """(baby steps, giant steps) of a d x d BSGS matvec with giant step g."""
    return list(range(1, g)), [g * j for j in range(1, d // g)]


def logreg_steps(slots: int):
    """The rotation steps of the slot sum: 1, 2, 4, .., slots/2."""
    return [1 << i for i in range(slots.bit_length() - 1)]


def matvec_prep(eng, M: np.ndarray, level: int, scale: float,
                g: int) -> MatvecPrep:
    """Keys, diagonal encodes and tables of a BSGS matvec by the public
    d x d matrix M (d | slots, g | d) of a ciphertext at (level, scale)."""
    M = np.asarray(M)
    d = M.shape[0]
    slots = eng.params.n // 2
    if M.shape != (d, d) or slots % d or d % g:
        raise ValueError(f"matvec: M {M.shape}, g {g}, {slots} slots")
    baby_steps, giant_steps = matvec_steps(d, g)
    baby_perms, baby_keys = _rotation_keys(eng, baby_steps)
    giant_perms, giant_keys = _rotation_keys(eng, giant_steps)
    pts = [eng.plaintext_complex(v, level, scale).data
           for v in bsgs_diagonals(M, g, slots)]
    pt_groups = torch.stack(pts).reshape((d // g, g) + pts[0].shape)
    return MatvecPrep(level, scale, d, pt_groups, baby_perms, baby_keys,
                      giant_perms, giant_keys, eng.dc.keyswitch_tables(level),
                      col(eng.dc.q_level(level)))


def _tree_sum(t: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The modular sum of t's leading axis, as a tree of adds: int32."""
    while t.shape[0] > 1:
        h = t.shape[0] // 2
        head = modadd(t[:h], t[h:2 * h], q)
        t = torch.cat([head, t[2 * h:]]) if t.shape[0] % 2 else head
    return t[0].to(torch.int32)


def _rotate_add(a: torch.Tensor, perms, keys, kt: KeySwitchLevelTables,
                q: torch.Tensor) -> torch.Tensor:
    """a + rot(a, s) for each step s in turn: one hrotate_graph each, on
    the whole batch a."""
    for perm, key in zip(perms, keys):
        a = modadd(a, hrotate_graph(a, perm, key, kt), q).to(torch.int32)
    return a


def _group_sum(pt_group: torch.Tensor, baby: torch.Tensor,
               q: torch.Tensor, kt: KeySwitchLevelTables) -> torch.Tensor:
    """sum_i pdiag_i * baby_i over both components: one product by the
    stacked diagonals [g, level, ...] and a modular-add tree; a
    `pt_products` span."""
    with route_span("pt_products", kt):
        return _tree_sum(mulmod(baby, pt_group[:, None], q), q)


def matvec_bsgs(ct: torch.Tensor, prep: MatvecPrep) -> torch.Tensor:
    """y = sum_j rot( sum_i pdiag_{g*j+i} * rot(x, i), g*j ): the baby
    rotations share one ModUp (hoisted), each giant group pays one key
    switch. ct: int32 [2, level, n2, n1]; returns the same shape, at
    prep.out_scale."""
    q, kt = prep.q, prep.kt
    with route_span("matvec_bsgs", kt, timed=False):
        baby = ct[None]
        if prep.baby_keys:
            rots = hrotate_hoisted_graph(ct, prep.baby_perms, prep.baby_keys,
                                         kt)
            baby = torch.cat([baby, rots])
        acc = _group_sum(prep.pt_groups[0], baby, q, kt)
        for pt_group, perm, key in zip(prep.pt_groups[1:], prep.giant_perms,
                                       prep.giant_keys):
            rot = hrotate_graph(_group_sum(pt_group, baby, q, kt), perm, key,
                                kt)
            acc = modadd(acc, rot, q).to(torch.int32)
        return acc


@dataclasses.dataclass
class LogregPrep:
    """logreg_sigmoid3's inputs besides the ciphertext, on the engine's
    device: the weights' plaintext, the bias at scale^2, the rotations by
    1, 2, 4, .., slots/2, the tables of the levels level (rotations,
    rescale), level-1 (hsquare) and level-2 (hmult), the linear and cubic
    constants' residues and 0.5 at s_out."""

    level: int
    scale: float
    s_out: float
    pt_w: torch.Tensor
    pt_b: torch.Tensor
    perms: List[torch.Tensor]
    keys: List[torch.Tensor]
    relin_key: torch.Tensor
    kt1: KeySwitchLevelTables
    rs1: RescaleTables
    kt2: KeySwitchLevelTables
    kt3: KeySwitchLevelTables
    c_lin: torch.Tensor  # int64 [level-3, 1, 1]
    c_cub: torch.Tensor  # int64 [level-3, 1, 1]
    pt_half: torch.Tensor
    q1: torch.Tensor  # int64 [level, 1, 1]
    q4: torch.Tensor  # int64 [level-3, 1, 1]

    @property
    def out_level(self) -> int:
        return self.level - 3

    @property
    def keyswitches(self) -> int:
        return len(self.keys) + 2  # the rotations, hsquare, hmult


def sigmoid3_scales(params, level_t: int, s_t: float):
    """(delta, delta_adj, s_cub) of SIGMOID3 on t at (level_t, s_t): t^2 by
    hsquare (-> level_t - 1), t^3 = t * t^2 by hmult (-> level_t - 2), the
    cubic coefficient at delta. The linear branch (t) and the cubic one
    differ in scale, so the linear coefficient is encoded at delta_adj =
    s_cub / s_t: both land on s_cub exactly."""
    s_t2 = s_t * s_t / params.qs[level_t - 1]   # after hsquare
    s_t3 = s_t2 * s_t / params.qs[level_t - 2]  # after hmult
    delta = float(1 << params.scale_bits)
    s_cub = s_t3 * delta
    return delta, s_cub / s_t, s_cub


def logreg_scales(params, level: int, scale: float):
    """The scale bookkeeping of bench_logreg.py: (delta, delta_adj, s_out),
    sigmoid3_scales of t after the pmult by w and one rescale."""
    s_prod = scale * scale / params.qs[level - 1]  # after pmult + rescale
    return sigmoid3_scales(params, level - 1, s_prod)


def _const(eng, value: float, level: int, mult: float) -> torch.Tensor:
    """Residues of round(value * mult) over the first `level` primes, as
    an int64 [level, 1, 1] column (a product by it is the JAX program's
    Montgomery product by the lifted constant)."""
    qs = eng.params.q_arr[:level].astype(np.int64)
    return col(eng.dc.tensor(np.int64(round(value * mult)) % qs))


def _constant_pt(eng, value: float, level: int, s: float) -> torch.Tensor:
    """The plaintext of `value` in every slot at (level, s): round(value *
    s) as the constant coefficient."""
    m = np.zeros(eng.params.n, dtype=np.int64)
    m[0] = int(round(value * s))
    return eng.plaintext_ints(m, level, s).data


def logreg_prep(eng, w: np.ndarray, b: float, level: int,
                scale: float) -> LogregPrep:
    """Keys, encodes, constants and tables of logreg_sigmoid3 for the
    weights w (one per slot) and bias b, of a ciphertext at (level,
    scale); the engine holds its relinearisation key."""
    p = eng.params
    slots = p.n // 2
    if eng.relin_key is None:
        raise RuntimeError("logreg_prep: call keygen() first")
    perms, keys = _rotation_keys(eng, logreg_steps(slots))
    delta, delta_adj, s_out = logreg_scales(p, level, scale)
    c0, c1, c3 = SIGMOID3
    L4 = level - 3
    dc = eng.dc
    return LogregPrep(
        level, scale, s_out,
        pt_w=eng.plaintext_complex(w, level, scale).data,
        # b joins before the rescale, at scale^2 (0.3 * 2^58 < 2^63)
        pt_b=_constant_pt(eng, b, level, scale * scale),
        perms=perms, keys=keys, relin_key=eng.relin_key,
        kt1=dc.keyswitch_tables(level), rs1=dc.rescale_tables(level),
        kt2=dc.keyswitch_tables(level - 1), kt3=dc.keyswitch_tables(level - 2),
        c_lin=_const(eng, c1, L4, delta_adj),
        c_cub=_const(eng, c3, L4, delta),
        pt_half=_constant_pt(eng, c0, L4, s_out),
        q1=col(dc.q_level(level)), q4=col(dc.q_level(L4)))


def logreg_sigmoid3(ct: torch.Tensor, prep: LogregPrep) -> torch.Tensor:
    """score: pmult by w, then the rotate-and-add reduction BEFORE the one
    rescale (at scale^2 the rotations' key-switch noise lands ~4 orders
    below the working scale; after it, one TPU run read 8.6e-3 against
    the 1e-2 gate), + b at scale^2, rescale; sigmoid: t^2 by hsquare
    (level-1 -> level-2), t^3 = t * t^2 by hmult (-> level-3), the linear
    and cubic constants (the linear one on the rows that the drop to
    level-3 keeps), + 0.5.
    ct: int32 [2, level, n2, n1]; returns int32 [2, level-3, n2, n1] at
    prep.s_out."""
    L3, L4 = prep.level - 2, prep.level - 3
    with route_span("logreg_sigmoid3", prep.kt1, timed=False):
        acc = _rotate_add(mulmod(ct, prep.pt_w, prep.q1).to(torch.int32),
                          prep.perms, prep.keys, prep.kt1, prep.q1)
        c0 = modadd(acc[0], prep.pt_b, prep.q1).to(torch.int32)
        t = torch.stack([rescale_poly(c0, prep.rs1),
                         rescale_poly(acc[1], prep.rs1)])
        t2 = hsquare_graph(t, prep.relin_key, prep.kt2)
        t3 = hmult_graph(t[:, :L3], t2, prep.relin_key, prep.kt3)
        lin = mulmod(t[:, :L4], prep.c_lin, prep.q4)
        cub = mulmod(t3, prep.c_cub, prep.q4)
        y = modadd(lin, cub, prep.q4)
        y0 = modadd(y[0], prep.pt_half, prep.q4)
        return torch.stack([y0, y[1]]).to(torch.int32)


# ---- HELR: one NAG iteration of logistic-regression training ------------

def helr_steps(rows: int, features: int):
    """(row sum, replication, sample sum) rotation steps of a block of
    `rows` samples x `features` slots a row: 1, 2, .., features/2; their
    negatives; features, 2 features, .., rows/2 features."""
    row = [1 << j for j in range(features.bit_length() - 1)]
    return (row, [-s for s in row],
            [features << j for j in range(rows.bit_length() - 1)])


@dataclasses.dataclass
class HelrPrep:
    """helr_iteration's inputs besides the ciphertexts, on the engine's
    device. Levels L = level (Z, beta, v), L-1 (the sample scores), L-2
    (masked and replicated: t), L-3 (t^2), L-4 (t^3 and the sigmoid),
    L-5 (the gradient) and L-6 (the result); kt_<l>: the key-switch
    tables of level L-l; the rotations' perms and keys by step (helr_steps);
    the column mask, the sigmoid's constants, and the update's constant
    columns k_g, k_v ([2, 1, L-5, 1, 1]: beta' then v') and k_b."""

    level: int
    s_out: float
    relin_key: torch.Tensor
    row_perms: List[torch.Tensor]
    row_keys: List[torch.Tensor]
    rep_perms: List[torch.Tensor]
    rep_keys: List[torch.Tensor]
    sum_perms: List[torch.Tensor]
    sum_keys: List[torch.Tensor]
    kt_0: KeySwitchLevelTables
    kt_1: KeySwitchLevelTables
    kt_2: KeySwitchLevelTables
    kt_3: KeySwitchLevelTables
    kt_4: KeySwitchLevelTables
    kt_5: KeySwitchLevelTables
    rs_1: RescaleTables
    rs_5: RescaleTables
    pt_mask: torch.Tensor
    c_lin: torch.Tensor  # int64 [L-4, 1, 1]
    c_cub: torch.Tensor
    pt_half: torch.Tensor
    k_g: torch.Tensor    # int64 [2, 1, L-5, 1, 1]
    k_v: torch.Tensor
    k_b: torch.Tensor    # int64 [L-5, 1, 1]
    q1: torch.Tensor     # int64 [L-1, 1, 1]
    q2: torch.Tensor
    q4: torch.Tensor
    q5: torch.Tensor

    @property
    def out_level(self) -> int:
        return self.level - 6


def helr_scales(params, level: int, scale: float):
    """HELR's scale bookkeeping for Z, beta and v at (level, scale): the
    scores after the product (-> level-1) and the mask at delta with one
    rescale (-> level-2) give t's scale s_t; sigmoid3_scales gives the
    sigmoid's s_cub at level-4; the gradient's product gives s_g at
    level-5; the update's products bring each term to s_g * delta, and one
    rescale to level-6 gives s_out. Returns (delta, s_t, delta_adj, s_cub,
    s_g, s_out)."""
    qs = params.qs
    delta = float(1 << params.scale_bits)
    s_a = scale * scale / qs[level - 1]
    s_t = s_a * delta / qs[level - 2]
    _, delta_adj, s_cub = sigmoid3_scales(params, level - 2, s_t)
    s_g = s_cub * scale / qs[level - 5]
    s_out = s_g * delta / qs[level - 6]
    return delta, s_t, delta_adj, s_cub, s_g, s_out


def helr_prep(eng, level: int, scale: float, rows: int, features: int,
              blocks: int, gamma: float, eta: float) -> HelrPrep:
    """Keys, encodes, constants and tables of helr_iteration on
    mini-batches of blocks x rows samples, `features` slots each (rows x
    features = the slots, both powers of two), with Z, beta and v at
    (level, scale); the learning rate gamma and the momentum eta. The
    engine holds its relinearisation key; the rotation keys are made in
    helr_steps' order."""
    p = eng.params
    slots = p.n // 2
    if eng.relin_key is None:
        raise RuntimeError("helr_prep: call keygen() first")
    if rows * features != slots or rows & (rows - 1) or \
            features & (features - 1) or level < 7:
        raise ValueError(f"helr: {rows} rows x {features} features in "
                         f"{slots} slots at level {level}")
    row, rep, ssum = helr_steps(rows, features)
    row_perms, row_keys = _rotation_keys(eng, row)
    rep_perms, rep_keys = _rotation_keys(eng, rep)
    sum_perms, sum_keys = _rotation_keys(eng, ssum)
    delta, s_t, delta_adj, s_cub, s_g, s_out = helr_scales(p, level, scale)
    c0, c1, c3 = SIGMOID3
    n = blocks * rows
    L1, L4, L5 = level - 1, level - 4, level - 5
    mask = np.zeros(slots)
    mask[::features] = 1.0
    s_sum = s_g * delta
    dc = eng.dc
    kt = [dc.keyswitch_tables(level - k) for k in range(6)]

    def pair(v0, v1, mult):
        return torch.stack([_const(eng, v0, L5, mult),
                            _const(eng, v1, L5, mult)])[:, None]

    return HelrPrep(
        level, s_out, eng.relin_key,
        row_perms, row_keys, rep_perms, rep_keys, sum_perms, sum_keys,
        *kt, rs_1=dc.rescale_tables(L1), rs_5=dc.rescale_tables(L5),
        pt_mask=eng.plaintext_complex(mask, L1, delta).data,
        # sigma3(-t) = c0 - c1 t - c3 t^3
        c_lin=_const(eng, -c1, L4, delta_adj),
        c_cub=_const(eng, -c3, L4, delta),
        pt_half=_constant_pt(eng, c0, L4, s_cub),
        # beta' = v + gamma/n G, v' = (1-eta) beta' + eta beta
        k_g=pair(gamma / n, (1 - eta) * gamma / n, delta),
        k_v=pair(1.0, 1 - eta, s_sum / scale),
        k_b=_const(eng, eta, L5, s_sum / scale),
        q1=col(dc.q_level(L1)), q2=col(dc.q_level(level - 2)),
        q4=col(dc.q_level(L4)), q5=col(dc.q_level(L5)))


def helr_iteration(Z: torch.Tensor, beta: torch.Tensor, v: torch.Tensor,
                   prep: HelrPrep):
    """One iteration of HELR's Nesterov accelerated gradient. Z: int32
    [blocks, 2, level, n2, n1], block k's row r holding z_i = y_i (1, x_i)
    of sample i = k rows + r; beta, v: [2, level, n2, n1], the weights
    tiled over the rows. Each step runs on all blocks at once:

      1. a = Z * v (hmult_graph, -> level-1)
      2. rows summed: a += rot(a, 2^j), j < log2(features); column 0 of
         row r holds t_r = z_r . v
      3. masked to column 0 (a plaintext product, one rescale, -> level-2)
         and replicated over the row: a += rot(a, -2^j)
      4. s = sigma3(-t) = c0 - c1 t - c3 t^3 (hsquare_graph, hmult_graph,
         -> level-4)
      5. G = sum_k s_k * Z_k (hmult_graph, -> level-5, then the blocks'
         sum), summed over the rows: G += rot(G, features 2^j)
      6. beta' = v + gamma/n G and v' = (1-eta) beta' + eta beta, each its
         constant products and one rescale (-> level-6)

    Returns beta' and v' stacked, int32 [2, 2, level-6, n2, n1] at
    prep.s_out (one tensor, so it unpacks as the pair)."""
    L3, L4, L5 = (prep.level - k for k in range(3, 6))
    key = prep.relin_key
    with route_span("helr_iteration", prep.kt_0):
        a = hmult_graph(Z, v, key, prep.kt_0)
        with route_span("helr_rowsum", prep.kt_0):
            a = _rotate_add(a, prep.row_perms, prep.row_keys, prep.kt_1,
                            prep.q1)
        with route_span("helr_replicate", prep.kt_0):
            t = rescale_poly(mulmod(a, prep.pt_mask, prep.q1), prep.rs_1)
            t = _rotate_add(t, prep.rep_perms, prep.rep_keys, prep.kt_2,
                            prep.q2)
        with route_span("helr_sigmoid", prep.kt_0):
            t2 = hsquare_graph(t, key, prep.kt_2)
            t3 = hmult_graph(t[..., :L3, :, :], t2, key, prep.kt_3)
            y = modadd(mulmod(t[..., :L4, :, :], prep.c_lin, prep.q4),
                       mulmod(t3, prep.c_cub, prep.q4), prep.q4)
            y0, y1 = y.unbind(-4)
            s = torch.stack([modadd(y0, prep.pt_half, prep.q4), y1],
                            dim=-4).to(torch.int32)
        with route_span("helr_gradient", prep.kt_0):
            g = hmult_graph(s, Z[..., :L4, :, :], key, prep.kt_4)
            G = _rotate_add(_tree_sum(g, prep.q5), prep.sum_perms,
                            prep.sum_keys, prep.kt_5, prep.q5)
        with route_span("helr_update", prep.kt_0):
            q = prep.q5
            pre = modadd(mulmod(G, prep.k_g, q),
                         mulmod(v[:, :L5], prep.k_v, q), q)
            pre_b, pre_v = pre.unbind(0)
            pre_v = modadd(pre_v, mulmod(beta[:, :L5], prep.k_b, q), q)
            return rescale_poly(torch.stack([pre_b, pre_v]), prep.rs_5)
