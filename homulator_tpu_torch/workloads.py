"""The encrypted workloads of the JAX package's set-B programs, on the port.

The counterparts of the two programs that `scripts/bench_workload.py`
(a d x d BSGS matrix-vector product, one dense layer under encryption)
and `scripts/bench_logreg.py` (logistic-regression inference: a slot-sum
score and a degree-3 sigmoid) hold as closures inside `main()`. Each
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
and no reader takes a device time inside a workload.

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


def _group_sum(pt_group: torch.Tensor, baby: torch.Tensor,
               q: torch.Tensor, kt: KeySwitchLevelTables) -> torch.Tensor:
    """sum_i pdiag_i * baby_i over both components: one product by the
    stacked diagonals [g, level, ...] and a modular-add tree; a
    `pt_products` span."""
    with route_span("pt_products", kt):
        t = mulmod(baby, pt_group[:, None], q)
        while t.shape[0] > 1:
            h = t.shape[0] // 2
            head = modadd(t[:h], t[h:2 * h], q)
            t = torch.cat([head, t[2 * h:]]) if t.shape[0] % 2 else head
        return t[0].to(torch.int32)


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


def logreg_scales(params, level: int, scale: float):
    """The scale bookkeeping of bench_logreg.py: (delta, delta_adj, s_out).
    The linear branch (t at level-1) and the cubic one (t^3, two rescales
    deeper, times delta) differ in scale by s_t2 / q; encoding the linear
    coefficient at delta_adj = s_cub / s_prod puts both on s_out = s_cub
    exactly."""
    L2, L3, L4 = level - 1, level - 2, level - 3
    s_prod = scale * scale / params.qs[L2]   # after pmult + rescale
    s_t2 = s_prod * s_prod / params.qs[L3]   # after hsquare
    s_t3 = s_t2 * s_prod / params.qs[L4]     # after hmult
    delta = float(1 << params.scale_bits)
    s_cub = s_t3 * delta
    return delta, s_cub / s_prod, s_cub


def _const(eng, value: float, level: int, mult: float) -> torch.Tensor:
    """Residues of round(value * mult) over the first `level` primes, as
    an int64 [level, 1, 1] column (a product by it is the JAX program's
    Montgomery product by the lifted constant)."""
    qs = eng.params.q_arr[:level].astype(np.int64)
    return col(eng.dc.tensor(np.int64(round(value * mult)) % qs))


def logreg_prep(eng, w: np.ndarray, b: float, level: int,
                scale: float) -> LogregPrep:
    """Keys, encodes, constants and tables of logreg_sigmoid3 for the
    weights w (one per slot) and bias b, of a ciphertext at (level,
    scale); the engine holds its relinearisation key."""
    p = eng.params
    n, slots = p.n, p.n // 2
    if eng.relin_key is None:
        raise RuntimeError("logreg_prep: call keygen() first")
    perms, keys = _rotation_keys(eng, logreg_steps(slots))
    delta, delta_adj, s_out = logreg_scales(p, level, scale)
    c0, c1, c3 = SIGMOID3
    L4 = level - 3

    def constant_pt(value: float, levl: int, s: float) -> torch.Tensor:
        m = np.zeros(n, dtype=np.int64)
        m[0] = int(round(value * s))
        return eng.plaintext_ints(m, levl, s).data

    dc = eng.dc
    return LogregPrep(
        level, scale, s_out,
        pt_w=eng.plaintext_complex(w, level, scale).data,
        # b joins before the rescale, at scale^2 (0.3 * 2^58 < 2^63)
        pt_b=constant_pt(b, level, scale * scale),
        perms=perms, keys=keys, relin_key=eng.relin_key,
        kt1=dc.keyswitch_tables(level), rs1=dc.rescale_tables(level),
        kt2=dc.keyswitch_tables(level - 1), kt3=dc.keyswitch_tables(level - 2),
        c_lin=_const(eng, c1, L4, delta_adj),
        c_cub=_const(eng, c3, L4, delta),
        pt_half=constant_pt(c0, L4, s_out),
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
        acc = mulmod(ct, prep.pt_w, prep.q1).to(torch.int32)
        for perm, key in zip(prep.perms, prep.keys):
            rot = hrotate_graph(acc, perm, key, prep.kt1)
            acc = modadd(acc, rot, prep.q1).to(torch.int32)
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
