"""Device context: residue tables on one torch device + ciphertext containers.

The counterpart of `homulator_tpu/context.py`, rebuilt from the same host
precompute (the port's copy of `params`) without JAX. Layouts match the JAX
package at every public boundary, so arrays compare with `np.array_equal`:

  * a ciphertext is `[2, level, n2, n1]` eval-domain tiles;
  * coeff-domain tiles are `[M, n1, n2]` (the 4-step NTT's natural layouts);
  * the key-switch key is `[dnum, 2, K, n2, n1]`, specials first, in
    Montgomery form (radix 2^32);
  * extended-basis rows are ordered specials first.

Residues are stored as `torch.int32`: every prime is below 2^30
(`numtheory.PRIME_CAP`), so the bit pattern equals the JAX package's
`uint32` and the CUDA kernels read it as `uint32_t*`. Shoup quotients
floor(w * 2^32 / q) use the full 32 bits and are stored the same way (as
their uint32 bit pattern); only the kernels read them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .ops.bconv_fused import build_bf16_tables, mma_table
from .parallel.mesh import pack_k_for
from .params import CkksParams

EVAL = "eval"


def _i32(a: np.ndarray) -> torch.Tensor:
    """Host uint32-range array -> int32 CPU tensor with the same bits."""
    u = np.ascontiguousarray(np.asarray(a, dtype=np.uint64).astype(np.uint32))
    return torch.from_numpy(u.view(np.int32))


def _shoup(w: np.ndarray, q: np.ndarray) -> np.ndarray:
    """floor(w * 2^32 / q) for w < q < 2^30 (q broadcast against w)."""
    return (np.asarray(w, dtype=np.uint64) << np.uint64(32)) // np.asarray(
        q, dtype=np.uint64)


def _flat_stages(stages, n: int) -> np.ndarray:
    """[K, n] flat twiddle table: stage s, block b lives at column 2^s + b
    (the bit-reversed psi table of params._build_sub_tables; column 0 is
    unused)."""
    out = np.zeros((stages[0].shape[0], n), dtype=np.uint64)
    for s, arr in enumerate(stages):
        out[:, (1 << s): (1 << (s + 1))] = arr
    return out


@dataclasses.dataclass
class Ciphertext:
    """data: int32[2, level, n2, n1] eval-domain tiles (standard-domain
    residues, as uint32 bits)."""

    data: torch.Tensor
    level: int
    scale: float
    domain: str = EVAL

    def __post_init__(self):
        if self.data.ndim != 4 or self.data.shape[0] != 2:
            raise ValueError(f"ciphertext data shape {tuple(self.data.shape)}")
        if self.data.shape[1] != self.level:
            raise ValueError(
                f"data has {self.data.shape[1]} limbs, level is {self.level}")


@dataclasses.dataclass
class Plaintext:
    """data: int32[level, n2, n1] eval-domain tiles (see Ciphertext)."""

    data: torch.Tensor
    level: int
    scale: float
    domain: str = EVAL


@dataclasses.dataclass
class NttBasis:
    """Tables of the 4-step NTT for one ordered prime basis (M rows).

    tw1/tw2 (and the inverse itw1/itw2): int32[M, n] flat stage twiddles,
    stage s block b at column 2^s + b; mid/mid_inv: int32[M, n1, n2] mid
    twiddles (mid_inv carries 1/N). Each has a `*_sh` Shoup quotient
    table for the CUDA kernels. rows: the basis's prime indices.

    shard: (rank, ns) on a coefficient-sharded basis (the JAX NttBasis's
    shard_axis): mid, mid_inv and their Shoup tables are then this rank's
    contiguous column slice [M, n1, n2/ns], every other table is the
    whole basis's, and ntt/intt run as the phase-split transform around an
    all_to_all (ops/ntt.py).

    pack: on a sharded basis, the lane-group size k of the lane-packed
    phase kernels B10-B13 (the JAX basis's pfwd_packed / pinv_packed), or
    0 for the per-limb kernels B6-B9. The packed kernels read the same
    per-limb tables: lane j of group g reads limb min((g mod G)*k + j div
    c, M - 1), G = ceil(M/k) groups a copy (ops/ntt.py)."""

    q: torch.Tensor
    tw1: torch.Tensor
    tw1_sh: torch.Tensor
    mid: torch.Tensor
    mid_sh: torch.Tensor
    tw2: torch.Tensor
    tw2_sh: torch.Tensor
    itw1: torch.Tensor
    itw1_sh: torch.Tensor
    mid_inv: torch.Tensor
    mid_inv_sh: torch.Tensor
    itw2: torch.Tensor
    itw2_sh: torch.Tensor
    n1: int
    n2: int
    rows: Tuple[int, ...] = ()
    shard: Optional[Tuple[int, int]] = None
    pack: int = 0


@dataclasses.dataclass
class ModUpDigitTables:
    """One ModUp digit at a fixed level.

    step1/step1_sh: [nd] [(Q_d/q_i)^{-1}]_{q_i} for the digit's primes
    in_q. mat: [m_other, nd+1] [Q_d/q_i]_{p_j} for every ext row j
    outside the digit, plus the centering column [-Q_d]_{p_j}
    (params.ks.modup_step2), read by the plain versions. mat_bf16/horner_sh:
    build_bf16_tables of mat (the JAX ModUpDigitTables' pair); mat_mma:
    mat_bf16 in the device layout of kernels B3 and B5
    (ops/bconv_fused.py::mma_table). other_nt:
    NTT basis of those rows (ext order). lo/hi: the digit's span of main
    rows."""

    step1: torch.Tensor
    step1_sh: torch.Tensor
    in_q: torch.Tensor
    mat: torch.Tensor
    mat_bf16: torch.Tensor
    horner_sh: torch.Tensor
    mat_mma: torch.Tensor
    other_nt: NttBasis
    lo: int
    hi: int


@dataclasses.dataclass
class TailTables:
    """Fused ModDown + relinearisation add + rescale (one division by
    P * q_last), as in homulator_tpu/context.py TailTables.

    mat: [level-1, alpha+3] conversion matrix: [P/p_j]_{q_i}, the
    centering column [-P]_{q_i} (read by the explicit v_b row), [P]_{q_i}
    (the w row) and [-P*q_last]_{q_i} (the w centering indicator row);
    bf16/horner_sh: its build_bf16_tables pair; mma: bf16 in kernel B3's
    device layout (mma_table).
    in_q/one/one_sh: [alpha+3] input primes with placeholders and the
    identity step-1 pair. p_modq: [level] [P]_{q_i}; pq_inv: [level-1]
    [(P*q_last)^{-1}]_{q_i}; md2_last: [alpha+1] [P/p_j]_{q_last} plus
    its centering entry. last_nt: basis of the dropped limb; out_nt: main
    basis at level-1."""

    mat: torch.Tensor
    bf16: torch.Tensor
    horner_sh: torch.Tensor
    mma: torch.Tensor
    in_q: torch.Tensor
    one: torch.Tensor
    one_sh: torch.Tensor
    p_modq: torch.Tensor
    p_modq_sh: torch.Tensor
    pq_inv: torch.Tensor
    pq_inv_sh: torch.Tensor
    md2_last: torch.Tensor
    md2_last_sh: torch.Tensor
    last_nt: NttBasis
    out_nt: NttBasis


@dataclasses.dataclass
class RescaleTables:
    """rescale_poly's tables for dropping limb level-1 (ops/rescale.py):
    last_nt, the dropped limb's basis; out_nt, the main basis at level-1;
    qinv/qinv_sh: [level-1] [q_last^{-1}]_{q_i} Shoup pair."""

    last_nt: NttBasis
    out_nt: NttBasis
    qinv: torch.Tensor
    qinv_sh: torch.Tensor


@dataclasses.dataclass
class KeySwitchLevelTables:
    """Key-switch tables of one level.

    ext_nt: NTT basis of the ext rows (specials first, alpha+level rows):
    its primes serve the Montgomery key product and its forward tables
    the fused HPIP kernel's NTTs. ext_qinv: [alpha+level] -q^{-1} mod
    2^32. md_s1: [alpha] [(P/p_j)^{-1}]_{p_j}; md_mat: [level, alpha+1]
    ModDown conversion [P/p_j]_{q_i} plus the centering column [-P]_{q_i}
    (params.ks.moddown_step2), read by the plain versions;
    md_bf16/md_horner_sh: its build_bf16_tables pair (the JAX tables'
    moddown_bf16 / moddown_horner_sh), md_mma: md_bf16 in the device
    layout of kernels B3 and B5 (mma_table); pinv: [level]
    [P^{-1}]_{q_i}. tail: the fused ModDown + rescale tables (None at
    level 1, where there is no limb to drop, and on the graph route).
    graph: the key switch takes the graph route of a context made with
    ntt_mode="jnp" (the JAX tables' `use_pallas` False): whole ext digits
    NTT'd, step-2 conversions through kernel B5, each key component's
    ModDown on its own, rescale_poly after it (ops/keyswitch.py) on the
    tables `rescale` (set on the graph route at level >= 2 only)."""

    digits: Tuple[ModUpDigitTables, ...]
    main_nt: NttBasis
    special_nt: NttBasis
    ext_nt: NttBasis
    ext_qinv: torch.Tensor
    md_s1: torch.Tensor
    md_s1_sh: torch.Tensor
    md_mat: torch.Tensor
    md_bf16: torch.Tensor
    md_horner_sh: torch.Tensor
    md_mma: torch.Tensor
    pinv: torch.Tensor
    pinv_sh: torch.Tensor
    tail: Optional[TailTables]
    level: int
    graph: bool = False
    rescale: Optional[RescaleTables] = None


class DeviceContext:
    """All device tables for one CkksParams on one torch device.

    device: "cuda" (the kernels' device; raises when torch has no CUDA
    device) or "cpu" (every kernel wrapper then runs its plain PyTorch
    version).

    ntt_mode: "auto", the accelerated route the JAX package takes on its
    accelerator (own digit rows pass through, base conversions in B3, the
    fused ModDown + rescale tail), or "jnp", the JAX package's graph route
    (KeySwitchLevelTables.graph), which it takes on every other backend.
    Both give the same bits. The JAX modes "pallas" and "interpret" have
    no meaning here."""

    def __init__(self, params: CkksParams, device="cuda",
                 ntt_mode: str = "auto"):
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "DeviceContext(device='cuda'): torch.cuda.is_available() is "
                "False")
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {dev}")
        if ntt_mode not in ("auto", "jnp"):
            raise ValueError(f"ntt_mode {ntt_mode!r}: 'auto' (the "
                             "accelerated route) or 'jnp' (the graph route)")
        self.params = params
        self.device = dev
        self.ntt_mode = ntt_mode
        t = params.ntt
        self._tw1 = _flat_stages(t.sub1.stage_tw, t.n1)
        self._tw2 = _flat_stages(t.sub2.stage_tw, t.n2)
        self._itw1 = _flat_stages(t.sub1.inv_stage_tw, t.n1)
        self._itw2 = _flat_stages(t.sub2.inv_stage_tw, t.n2)
        self._nt_cache: Dict[tuple, NttBasis] = {}
        self._ks_cache: Dict[tuple, KeySwitchLevelTables] = {}
        # sigma_g's gather indices by g, its stage maps by ("stage", g)
        self._perm_cache: Dict[object, object] = {}
        self._route_cache: Dict[Tuple[int, int], tuple] = {}
        self._q_cache: Dict[int, torch.Tensor] = {}
        self._rs_cache: Dict[int, RescaleTables] = {}

    # ---- basis row helpers (same orders as the JAX DeviceContext) --------
    def main_rows(self, level: int) -> Tuple[int, ...]:
        return tuple(range(level))

    def special_rows(self) -> Tuple[int, ...]:
        p = self.params
        return tuple(range(p.max_level, p.num_primes))

    def ext_rows(self, level: int) -> Tuple[int, ...]:
        """Specials first: the per-level key rows are then the contiguous
        prefix [0, alpha+level) of the specials-first key layout."""
        return self.special_rows() + self.main_rows(level)

    def tensor(self, a: np.ndarray) -> torch.Tensor:
        """Host uint32-range array -> int32 tensor on this device."""
        return _i32(a).to(self.device)

    def _pair(self, w: np.ndarray, q: np.ndarray):
        """(w, floor(w * 2^32 / q)) as device tensors."""
        return self.tensor(w), self.tensor(_shoup(w, q))

    def _bf16(self, mat: np.ndarray, q: np.ndarray):
        """build_bf16_tables(mat, q) and the table's device layout for
        kernel B3 (mma_table), on this device."""
        mbig, horner_sh = build_bf16_tables(mat, q)
        return (mbig.to(self.device), horner_sh.to(self.device),
                mma_table(mbig).to(self.device))

    # ---- tables ----------------------------------------------------------
    def _pack_k(self, shard: Optional[Tuple[int, int]], packed: bool) -> int:
        """k of the lane-packed kernels for this shard count, 0 where they
        do not run (unsharded, packed=False, or pack_k_for gives 0)."""
        if shard is None or not packed:
            return 0
        t = self.params.ntt
        return pack_k_for(t.n1, t.n2, shard[1])

    def ntt_basis(self, rows: Tuple[int, ...],
                  shard: Optional[Tuple[int, int]] = None,
                  packed: bool = False) -> NttBasis:
        """The basis of `rows`; with shard = (rank, ns), its coefficient-
        sharded form for that rank, lane-packed (pack = k) when `packed`
        and pack_k_for gives k > 0 at ns (see NttBasis)."""
        rows = tuple(rows)
        k = self._pack_k(shard, packed)
        key = (rows, shard, k)
        if key in self._nt_cache:
            return self._nt_cache[key]
        if k:
            nb = dataclasses.replace(self.ntt_basis(rows, shard), pack=k)
            self._nt_cache[key] = nb
            return nb
        if shard is not None:
            nb = self._shard_basis(self.ntt_basis(rows), shard)
            self._nt_cache[key] = nb
            return nb
        p = self.params
        r = np.array(rows, dtype=np.int64)
        q = p.q_arr[r]
        q2, q3 = q[:, None], q[:, None, None]
        tw1, tw1_sh = self._pair(self._tw1[r], q2)
        tw2, tw2_sh = self._pair(self._tw2[r], q2)
        itw1, itw1_sh = self._pair(self._itw1[r], q2)
        itw2, itw2_sh = self._pair(self._itw2[r], q2)
        mid, mid_sh = self._pair(p.ntt.tw_mid[r], q3)
        mid_inv, mid_inv_sh = self._pair(p.ntt.tw_mid_inv[r], q3)
        nb = NttBasis(
            q=self.tensor(q),
            tw1=tw1, tw1_sh=tw1_sh, mid=mid, mid_sh=mid_sh,
            tw2=tw2, tw2_sh=tw2_sh,
            itw1=itw1, itw1_sh=itw1_sh, mid_inv=mid_inv,
            mid_inv_sh=mid_inv_sh, itw2=itw2, itw2_sh=itw2_sh,
            n1=p.ntt.n1, n2=p.ntt.n2, rows=rows,
        )
        self._nt_cache[key] = nb
        return nb

    def _shard_basis(self, nb: NttBasis, shard: Tuple[int, int]) -> NttBasis:
        """nb with the mid tables cut to rank's columns [r*c, (r+1)*c) of
        n2, c = n2/ns (the P(None, None, axis) specs of
        homulator_tpu/parallel/sharded.py:62-87)."""
        rank, ns = shard
        t = self.params.ntt
        if not (0 <= rank < ns and t.n1 % ns == 0 and t.n2 % ns == 0):
            raise ValueError(f"shard {shard}: need 0 <= rank < ns and ns | "
                             f"n1={t.n1}, n2={t.n2}")
        c = t.n2 // ns
        cols = slice(rank * c, (rank + 1) * c)
        return dataclasses.replace(
            nb, shard=(rank, ns),
            **{k: getattr(nb, k)[:, :, cols].contiguous()
               for k in ("mid", "mid_sh", "mid_inv", "mid_inv_sh")})

    def keyswitch_tables(self, level: int,
                         shard: Optional[Tuple[int, int]] = None,
                         packed: bool = False) -> KeySwitchLevelTables:
        """Key-switch tables at `level` for this context's route (the
        accelerated route's fused ModDown + rescale tail needs level >= 2;
        the graph route builds none, as the JAX package). With shard =
        (rank, ns): the same tables with every NTT basis in its sharded
        form for that rank (lane-packed where `packed` and pack_k_for
        allow, as ntt_basis); all other tables are the unsharded ones.
        The graph route has no sharded form."""
        k = self._pack_k(shard, packed)
        key = (level, shard, k)
        if key in self._ks_cache:
            return self._ks_cache[key]
        if shard is not None and self.ntt_mode == "jnp":
            raise NotImplementedError(
                "the graph route (ntt_mode='jnp') has no coefficient-sharded "
                "form: it is kept single-device, for parity with the JAX "
                "engine and as kernel B5's path (ROADMAP A5)")
        if shard is not None:
            kt = self.keyswitch_tables(level)

            def cut(nb: NttBasis) -> NttBasis:
                return self.ntt_basis(nb.rows, shard, bool(k))

            tail = kt.tail and dataclasses.replace(
                kt.tail, last_nt=cut(kt.tail.last_nt),
                out_nt=cut(kt.tail.out_nt))
            kt = dataclasses.replace(
                kt, digits=tuple(dataclasses.replace(dt, other_nt=cut(
                    dt.other_nt)) for dt in kt.digits),
                main_nt=cut(kt.main_nt), special_nt=cut(kt.special_nt),
                ext_nt=cut(kt.ext_nt), tail=tail)
            self._ks_cache[key] = kt
            return kt
        p = self.params
        if not 1 <= level <= p.max_level:
            raise ValueError(f"level {level} outside [1, {p.max_level}]")
        qn = p.q_arr
        ext = self.ext_rows(level)
        digits = []
        for d in range(p.beta(level)):
            lo, hi = p.digit_range(level, d)
            step1, step1_sh = self._pair(p.ks.modup_step1[(level, d)],
                                         qn[lo:hi])
            other = np.array([j for j in ext if not lo <= j < hi])
            mat_pl = p.ks.modup_step2[(level, d)][other]  # [m_other, nd+1]
            mat_bf16, horner_sh, mat_mma = self._bf16(mat_pl, qn[other])
            digits.append(ModUpDigitTables(
                step1=step1, step1_sh=step1_sh, in_q=self.tensor(qn[lo:hi]),
                mat=self.tensor(mat_pl), mat_bf16=mat_bf16,
                horner_sh=horner_sh, mat_mma=mat_mma,
                other_nt=self.ntt_basis(tuple(other.tolist())),
                lo=lo, hi=hi,
            ))
        sp_q = qn[p.max_level:]
        md_s1, md_s1_sh = self._pair(p.ks.moddown_step1, sp_q)
        md_bf16, md_horner_sh, md_mma = self._bf16(
            p.ks.moddown_step2[:level], qn[:level])
        pinv, pinv_sh = self._pair(p.ks.pinv_modq[:level], qn[:level])
        kt = KeySwitchLevelTables(
            digits=tuple(digits),
            main_nt=self.ntt_basis(self.main_rows(level)),
            special_nt=self.ntt_basis(self.special_rows()),
            ext_nt=self.ntt_basis(ext),
            ext_qinv=self.tensor(p.qinv_neg[np.array(ext)]),
            md_s1=md_s1, md_s1_sh=md_s1_sh,
            md_mat=self.tensor(p.ks.moddown_step2[:level]), md_bf16=md_bf16,
            md_horner_sh=md_horner_sh,
            md_mma=md_mma,
            pinv=pinv, pinv_sh=pinv_sh,
            tail=(self._tail_tables(level)
                  if level >= 2 and self.ntt_mode != "jnp" else None),
            level=level, graph=self.ntt_mode == "jnp",
            rescale=(self.rescale_tables(level)
                     if level >= 2 and self.ntt_mode == "jnp" else None),
        )
        self._ks_cache[key] = kt
        return kt

    def _tail_tables(self, level: int) -> TailTables:
        """homulator_tpu/context.py:546-592 in numpy: the [lm1, alpha+3]
        tail matrix, its input-prime placeholders and the Shoup pairs."""
        p = self.params
        qn = p.q_arr
        lm1 = level - 1
        q_last = int(qn[lm1])
        P = p.p_prod
        sp_q = qn[p.max_level:]
        md2 = p.ks.moddown_step2[:level]  # [level, alpha+1]
        p_modq = np.array([P % int(q) for q in qn[:level]], dtype=np.uint64)
        pq_inv = np.array(
            [pow((P * q_last) % int(q), -1, int(q)) for q in qn[:lm1]],
            dtype=np.uint64)
        negpq = np.array(
            [(int(q) - (P * q_last) % int(q)) % int(q) for q in qn[:lm1]],
            dtype=np.uint64)
        tail_mat = np.concatenate(
            [md2[:lm1], p_modq[:lm1, None], negpq[:, None]], axis=1)
        # input "primes" of the identity step 1: specials, a placeholder
        # for the v_b count row (any prime > v), q_last for the w row and
        # a placeholder for the {0, 1} indicator row.
        in_q = np.concatenate(
            [sp_q, sp_q[:1], np.array([q_last, q_last], dtype=np.uint64)])
        mat = self.tensor(tail_mat)
        bf16, horner_sh, mma = self._bf16(tail_mat, qn[:lm1])
        one, one_sh = self._pair(np.ones(len(in_q), dtype=np.uint64), in_q)
        pm, pm_sh = self._pair(p_modq, qn[:level])
        pqi, pqi_sh = self._pair(pq_inv, qn[:lm1])
        m2l, m2l_sh = self._pair(md2[lm1], np.full(md2.shape[1], q_last,
                                                   dtype=np.uint64))
        return TailTables(
            mat=mat, bf16=bf16, horner_sh=horner_sh, mma=mma,
            in_q=self.tensor(in_q),
            one=one, one_sh=one_sh, p_modq=pm, p_modq_sh=pm_sh,
            pq_inv=pqi, pq_inv_sh=pqi_sh, md2_last=m2l, md2_last_sh=m2l_sh,
            last_nt=self.ntt_basis((lm1,)),
            out_nt=self.ntt_basis(self.main_rows(lm1)),
        )

    def q_level(self, level: int) -> torch.Tensor:
        """int32 [level] the first `level` primes on this device (the
        elementwise ops' modulus column; the JAX q_level triple's q, as
        the port multiplies in int64 and needs no Montgomery constants)."""
        if level not in self._q_cache:
            self._q_cache[level] = self.tensor(self.params.q_arr[:level])
        return self._q_cache[level]

    def rescale_qinv(self, level: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(plain, Shoup) pair of [level-1] [q_{level-1}^{-1}]_{q_i}: the
        pair of the JAX rescale_qinv_mont triple that rescale_poly reads."""
        p = self.params
        return self._pair(p.rescale_qinv[level - 1, :level - 1],
                          p.q_arr[:level - 1])

    def rescale_tables(self, level: int) -> RescaleTables:
        """rescale_poly's tables for dropping limb level-1 (level >= 2)."""
        if level not in self._rs_cache:
            self._rs_cache[level] = RescaleTables(
                self.ntt_basis((level - 1,)),
                self.ntt_basis(self.main_rows(level - 1)),
                *self.rescale_qinv(level))
        return self._rs_cache[level]

    def automorph_perm(self, g: int) -> torch.Tensor:
        """int64 [N] gather indices of sigma_g over the flat eval order
        (params.automorph_eval_perm), on this device."""
        if g not in self._perm_cache:
            perm = self.params.automorph_eval_perm(g).astype(np.int64)
            self._perm_cache[g] = torch.from_numpy(perm).to(self.device)
        return self._perm_cache[g]

    def automorph_stage_maps(self, g: int):
        """(s1, s2, s3): sigma_g on the [n2, n1] eval tile as a sublane,
        a lane and a sublane gather (ops/perm_decomp.py, applied by
        ops/automorph.py::automorph_eval_staged), int64 [n2, n1] on this
        device, converted from perm_decomp's int32 maps once; cached per
        Galois element under ("stage", g), as the JAX
        DeviceContext.automorph_stage_maps caches them."""
        key = ("stage", g)
        if key not in self._perm_cache:
            from .ops.perm_decomp import decompose_grid_perm

            t = self.params.ntt
            maps = decompose_grid_perm(self.params.automorph_eval_perm(g),
                                       t.n2, t.n1)
            self._perm_cache[key] = tuple(
                torch.from_numpy(m.astype(np.int64)).to(self.device)
                for m in maps)
        return self._perm_cache[key]

    def automorph_shard_route(self, g: int, ns: int):
        """(local_src, pairs, is_identity): sigma_g on an ns-way column-
        sharded eval tile as one whole-shard ppermute and a local gather
        (ops/automorph.build_shard_route), as the JAX
        DeviceContext.automorph_shard_route gives it. local_src: int64
        [ns, n2*(n1/ns)] gather tables on this device (row r is rank r's);
        pairs: the ppermute pairs (src, dst), () when the block map is the
        identity. Where the column map is not block-aligned, the gather
        route instead: (automorph_perm(g), None, False)."""
        key = (g, ns)
        if key not in self._route_cache:
            from .ops.automorph import BlockAlignmentError, build_shard_route

            t = self.params.ntt
            try:
                src_dev, local_src, ident = build_shard_route(
                    self.params.automorph_eval_perm(g), t.n2, t.n1, ns)
                pairs = () if ident else tuple(
                    (int(src_dev[i]), i) for i in range(ns))
                route = (torch.from_numpy(local_src.astype(np.int64))
                         .to(self.device), pairs, ident)
            except BlockAlignmentError:
                route = (self.automorph_perm(g), None, False)
            self._route_cache[key] = route
        return self._route_cache[key]

    # ---- host <-> device -------------------------------------------------
    def _eval_tiles(self, flat: np.ndarray) -> np.ndarray:
        """Host flat eval order [..., N] -> eval tiles [..., n2, n1]."""
        t = self.params.ntt
        return flat.reshape(flat.shape[:-1] + (t.n2, t.n1))

    def upload_ct(self, data_u64: np.ndarray, level: int,
                  scale: float) -> Ciphertext:
        return Ciphertext(self.tensor(self._eval_tiles(data_u64)), level,
                          scale, EVAL)

    def upload_pt(self, data_u64: np.ndarray, level: int,
                  scale: float) -> Plaintext:
        return Plaintext(self.tensor(self._eval_tiles(data_u64)), level,
                         scale, EVAL)

    def upload_kskey_mont(self, digits: List[np.ndarray]) -> torch.Tensor:
        """Stack key digits ([2, K, N] each) as ONE Montgomery-form array
        [dnum, 2, K, n2, n1] with the specials-first row layout."""
        p = self.params
        L = p.max_level
        stacked = np.stack(digits).astype(np.uint64)
        stacked = np.concatenate([stacked[:, :, L:], stacked[:, :, :L]],
                                 axis=2)
        qn = np.concatenate([p.q_arr[L:], p.q_arr[:L]])[None, None, :, None]
        mont = (stacked << np.uint64(32)) % qn.astype(np.uint64)
        return self.tensor(self._eval_tiles(mont))

    def download(self, x: torch.Tensor) -> np.ndarray:
        """Tiles [..., R, C] -> host flat [..., N] uint64."""
        h = x.detach().cpu().numpy().view(np.uint32).astype(np.uint64)
        return h.reshape(h.shape[:-2] + (h.shape[-2] * h.shape[-1],))


def from_jax_state(arrays: Mapping[str, np.ndarray],
                   dc: DeviceContext) -> Dict[str, torch.Tensor]:
    """The JAX package's device arrays, given as numpy, as this package's
    tensors on dc.device. Each value is a uint32 array whose trailing axes
    are eval tiles [n2, n1]: e.g. `np.asarray(eng.relin_key)`
    ([dnum, 2, K, n2, n1], Montgomery form) or `np.asarray(ct.data)`
    ([2, level, n2, n1]). The layouts are the same, so only the dtype's
    name changes (uint32 -> int32 with the same bits)."""
    t = dc.params.ntt
    out = {}
    for name, a in arrays.items():
        a = np.asarray(a)
        if a.dtype != np.uint32:
            raise TypeError(f"{name}: expected uint32, got {a.dtype}")
        if a.shape[-2:] != (t.n2, t.n1):
            raise ValueError(
                f"{name}: trailing axes {a.shape[-2:]} are not eval tiles "
                f"({t.n2}, {t.n1})")
        out[name] = torch.from_numpy(a.view(np.int32).copy()).to(dc.device)
    return out
