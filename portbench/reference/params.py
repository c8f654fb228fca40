"""Frozen copy of `homulator_tpu_torch/params.py` at commit 7ddbfaf4d401
(portbench's yardstick: later changes to the port do not move it).
Imports nothing of the measured program. The original's docstring:

CKKS parameter context: primes, NTT tables, key-switch/rescale constants.

The port's own copy of `homulator_tpu/params.py`, arithmetic unchanged, so
every table is bit-identical to the JAX package's
(tests/test_torch_host.py holds the two equal). The notes below are the
original's.

Built once on the host with exact integer arithmetic (Python ints / numpy
uint64), consumed by both the CPU reference engine (`refimpl.py`) and the
TPU device context (`context.py`, which converts multiplicative constants
to Montgomery form).

Design notes (what the reference models vs. what we build):

* The reference simulates address traffic for parameter sets A-D
  (script/README.md:17-22): N in {2^15, 2^16}, maxLevel up to 45, alpha up
  to 28. We implement the real arithmetic for the same grid, with RNS
  primes < 2**30 (see numtheory.py for why 30-bit on TPU).

* NTT: the reference's NTTU models a 4-step pipeline
  (phase1 -> intra-transpose -> inter-transpose -> phase2,
  include/Components.h:297-345) because that is also the natural mapping
  for wide vector hardware. We use the same factorization N = n1*n2:
  stage-1 negacyclic sub-NTTs of size n1 along the leading axis
  (vectorized over n2 lanes), a twiddle pass, a transpose, and stage-2
  sub-NTTs of size n2. The cyclic step-2 DFT is converted to a negacyclic
  transform by folding psi2^{-j2} into the twiddle matrix, so both steps
  share one merged-twist CT butterfly network (Longa-Naehrig style) and
  the inverse shares one GS network. Output ordering is whatever the
  butterfly network produces; we discover the evaluation-order permutation
  empirically at build time and precompute automorphism gathers in that
  order (any fixed order is a valid evaluation basis).

* Key-switch: SEAL-style hybrid (residue-partition) key switching, the
  real math behind the reference's KeySwitch phase DAG
  (src/Operation.cpp:9-590): Decomp_d = plain residues of digit d;
  ModUp = approximate base conversion to the remaining primes + specials;
  inner product against evk_d = Enc(P * w_d * s^2) with
  w_d = Qhat_d * [Qhat_d^{-1}]_{Q_d}; ModDown divides by P.
  Keys are generated once at max level and work at every level.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import numtheory as nt


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _choose_split(n: int) -> Tuple[int, int]:
    """Split N = n1*n2 for the 4-step NTT; keep n2 (lane axis) >= n1."""
    logn = n.bit_length() - 1
    l1 = logn // 2
    n1 = 1 << l1
    n2 = n // n1
    return n1, n2


@dataclasses.dataclass
class SubNttTables:
    """Merged-twist CT/GS butterfly tables for one transform size, all primes.

    stage_tw[s] has shape [K, 2**s]: per-block twiddles for CT stage s
    (blocks of pairs; DIT, natural input -> permuted output).
    inv_stage_tw[s] has the same shape, consumed by GS stages in reverse
    order (permuted input -> natural output, WITHOUT the 1/n factor —
    the caller folds 1/N into the mid twiddle matrix).
    perm[r] = evaluation index k such that out[r] = sum_j a_j psi^{(2k+1) j}.
    """

    n: int
    stage_tw: List[np.ndarray]
    inv_stage_tw: List[np.ndarray]
    perm: np.ndarray  # [n] int64, structural (prime independent)


@dataclasses.dataclass
class NttTables:
    """Full 4-step negacyclic NTT tables over the whole prime basis."""

    n: int
    n1: int
    n2: int
    sub1: SubNttTables  # size n1, twist psi1 = psi^{n2}
    sub2: SubNttTables  # size n2, twist psi2 = psi^{n1}
    tw_mid: np.ndarray  # [K, n1, n2] forward mid twiddles (incl. psi2^{-j2} fold)
    tw_mid_inv: np.ndarray  # [K, n1, n2] inverse mid twiddles (incl. 1/N)
    eval_index: np.ndarray  # [n] int64: flat position p -> eval index k
    eval_pos: np.ndarray  # [n] int64: eval index k -> flat position p


def _power_table(base: int, q: int, count: int) -> np.ndarray:
    """[count] uint64 table of base^j mod q via vectorized doubling."""
    pows = np.array([1], dtype=np.uint64)
    step = base % q
    while len(pows) < count:
        pows = np.concatenate([pows, (pows * np.uint64(step)) % np.uint64(q)])
        step = (step * step) % q
    return pows[:count]


def _build_sub_tables(
    n: int, psis: Sequence[int], qs: Sequence[int]
) -> SubNttTables:
    """Tables for a size-n merged-twist negacyclic NTT for each prime.

    Classic Cooley-Tukey DIT with the twist psi merged into bit-reversed
    twiddle tables: psi_br[i] = psi^{brv(i)}; the stage with 2**s blocks
    uses entries psi_br[2**s : 2**(s+1)]. Inverse (GS) uses
    psi_inv_br[i] = psi^{-brv(i)} similarly. The exact output permutation
    is discovered empirically below rather than assumed.
    """
    logn = n.bit_length() - 1
    K = len(qs)
    brv = np.array(nt.bit_reverse_perm(n))

    psi_br = np.zeros((K, n), dtype=np.uint64)
    psi_inv_br = np.zeros((K, n), dtype=np.uint64)
    for t, (q, psi) in enumerate(zip(qs, psis)):
        psi_inv = nt.modinv(psi, q)
        psi_br[t] = _power_table(psi, q, 2 * n)[brv]
        psi_inv_br[t] = _power_table(psi_inv, q, 2 * n)[brv]

    stage_tw = [np.ascontiguousarray(psi_br[:, (1 << s): (1 << (s + 1))]) for s in range(logn)]
    inv_stage_tw = [
        np.ascontiguousarray(psi_inv_br[:, (1 << s): (1 << (s + 1))]) for s in range(logn)
    ]

    # Empirical output permutation: input delta at j=1 gives out[r] = psi^(2k+1)
    # for k = perm[r]. Use prime 0; the permutation is structural.
    q0, psi0 = qs[0], psis[0]
    delta = np.zeros((1, n, 1), dtype=np.uint64)
    delta[0, 1, 0] = 1
    out = _ref_ct_ntt(delta, [s[:1] for s in stage_tw], np.uint64(q0))[0, :, 0]
    lookup = {pow(psi0, 2 * k + 1, q0): k for k in range(n)}
    perm = np.array([lookup[int(v)] for v in out], dtype=np.int64)
    assert len(set(perm.tolist())) == n, "sub-NTT output order is not a permutation"
    return SubNttTables(n=n, stage_tw=stage_tw, inv_stage_tw=inv_stage_tw, perm=perm)


def _ref_ct_ntt(x: np.ndarray, stage_tw: List[np.ndarray], q) -> np.ndarray:
    """Host-exact CT butterfly network along axis -2 of x: [K, n, m] uint64.

    This is the algorithmic template both the CPU reference engine and the
    TPU kernels follow (stage s: view [K, B, 2, H, m]; v *= tw[s][block];
    out = (u+v, u-v)).
    """
    K, n, m = x.shape
    logn = n.bit_length() - 1
    x = x % q
    for s in range(logn):
        B = 1 << s
        H = n >> (s + 1)
        xr = x.reshape(K, B, 2, H, m)
        u = xr[:, :, 0, :, :]
        v = (xr[:, :, 1, :, :] * stage_tw[s][:, :, None, None]) % q
        x = np.concatenate(
            [((u + v) % q)[:, :, None], ((u - v + q) % q)[:, :, None]], axis=2
        ).reshape(K, n, m)
    return x


def _ref_gs_intt(x: np.ndarray, inv_stage_tw: List[np.ndarray], q) -> np.ndarray:
    """Host-exact GS inverse butterfly network (no 1/n factor) along axis -2."""
    K, n, m = x.shape
    logn = n.bit_length() - 1
    x = x % q
    for s in range(logn - 1, -1, -1):
        B = 1 << s
        H = n >> (s + 1)
        xr = x.reshape(K, B, 2, H, m)
        u = xr[:, :, 0, :, :]
        v = xr[:, :, 1, :, :]
        s0 = (u + v) % q
        s1 = ((u - v + q) * inv_stage_tw[s][:, :, None, None]) % q
        x = np.concatenate([s0[:, :, None], s1[:, :, None]], axis=2).reshape(K, n, m)
    return x


def _build_ntt_tables(n: int, qs: Sequence[int], psis: Sequence[int]) -> NttTables:
    n1, n2 = _choose_split(n)
    K = len(qs)
    psi1 = [pow(p, n2, q) for p, q in zip(psis, qs)]
    psi2 = [pow(p, n1, q) for p, q in zip(psis, qs)]
    sub1 = _build_sub_tables(n1, psi1, qs)
    sub2 = _build_sub_tables(n2, psi2, qs)

    # Forward mid twiddles: after stage-1 (rows r hold eval index k1=perm1[r],
    # vectorized over columns j2), multiply by psi^{j2*(2*k1+1)} * psi2^{-j2}:
    #   psi^{j2*(2k1+1)} supplies the cross twiddle w^{j2*k1} and twist psi^{j2};
    #   psi2^{-j2} pre-twists so the cyclic step-2 DFT can run as a negacyclic
    #   transform on the same butterfly network.
    tw_mid = np.zeros((K, n1, n2), dtype=np.uint64)
    tw_mid_inv = np.zeros((K, n1, n2), dtype=np.uint64)
    # Exponent matrix is structural (prime independent):
    # e[r, c] = c * (2*perm1[r] + 1 - n1) mod 2n; inverse uses -e, with the
    # total 1/N scale folded in (one mid-pipeline constant pass, params.py
    # module docstring).
    e = (
        np.arange(n2)[None, :] * (2 * sub1.perm[:, None] + 1 - n1)
    ) % (2 * n)
    e_inv = (-e) % (2 * n)
    for t, (q, psi) in enumerate(zip(qs, psis)):
        pows = _power_table(psi, q, 2 * n)
        n_inv = nt.modinv(n, q)
        tw_mid[t] = pows[e]
        tw_mid_inv[t] = (pows[e_inv] * np.uint64(n_inv)) % np.uint64(q)

    # Global eval order: flat p = s*n1 + r (output [n2, n1] row-major)
    # holds eval index k = perm1[r] + n1 * perm2[s].
    p_r = np.tile(np.arange(n1), n2)
    p_s = np.repeat(np.arange(n2), n1)
    eval_index = sub1.perm[p_r] + n1 * sub2.perm[p_s]
    eval_pos = np.zeros(n, dtype=np.int64)
    eval_pos[eval_index] = np.arange(n)
    return NttTables(
        n=n, n1=n1, n2=n2, sub1=sub1, sub2=sub2,
        tw_mid=tw_mid, tw_mid_inv=tw_mid_inv,
        eval_index=eval_index, eval_pos=eval_pos,
    )


@dataclasses.dataclass
class KeySwitchTables:
    """Per-(level, digit) hybrid key-switch constants.

    Digit d covers main primes S_d = [d*alpha, min((d+1)*alpha, level)).
    All arrays are standard-domain uint64 residues.
    """

    alpha: int
    dnum: int
    # modup_step1[l][d]: [len(S_d)] — [(Q_d(l)/q_i)^{-1}]_{q_i} for i in S_d.
    modup_step1: Dict[Tuple[int, int], np.ndarray]
    # modup_step2[l][d]: [K, len(S_d)+1] — [Q_d(l)/q_i]_{p_j} for every basis
    # prime j (rows for j in S_d are unused by consumers but kept
    # rectangular), plus a final CENTERING column [-Q_d]_{p_j}: the
    # conversion consumes one virtual input row v = #{t : xhat_t >=
    # ceil(q_t/2)} so the lifted digit is the CENTERED representative
    # (|value| < (nd+1)*Q_d/2, mean ~0). Without it the uniform-[0, Q_d)
    # mean adds a rank-one (all-ones x evk-noise) error whose canonical
    # embedding blows up by 2N/pi at the slots nearest zeta^1 — measured
    # as a 2^25.7 eval-domain tone at slot 0 vs a 2^15.8 white floor at
    # N=2^16 (this is why q_t*[Q_d/q_t] = Q_d makes the correction a
    # single shared column).
    modup_step2: Dict[Tuple[int, int], np.ndarray]
    # moddown_step1: [alpha] — [(P/p_j)^{-1}]_{p_j} for special primes.
    moddown_step1: np.ndarray
    # moddown_step2: [L, alpha+1] — [P/p_j]_{q_i} for main primes i, plus
    # the centering column [-P]_{q_i} (same construction as modup_step2).
    moddown_step2: np.ndarray
    # pinv_modq: [L] — [P^{-1}]_{q_i}.
    pinv_modq: np.ndarray


@dataclasses.dataclass
class CkksParams:
    """Full CKKS context parameters + all host precompute.

    n: polynomial degree (power of two)
    max_level: number of main RNS primes (reference maxLevel, e.g. 45 for set B)
    alpha: number of special primes (reference alpha; dnum = ceil(L/alpha),
           src/Operation.cpp:22-23)
    """

    n: int
    max_level: int
    alpha: int
    scale_bits: int = 29

    def __post_init__(self):
        if self.n & (self.n - 1):
            raise ValueError("n must be a power of two")
        self.num_primes: int = self.max_level + self.alpha  # K
        self.dnum: int = _ceil_div(self.max_level, self.alpha)
        primes = nt.gen_ntt_primes(self.n, self.num_primes)
        # Basis order: main primes q_0..q_{L-1}, then special primes
        # p_0..p_{a-1}. gen_ntt_primes descends, and the LARGEST alpha
        # primes are assigned to the special basis so every digit product
        # satisfies Q_d <= P — the hybrid key-switch noise scales with
        # max_d(Q_d)/P, and taking specials from the tail measurably cost
        # 4x noise at set B (log2(Q_0/P) = +2.0 before, -0.7 after).
        self.qs: Tuple[int, ...] = primes[self.alpha:] + primes[: self.alpha]
        self.main_qs: Tuple[int, ...] = self.qs[: self.max_level]
        self.special_qs: Tuple[int, ...] = self.qs[self.max_level:]
        self.scale: float = float(1 << self.scale_bits)

        self.psis: Tuple[int, ...] = tuple(
            nt.find_primitive_2n_root(q, self.n) for q in self.qs
        )
        mont = [nt.mont_constants(q) for q in self.qs]
        self.qinv_neg = np.array([m[0] for m in mont], dtype=np.uint64)
        self.r2 = np.array([m[1] for m in mont], dtype=np.uint64)
        self.r1 = np.array([m[2] for m in mont], dtype=np.uint64)
        self.q_arr = np.array(self.qs, dtype=np.uint64)

        self.ntt: NttTables = _build_ntt_tables(self.n, self.qs, self.psis)
        self.ks: KeySwitchTables = self._build_keyswitch_tables()
        self.rescale_qinv: np.ndarray = self._build_rescale_tables()

    # ---- digit structure -------------------------------------------------
    def digit_range(self, level: int, d: int) -> Tuple[int, int]:
        lo = d * self.alpha
        hi = min((d + 1) * self.alpha, level)
        return lo, hi

    def beta(self, level: int) -> int:
        return _ceil_div(level, self.alpha)

    # ---- precompute builders --------------------------------------------
    def _build_keyswitch_tables(self) -> KeySwitchTables:
        L, a, K = self.max_level, self.alpha, self.num_primes
        modup_step1: Dict[Tuple[int, int], np.ndarray] = {}
        modup_step2: Dict[Tuple[int, int], np.ndarray] = {}
        for level in range(1, L + 1):
            for d in range(self.beta(level)):
                lo, hi = self.digit_range(level, d)
                digit_qs = self.qs[lo:hi]
                Qd = math.prod(digit_qs)
                s1 = np.array(
                    [nt.modinv(Qd // q, q) % q for q in digit_qs], dtype=np.uint64
                )
                s2 = np.zeros((K, hi - lo + 1), dtype=np.uint64)
                for j in range(K):
                    pj = self.qs[j]
                    for t, qi in enumerate(digit_qs):
                        s2[j, t] = (Qd // qi) % pj
                    s2[j, hi - lo] = (-Qd) % pj  # centering column
                modup_step1[(level, d)] = s1
                modup_step2[(level, d)] = s2

        P = math.prod(self.special_qs)
        moddown_step1 = np.array(
            [nt.modinv(P // p, p) % p for p in self.special_qs], dtype=np.uint64
        )
        moddown_step2 = np.zeros((L, a + 1), dtype=np.uint64)
        pinv_modq = np.zeros(L, dtype=np.uint64)
        for i in range(L):
            qi = self.qs[i]
            for j, pj in enumerate(self.special_qs):
                moddown_step2[i, j] = (P // pj) % qi
            moddown_step2[i, a] = (-P) % qi  # centering column
            pinv_modq[i] = nt.modinv(P % qi, qi)
        return KeySwitchTables(
            alpha=a, dnum=self.dnum,
            modup_step1=modup_step1, modup_step2=modup_step2,
            moddown_step1=moddown_step1, moddown_step2=moddown_step2,
            pinv_modq=pinv_modq,
        )

    def _build_rescale_tables(self) -> np.ndarray:
        """rescale_qinv[l, i] = [q_l^{-1}]_{q_i} for i < l (0 elsewhere)."""
        L = self.max_level
        t = np.zeros((L, L), dtype=np.uint64)
        for l in range(1, L):
            ql = self.qs[l]
            for i in range(l):
                t[l, i] = nt.modinv(ql % self.qs[i], self.qs[i])
        return t

    # ---- misc helpers ----------------------------------------------------
    def q_prod(self, level: int) -> int:
        return math.prod(self.qs[:level])

    @property
    def p_prod(self) -> int:
        return math.prod(self.special_qs)

    def galois_elt(self, step: int) -> int:
        """Galois element for a slot rotation by `step` (conjugate: step=None)."""
        two_n = 2 * self.n
        return pow(5, step % (self.n // 2), two_n)

    @property
    def galois_conj(self) -> int:
        return 2 * self.n - 1

    def automorph_eval_perm(self, g: int) -> np.ndarray:
        """Gather indices for sigma_g in our evaluation order.

        out[p] = in[perm[p]] where slot p evaluates at psi^{e(p)},
        e(p) = 2*eval_index[p]+1, and sigma_g(a)(psi^e) = a(psi^{e*g}).
        """
        two_n = 2 * self.n
        e = 2 * self.ntt.eval_index + 1
        e_src = (e * g) % two_n
        # e_src is odd; its eval index k = (e_src-1)/2, position via eval_pos.
        return self.ntt.eval_pos[(e_src - 1) // 2].astype(np.int32)

    def automorph_coeff_maps(self, g: int) -> Tuple[np.ndarray, np.ndarray]:
        """Coefficient-domain sigma_g: out[g*j mod 2n ...] with sign.

        Returns (src_index[j], sign_is_neg[j]) such that
        out[j] = (-1)^{sign[j]} * in[src[j]].
        """
        n, two_n = self.n, 2 * self.n
        src = np.zeros(n, dtype=np.int64)
        neg = np.zeros(n, dtype=bool)
        ginv = nt.modinv(g, two_n)
        for j in range(n):
            t = (j * ginv) % two_n  # out[j] = sigma(in)[j] = in-coeff at index t
            if t < n:
                src[j] = t
                neg[j] = False
            else:
                src[j] = t - n
                neg[j] = True
        return src.astype(np.int32), neg


@functools.lru_cache(maxsize=8)
def get_params(n: int, max_level: int, alpha: int, scale_bits: int = 29) -> CkksParams:
    return CkksParams(n=n, max_level=max_level, alpha=alpha, scale_bits=scale_bits)
