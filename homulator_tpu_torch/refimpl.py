"""CPU-exact reference RNS-CKKS engine (numpy uint64).

The reference repository has **no numerical implementation at all** — it
simulates address traffic only (SURVEY.md §4: "no test suite", polynomials
are addresses). This module supplies the missing ground truth: an exact
integer RNS-CKKS implementation mirroring, op for op, the phase structure
the reference models:

  hmult   = TensorCompute -> KeySwitch(d2) -> relin add -> Rescale
            (src/Operation.cpp:913-1112)
  hrotate = automorphism -> KeySwitch -> add   (src/Operation.cpp:1271-1451)
  keyswitch = ModUp{iNTT, digit decomp, BConv, NTT} -> InnerProduct
              -> ModDown{iNTT, BConv, NTT, Sub}     (src/Operation.cpp:9-590)
  rescale = iNTT last limb -> per-basis NTT -> sub -> mul-qinv
            (src/Operation.cpp:741-911)

Every TPU kernel is validated bit-exactly against this module. All values
are standard-domain residues < q < 2**30 held in uint64 (products fit).

The port's own copy of `homulator_tpu/refimpl.py`, arithmetic unchanged.
As there, the NTTs may run in the native host core (`native.py`, the
port's binding of `native/ckks_core.cpp`), which gives the same bits:
`use_native` says when.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import numtheory as nt
from .params import CkksParams


@dataclasses.dataclass
class RefCiphertext:
    """data: uint64[2, level, N]; eval (NTT) domain unless noted."""

    data: np.ndarray
    level: int
    scale: float
    domain: str = "eval"


@dataclasses.dataclass
class RefPlaintext:
    data: np.ndarray  # uint64[level, N], eval domain
    level: int
    scale: float
    domain: str = "eval"


@dataclasses.dataclass
class KeySwitchKey:
    """evk[d]: uint64[2, K, N] eval domain over the full basis (mains+specials)."""

    digits: List[np.ndarray]


class RefCkks:
    def __init__(self, params: CkksParams, seed: int = 0, use_native=None):
        """use_native: None = use the native core when it is already built
        for the checkout's source (never builds it), False = pure numpy
        (the canonical spec path used by algorithm tests), True = build the
        native core now if needed, raising if that fails."""
        self.p = params
        self.rng = np.random.default_rng(seed)
        self._native = None
        if use_native is not False:
            from . import native as _nat

            lib = _nat.load() if use_native is True else _nat.load_if_built()
            if lib is not None:
                self._native = _nat.NativeNtt(params, lib)

    # ------------------------------------------------------------------ NTT
    def ntt(self, x: np.ndarray, idx: np.ndarray) -> np.ndarray:
        """Forward negacyclic NTT. x: [M, N] residues, idx: [M] prime indices."""
        if self._native is not None:
            return self._native.ntt(x, idx)
        p, t = self.p, self.p.ntt
        M = x.shape[0]
        q = p.q_arr[idx][:, None, None]
        y = x.reshape(M, t.n1, t.n2)
        y = self._ct(y, [s[idx] for s in t.sub1.stage_tw], q)
        y = (y * t.tw_mid[idx]) % q
        y = np.ascontiguousarray(y.transpose(0, 2, 1))
        y = self._ct(y, [s[idx] for s in t.sub2.stage_tw], q)
        return y.reshape(M, t.n)

    def intt(self, x: np.ndarray, idx: np.ndarray) -> np.ndarray:
        if self._native is not None:
            return self._native.intt(x, idx)
        p, t = self.p, self.p.ntt
        M = x.shape[0]
        q = p.q_arr[idx][:, None, None]
        y = x.reshape(M, t.n2, t.n1)
        y = self._gs(y, [s[idx] for s in t.sub2.inv_stage_tw], q)
        y = np.ascontiguousarray(y.transpose(0, 2, 1))
        y = (y * t.tw_mid_inv[idx]) % q
        y = self._gs(y, [s[idx] for s in t.sub1.inv_stage_tw], q)
        return y.reshape(M, t.n)

    @staticmethod
    def _ct(x: np.ndarray, stage_tw: List[np.ndarray], q: np.ndarray) -> np.ndarray:
        M, n, m = x.shape
        q4 = q.reshape(M, 1, 1, 1)
        for s in range(n.bit_length() - 1):
            B, H = 1 << s, n >> (s + 1)
            xr = x.reshape(M, B, 2, H, m)
            u, v = xr[:, :, 0], (xr[:, :, 1] * stage_tw[s][:, :, None, None]) % q4
            x = np.concatenate(
                [((u + v) % q4)[:, :, None], ((u - v + q4) % q4)[:, :, None]], axis=2
            ).reshape(M, n, m)
        return x

    @staticmethod
    def _gs(x: np.ndarray, inv_stage_tw: List[np.ndarray], q: np.ndarray) -> np.ndarray:
        M, n, m = x.shape
        q4 = q.reshape(M, 1, 1, 1)
        for s in range(n.bit_length() - 2, -1, -1):
            B, H = 1 << s, n >> (s + 1)
            xr = x.reshape(M, B, 2, H, m)
            u, v = xr[:, :, 0], xr[:, :, 1]
            s0 = (u + v) % q4
            s1 = ((u - v + q4) * inv_stage_tw[s][:, :, None, None]) % q4
            x = np.concatenate([s0[:, :, None], s1[:, :, None]], axis=2).reshape(M, n, m)
        return x

    # --------------------------------------------------------- basic modops
    def _q(self, idx) -> np.ndarray:
        return self.p.q_arr[np.asarray(idx)][:, None]

    def modadd(self, a, b, idx):
        return (a + b) % self._q(idx)

    def modsub(self, a, b, idx):
        q = self._q(idx)
        return (a - b + q) % q

    def modmul(self, a, b, idx):
        return (a * b) % self._q(idx)

    def negate(self, a, idx):
        q = self._q(idx)
        return (q - a) % q

    def main_idx(self, level: int) -> np.ndarray:
        return np.arange(level)

    def special_idx(self) -> np.ndarray:
        return np.arange(self.p.max_level, self.p.num_primes)

    def ext_idx(self, level: int) -> np.ndarray:
        return np.concatenate([self.main_idx(level), self.special_idx()])

    # ------------------------------------------------------------- sampling
    def sample_uniform(self, idx: np.ndarray) -> np.ndarray:
        qs = self.p.q_arr[idx]
        return np.stack(
            [self.rng.integers(0, int(q), size=self.p.n, dtype=np.uint64) for q in qs]
        )

    def sample_ternary_coeff(self) -> np.ndarray:
        """Signed ternary secret/ephemeral, coeff domain, values in {-1,0,1}."""
        return self.rng.integers(-1, 2, size=self.p.n).astype(np.int64)

    def sample_err_coeff(self, sigma: float = 3.2) -> np.ndarray:
        return np.rint(self.rng.normal(0.0, sigma, size=self.p.n)).astype(np.int64)

    def signed_to_rns(self, v: np.ndarray, idx: np.ndarray) -> np.ndarray:
        qs = self.p.q_arr[idx].astype(np.int64)
        return (v[None, :] % qs[:, None]).astype(np.uint64)

    # --------------------------------------------------------------- keygen
    def keygen(self) -> None:
        """Generates secret + relinearization key over the full basis."""
        p = self.p
        all_idx = np.arange(p.num_primes)
        self.s_coeff = self.sample_ternary_coeff()
        s_rns = self.signed_to_rns(self.s_coeff, all_idx)
        self.s_eval = self.ntt(s_rns, all_idx)
        # s^2 in eval domain over full basis.
        s2_eval = self.modmul(self.s_eval, self.s_eval, all_idx)
        self.relin_key = self._gen_kskey(s2_eval)
        self.rot_keys = {}

    def _gen_kskey(self, target_eval: np.ndarray) -> KeySwitchKey:
        """Key switching key toward secret s for `target` (eval, full basis K).

        evk_d = (b_d, a_d): b_d = -a_d*s + e_d + [P*w_d]*target,
        w_d = Qhat_d * [Qhat_d^{-1}]_{Q_d} over the max-level digit partition.
        """
        p = self.p
        all_idx = np.arange(p.num_primes)
        P = p.p_prod
        QL = p.q_prod(p.max_level)
        digits = []
        for d in range(p.dnum):
            lo, hi = p.digit_range(p.max_level, d)
            Qd = math.prod(p.qs[lo:hi])
            Qhat = QL // Qd
            w = (Qhat * nt.modinv(Qhat % Qd, Qd)) % QL
            factor = (P * w) % (QL * P)
            factor_rns = np.array(
                [factor % q for q in p.qs], dtype=np.uint64
            )[:, None]
            a = self.sample_uniform(all_idx)
            e = self.signed_to_rns(self.sample_err_coeff(), all_idx)
            e_eval = self.ntt(e, all_idx)
            b = self.modsub(
                self.modadd(e_eval, self.modmul(target_eval, factor_rns, all_idx), all_idx),
                self.modmul(a, self.s_eval, all_idx),
                all_idx,
            )
            digits.append(np.stack([b, a]))
        return KeySwitchKey(digits=digits)

    def gen_rotation_key(self, step: int) -> KeySwitchKey:
        g = self.p.galois_elt(step)
        key = self._gen_galois_key(g)
        self.rot_keys[step] = key
        return key

    def _gen_galois_key(self, g: int) -> KeySwitchKey:
        all_idx = np.arange(self.p.num_primes)
        perm = self.p.automorph_eval_perm(g)
        return self._gen_kskey(self.s_eval[:, perm])

    # --------------------------------------------------- encrypt / decrypt
    def encrypt(self, pt: RefPlaintext) -> RefCiphertext:
        """Symmetric encryption: c = (m + e - a*s, a)."""
        idx = self.main_idx(pt.level)
        a = self.sample_uniform(idx)
        e = self.ntt(self.signed_to_rns(self.sample_err_coeff(), idx), idx)
        c0 = self.modsub(
            self.modadd(pt.data, e, idx), self.modmul(a, self.s_eval[idx], idx), idx
        )
        return RefCiphertext(np.stack([c0, a]), pt.level, pt.scale)

    def decrypt_to_coeff(self, ct: RefCiphertext) -> np.ndarray:
        """Returns coeff-domain residues [level, N] of m' = c0 + c1*s."""
        idx = self.main_idx(ct.level)
        m_eval = self.modadd(
            ct.data[0], self.modmul(ct.data[1], self.s_eval[idx], idx), idx
        )
        return self.intt(m_eval, idx)

    def decrypt_to_bigint(
        self, ct: RefCiphertext, count: Optional[int] = None
    ) -> List[int]:
        """CRT-reconstructed centered coefficients of the decrypted poly.

        count limits reconstruction to the first `count` coefficients
        (exact big-int CRT is host-side and O(level) per coefficient).
        """
        coeffs = self.decrypt_to_coeff(ct)
        level = ct.level
        Q = self.p.q_prod(level)
        crt = []
        for i in range(level):
            qi = self.p.qs[i]
            Qi = Q // qi
            crt.append(Qi * nt.modinv(Qi % qi, qi) % Q)
        out = []
        for j in range(count if count is not None else self.p.n):
            v = 0
            for i in range(level):
                v += int(coeffs[i, j]) * crt[i]
            v %= Q
            if v > Q // 2:
                v -= Q
            out.append(v)
        return out

    def decrypt_small(self, ct: RefCiphertext, use_primes: int = 3) -> np.ndarray:
        """Centered decryption via CRT over the first few limbs only.

        Valid whenever |message + noise| < (q_0*...*q_{k-1})/2 — true for any
        sanely-scaled CKKS message (|m| ~ scale^2 * |v| << 2**88 for k=3).
        O(n) python-int work instead of O(n * level): the fast decode path.
        """
        k = min(use_primes, ct.level)
        coeffs = self.decrypt_to_coeff(ct)[:k]
        Qk = math.prod(self.qs_small(k))
        crt = []
        for i in range(k):
            qi = self.p.qs[i]
            Qi = Qk // qi
            crt.append(Qi * nt.modinv(Qi % qi, qi) % Qk)
        out = np.zeros(self.p.n, dtype=object)
        for i in range(k):
            out += coeffs[i].astype(object) * crt[i]
        out %= Qk
        half = Qk // 2
        return np.where(out > half, out - Qk, out)

    def qs_small(self, k: int):
        return self.p.qs[:k]

    def decrypt_complex_fast(self, ct: RefCiphertext) -> np.ndarray:
        """Decrypt + decode via the 3-prime CRT shortcut."""
        from .encoder import CkksEncoder

        coeffs = self.decrypt_small(ct)
        return CkksEncoder(self.p.n).decode(coeffs, ct.scale)

    # ------------------------------------------------------- elementwise ops
    def hadd(self, a: RefCiphertext, b: RefCiphertext) -> RefCiphertext:
        assert a.level == b.level
        idx = self.main_idx(a.level)
        q = self.p.q_arr[idx][:, None]
        return RefCiphertext((a.data + b.data) % q, a.level, a.scale)

    def padd(self, a: RefCiphertext, pt: RefPlaintext) -> RefCiphertext:
        idx = self.main_idx(a.level)
        out = a.data.copy()
        out[0] = self.modadd(a.data[0], pt.data, idx)
        return RefCiphertext(out, a.level, a.scale)

    def pmult(self, a: RefCiphertext, pt: RefPlaintext) -> RefCiphertext:
        idx = self.main_idx(a.level)
        out = np.stack(
            [self.modmul(a.data[k], pt.data, idx) for k in range(2)]
        )
        return RefCiphertext(out, a.level, a.scale * pt.scale)

    def tensor(self, a: RefCiphertext, b: RefCiphertext):
        """d0 = a0*b0, d1 = a0*b1 + a1*b0, d2 = a1*b1 (src/Operation.cpp:613-617)."""
        idx = self.main_idx(a.level)
        d0 = self.modmul(a.data[0], b.data[0], idx)
        d1 = self.modadd(
            self.modmul(a.data[0], b.data[1], idx),
            self.modmul(a.data[1], b.data[0], idx),
            idx,
        )
        d2 = self.modmul(a.data[1], b.data[1], idx)
        return d0, d1, d2

    # ------------------------------------------------------------ key switch
    def modup(self, c_coeff: np.ndarray, level: int, d: int) -> np.ndarray:
        """Digit d of c (coeff domain, [level, N]) lifted to basis mains+specials.

        Own-digit rows pass through unscaled (SEAL-style plain-residue
        decomposition; mirrors the reference routing where ModUpNTT inputs
        come from Decomp for l < alpha and from BConv otherwise,
        src/Operation.cpp:190-292).
        """
        p = self.p
        lo, hi = p.digit_range(level, d)
        ext_idx = self.ext_idx(level)
        K_out = len(ext_idx)
        digit = c_coeff[lo:hi]  # [nd, N]
        s1 = p.ks.modup_step1[(level, d)][:, None]
        digit_idx = np.arange(lo, hi)
        xhat = self.modmul(digit, s1, digit_idx)  # [nd, N]
        # Centered conversion: virtual row v = #{t : xhat_t >= ceil(q_t/2)}
        # consumed by the [-Q_d]_{p_j} column of modup_step2 (see
        # params.KeySwitchTables) — the lifted representative is centered,
        # killing the slot-0 canonical-embedding tone of the [0, Q_d) mean.
        th = np.array([(int(q) + 1) // 2 for q in p.q_arr[digit_idx]],
                      dtype=np.uint64)[:, None]
        v = np.sum(xhat >= th, axis=0).astype(np.uint64)
        xhat_ext = np.concatenate([xhat, v[None]], axis=0)  # [nd+1, N]
        out = np.zeros((K_out, p.n), dtype=np.uint64)
        M = p.ks.modup_step2[(level, d)]  # [K, nd+1]
        for row, j in enumerate(ext_idx):
            if lo <= j < hi:
                out[row] = digit[j - lo]
            else:
                qj = self.p.qs[j]
                acc = np.zeros(p.n, dtype=np.uint64)
                for t in range(hi - lo + 1):
                    acc = (acc + xhat_ext[t] * M[j, t]) % qj
                out[row] = acc
        return out

    def moddown(self, c_ext: np.ndarray, level: int) -> np.ndarray:
        """[level+alpha, N] eval over mains+specials -> [level, N] eval mod Q."""
        p = self.p
        sp_idx = self.special_idx()
        B = self.intt(c_ext[level:], sp_idx)  # special part, coeff
        bhat = self.modmul(B, p.ks.moddown_step1[:, None], sp_idx)
        # Centered conversion (see modup): v row against the [-P]_{q_i}
        # column of moddown_step2.
        th = np.array([(int(q) + 1) // 2 for q in p.q_arr[sp_idx]],
                      dtype=np.uint64)[:, None]
        v = np.sum(bhat >= th, axis=0).astype(np.uint64)
        bhat_ext = np.concatenate([bhat, v[None]], axis=0)  # [alpha+1, N]
        main_idx = self.main_idx(level)
        conv = np.zeros((level, p.n), dtype=np.uint64)
        for i in range(level):
            qi = p.qs[i]
            acc = np.zeros(p.n, dtype=np.uint64)
            for j in range(p.alpha + 1):
                acc = (acc + bhat_ext[j] * p.ks.moddown_step2[i, j]) % qi
            conv[i] = acc
        conv_eval = self.ntt(conv, main_idx)
        diff = self.modsub(c_ext[:level], conv_eval, main_idx)
        return self.modmul(diff, p.ks.pinv_modq[:level][:, None], main_idx)

    def keyswitch(self, d_eval: np.ndarray, key: KeySwitchKey, level: int):
        """Full hybrid key switch of one poly [level, N] (eval domain).

        Returns (e0, e1) each [level, N] eval: the ciphertext components to
        add to (c0, c1).
        """
        p = self.p
        main_idx = self.main_idx(level)
        ext_idx = self.ext_idx(level)
        c_coeff = self.intt(d_eval, main_idx)  # ModUpINTT
        K_ext = len(ext_idx)
        acc = np.zeros((2, K_ext, p.n), dtype=np.uint64)
        for d in range(p.beta(level)):
            ext = self.modup(c_coeff, level, d)
            ext_eval = self.ntt(ext, ext_idx)
            evk = key.digits[d][:, ext_idx]  # [2, K_ext, N]
            for k in range(2):
                acc[k] = self.modadd(
                    acc[k], self.modmul(ext_eval, evk[k], ext_idx), ext_idx
                )
        e0 = self.moddown(acc[0], level)
        e1 = self.moddown(acc[1], level)
        return e0, e1

    # --------------------------------------------------------------- rescale
    def rescale(self, ct: RefCiphertext) -> RefCiphertext:
        """Drop the last limb: c'_i = (c_i - [c_last]_{q_i}) * q_last^{-1},
        with the CENTERED remainder r~ = r - q_last*[r >= ceil(q_last/2)].

        Centering is load-bearing, not cosmetic: with the uncentered
        r in [0, q_last), the decrypt error gains -(r0 + r1*s)/q_last whose
        r1*s term has mean -(1/2)*sum_j(+-s_j) — a KEY-dependent DC bias
        of ~sqrt(N) coefficient units that the canonical embedding
        amplifies ~N/pi-fold into a deterministic slot-0 tone (measured
        1.3e-2 at set B before the fix, BENCH_NOTES r5). Centering makes
        E[r~] ~ 0 and the division a rounding, killing the tone."""
        p = self.p
        level = ct.level
        new_level = level - 1
        last_idx = np.array([level - 1])
        q_last = int(p.qs[level - 1])
        th = np.uint64((q_last + 1) // 2)
        out = np.zeros((2, new_level, p.n), dtype=np.uint64)
        main_idx = self.main_idx(new_level)
        qinv = p.rescale_qinv[level - 1, :new_level][:, None]
        for k in range(2):
            last_coeff = self.intt(ct.data[k, level - 1: level], last_idx)[0]
            ind = last_coeff >= th  # centered rep = r - q_last * ind
            # Reduce the centered coefficients into each remaining basis.
            red = np.zeros((new_level, p.n), dtype=np.uint64)
            for i in range(new_level):
                qi = int(p.qs[i])
                # r + 2*q_i - q_last in [0, 2*q_i) when ind (q_last < 2*q_i)
                v = np.where(
                    ind,
                    last_coeff + np.uint64(2 * qi - q_last),
                    last_coeff,
                )
                v = np.where(v >= qi, v - np.uint64(qi), v)
                red[i] = v
            red_eval = self.ntt(red, main_idx)
            diff = self.modsub(ct.data[k, :new_level], red_eval, main_idx)
            out[k] = self.modmul(diff, qinv, main_idx)
        return RefCiphertext(out, new_level, ct.scale / p.qs[level - 1])

    # ------------------------------------------------------------ operations
    def hmult(self, a: RefCiphertext, b: RefCiphertext) -> RefCiphertext:
        d0, d1, d2 = self.tensor(a, b)
        e0, e1 = self.keyswitch(d2, self.relin_key, a.level)
        idx = self.main_idx(a.level)
        c0 = self.modadd(d0, e0, idx)
        c1 = self.modadd(d1, e1, idx)
        ct = RefCiphertext(np.stack([c0, c1]), a.level, a.scale * b.scale)
        return self.rescale(ct)

    def hrotate(self, a: RefCiphertext, step: int) -> RefCiphertext:
        key = self.rot_keys.get(step) or self.gen_rotation_key(step)
        g = self.p.galois_elt(step)
        perm = self.p.automorph_eval_perm(g)
        idx = self.main_idx(a.level)
        r0 = a.data[0][:, perm]
        r1 = a.data[1][:, perm]
        e0, e1 = self.keyswitch(r1, key, a.level)
        return RefCiphertext(
            np.stack([self.modadd(r0, e0, idx), e1]), a.level, a.scale
        )

    # ----------------------------------------------------------- plaintext io
    def encode_ints(self, coeffs: np.ndarray, level: int, scale: float) -> RefPlaintext:
        """Encode signed integer coefficients (coeff domain) into eval-domain RNS."""
        idx = self.main_idx(level)
        rns = self.signed_to_rns(np.asarray(coeffs, dtype=np.int64), idx)
        return RefPlaintext(self.ntt(rns, idx), level, scale)

    def encode_complex(self, values: np.ndarray, level: int, scale: float) -> RefPlaintext:
        """Encode N/2 complex slots via the canonical embedding."""
        from .encoder import CkksEncoder

        coeffs = CkksEncoder(self.p.n).encode(values, scale)
        return self.encode_ints(coeffs, level, scale)

    def decrypt_complex(self, ct: RefCiphertext) -> np.ndarray:
        """Decrypt and decode to N/2 complex slots."""
        from .encoder import CkksEncoder

        coeffs = self.decrypt_to_bigint(ct)
        return CkksEncoder(self.p.n).decode(coeffs, ct.scale)
