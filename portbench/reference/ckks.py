"""The plain reference RNS-CKKS engine that decides `correct`.

A frozen copy of `homulator_tpu_torch/refimpl.py` at commit 7ddbfaf4d401:
the same arithmetic, the same tables (this package's frozen `params.py`)
and the same order of draws from `numpy.random.default_rng(seed)`, so that
key generation and encryption from one seed give the keys and ciphertexts
the measured program made from it. Its numpy uint64 arrays are torch int64
tensors here (residues < 2^30, products < 2^60), so the check can run on
the card after the window: the numpy NTT at N = 2^16 takes about 1.6 s for
60 rows, which would make one BSGS matvec's check minutes long. Every
operation is the plain definition: no kernel, no hoisting, no fusion, no
batching, one ciphertext at a time.

Imports numpy, torch and this package's frozen copies; nothing of the
measured program.

`exact=False` is the control: every modular product is taken in float64
(a 53-bit mantissa) where the configuration states exact products of
30-bit residues, the step below 64-bit integers that a faster path might
take. Additions stay exact (they fit in float64).

Layout: a polynomial is [rows, N] in the flat evaluation order of
`params.NttTables`; a ciphertext [2, level, N]; a key-switch key a list of
dnum tensors [2, K, N] over the whole basis (mains, then specials).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import numtheory as nt
from .encoder import CkksEncoder
from .params import CkksParams


class RefCkks:
    def __init__(self, params: CkksParams, seed: int, device="cpu",
                 exact: bool = True):
        p = self.p = params
        self.rng = np.random.default_rng(seed)
        self.dev = torch.device(device)
        self.exact = exact
        t = p.ntt
        dev = self._tab
        self.q = dev(p.q_arr)
        self.sub1_tw = [dev(s) for s in t.sub1.stage_tw]
        self.sub2_tw = [dev(s) for s in t.sub2.stage_tw]
        self.sub1_itw = [dev(s) for s in t.sub1.inv_stage_tw]
        self.sub2_itw = [dev(s) for s in t.sub2.inv_stage_tw]
        self.tw_mid = dev(t.tw_mid)
        self.tw_mid_inv = dev(t.tw_mid_inv)
        self.md_s1 = dev(p.ks.moddown_step1)
        self.md_s2 = dev(p.ks.moddown_step2)
        self.pinv = dev(p.ks.pinv_modq)
        self.rescale_qinv = dev(p.rescale_qinv)
        self._encoder = None
        self._perm: Dict[int, torch.Tensor] = {}
        self.rot_keys: Dict[int, List[torch.Tensor]] = {}

    # ------------------------------------------------------------ modops
    def mulmod(self, a: torch.Tensor, b: torch.Tensor,
               q: torch.Tensor) -> torch.Tensor:
        if self.exact:
            return (a * b) % q
        return torch.remainder(a.double() * b.double(), q.double()).long()

    @staticmethod
    def addmod(a, b, q):
        return (a + b) % q

    @staticmethod
    def submod(a, b, q):
        return (a - b + q) % q

    def qcol(self, idx) -> torch.Tensor:
        return self.q[self._idx(idx)][:, None]

    def _idx(self, idx) -> torch.Tensor:
        return torch.as_tensor(np.asarray(idx, dtype=np.int64),
                               device=self.dev)

    def main_idx(self, level: int) -> np.ndarray:
        return np.arange(level)

    def special_idx(self) -> np.ndarray:
        return np.arange(self.p.max_level, self.p.num_primes)

    def ext_idx(self, level: int) -> np.ndarray:
        return np.concatenate([self.main_idx(level), self.special_idx()])

    # --------------------------------------------------------------- NTT
    def _ct(self, x, tws, q4):
        M, n, m = x.shape
        for s in range(n.bit_length() - 1):
            B, H = 1 << s, n >> (s + 1)
            xr = x.reshape(M, B, 2, H, m)
            u = xr[:, :, 0]
            v = self.mulmod(xr[:, :, 1], tws[s][:, :, None, None], q4)
            x = torch.stack([(u + v) % q4, (u - v + q4) % q4],
                            dim=2).reshape(M, n, m)
        return x

    def _gs(self, x, itws, q4):
        M, n, m = x.shape
        for s in range(n.bit_length() - 2, -1, -1):
            B, H = 1 << s, n >> (s + 1)
            xr = x.reshape(M, B, 2, H, m)
            u, v = xr[:, :, 0], xr[:, :, 1]
            s0 = (u + v) % q4
            s1 = self.mulmod(u - v + q4, itws[s][:, :, None, None], q4)
            x = torch.stack([s0, s1], dim=2).reshape(M, n, m)
        return x

    def ntt(self, x: torch.Tensor, idx) -> torch.Tensor:
        """Forward negacyclic NTT of x [M, N] over the primes idx [M]."""
        t = self.p.ntt
        i = self._idx(idx)
        M = x.shape[0]
        q3 = self.q[i][:, None, None]
        q4 = q3[:, :, :, None]
        y = self._ct(x.reshape(M, t.n1, t.n2), [s[i] for s in self.sub1_tw],
                     q4)
        y = self.mulmod(y, self.tw_mid[i], q3)
        y = y.transpose(1, 2).contiguous()
        y = self._ct(y, [s[i] for s in self.sub2_tw], q4)
        return y.reshape(M, t.n)

    def intt(self, x: torch.Tensor, idx) -> torch.Tensor:
        t = self.p.ntt
        i = self._idx(idx)
        M = x.shape[0]
        q3 = self.q[i][:, None, None]
        q4 = q3[:, :, :, None]
        y = self._gs(x.reshape(M, t.n2, t.n1), [s[i] for s in self.sub2_itw],
                     q4)
        y = y.transpose(1, 2).contiguous()
        y = self.mulmod(y, self.tw_mid_inv[i], q3)
        y = self._gs(y, [s[i] for s in self.sub1_itw], q4)
        return y.reshape(M, t.n)

    # ---------------------------------------------------------- sampling
    def sample_uniform(self, idx) -> torch.Tensor:
        qs = self.p.q_arr[np.asarray(idx)]
        a = np.stack([self.rng.integers(0, int(q), size=self.p.n,
                                        dtype=np.uint64) for q in qs])
        return torch.from_numpy(a.astype(np.int64)).to(self.dev)

    def sample_ternary_coeff(self) -> np.ndarray:
        return self.rng.integers(-1, 2, size=self.p.n).astype(np.int64)

    def sample_err_coeff(self, sigma: float = 3.2) -> np.ndarray:
        return np.rint(self.rng.normal(0.0, sigma, size=self.p.n)).astype(
            np.int64)

    def signed_to_rns(self, v: np.ndarray, idx) -> torch.Tensor:
        qs = self.p.q_arr[np.asarray(idx)].astype(np.int64)
        return torch.from_numpy(v[None, :] % qs[:, None]).to(self.dev)

    # ------------------------------------------------------------ keygen
    def keygen(self) -> None:
        """The secret and the relinearisation key over the full basis."""
        p = self.p
        all_idx = np.arange(p.num_primes)
        s_coeff = self.sample_ternary_coeff()
        self.s_eval = self.ntt(self.signed_to_rns(s_coeff, all_idx), all_idx)
        s2 = self.mulmod(self.s_eval, self.s_eval, self.qcol(all_idx))
        self.relin_key = self._gen_kskey(s2)

    def _gen_kskey(self, target_eval: torch.Tensor) -> List[torch.Tensor]:
        """evk_d = (b_d, a_d), b_d = -a_d*s + e_d + [P*w_d]*target, w_d =
        Qhat_d * [Qhat_d^{-1}]_{Q_d} over the max-level digit partition."""
        p = self.p
        all_idx = np.arange(p.num_primes)
        q = self.qcol(all_idx)
        P = p.p_prod
        QL = p.q_prod(p.max_level)
        digits = []
        for d in range(p.dnum):
            lo, hi = p.digit_range(p.max_level, d)
            Qd = math.prod(p.qs[lo:hi])
            Qhat = QL // Qd
            w = (Qhat * nt.modinv(Qhat % Qd, Qd)) % QL
            factor = (P * w) % (QL * P)
            f = torch.tensor([factor % qq for qq in p.qs], dtype=torch.int64,
                             device=self.dev)[:, None]
            a = self.sample_uniform(all_idx)
            e = self.ntt(self.signed_to_rns(self.sample_err_coeff(), all_idx),
                         all_idx)
            b = self.submod(self.addmod(e, self.mulmod(target_eval, f, q), q),
                            self.mulmod(a, self.s_eval, q), q)
            digits.append(torch.stack([b, a]))
        return digits

    def perm(self, g: int) -> torch.Tensor:
        if g not in self._perm:
            self._perm[g] = torch.from_numpy(
                self.p.automorph_eval_perm(g).astype(np.int64)).to(self.dev)
        return self._perm[g]

    def gen_rotation_key(self, step: int) -> List[torch.Tensor]:
        key = self._gen_kskey(self.s_eval[:, self.perm(
            self.p.galois_elt(step))])
        self.rot_keys[step] = key
        return key

    # ------------------------------------------------- encode / encrypt
    def encode_complex(self, values: np.ndarray, level: int,
                       scale: float) -> torch.Tensor:
        """N/2 complex slots -> eval-domain plaintext [level, N]."""
        if self._encoder is None:
            self._encoder = CkksEncoder(self.p.n)
        coeffs = self._encoder.encode(values, scale)
        idx = self.main_idx(level)
        return self.ntt(self.signed_to_rns(coeffs, idx), idx)

    def encrypt(self, pt: torch.Tensor, level: int) -> torch.Tensor:
        """Symmetric encryption c = (m + e - a*s, a): [2, level, N]."""
        idx = self.main_idx(level)
        q = self.qcol(idx)
        a = self.sample_uniform(idx)
        e = self.ntt(self.signed_to_rns(self.sample_err_coeff(), idx), idx)
        c0 = self.submod(self.addmod(pt, e, q),
                         self.mulmod(a, self.s_eval[:level], q), q)
        return torch.stack([c0, a])

    # -------------------------------------------------------- key switch
    def modup(self, c_coeff: torch.Tensor, level: int, d: int) -> torch.Tensor:
        """Digit d of c (coeff domain [level, N]) lifted to mains+specials
        by the centered conversion; the digit's own rows pass through."""
        p = self.p
        lo, hi = p.digit_range(level, d)
        ext = self.ext_idx(level)
        digit = c_coeff[lo:hi]
        q_d = self.qcol(np.arange(lo, hi))
        s1 = self._tab(p.ks.modup_step1[(level, d)])[:, None]
        xhat = self.mulmod(digit, s1, q_d)
        v = (xhat >= (q_d + 1) // 2).sum(dim=0)
        xhat_ext = torch.cat([xhat, v[None]])
        m = self._tab(p.ks.modup_step2[(level, d)])[self._idx(ext)]
        q_ext = self.qcol(ext)
        out = torch.zeros((len(ext), p.n), dtype=torch.int64, device=self.dev)
        for t in range(hi - lo + 1):
            term = self.mulmod(xhat_ext[t][None], m[:, t:t + 1], q_ext)
            out = self.addmod(out, term, q_ext)
        out[lo:hi] = digit
        return out

    def _tab(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a).astype(np.int64)).to(self.dev)

    def moddown(self, c_ext: torch.Tensor, level: int) -> torch.Tensor:
        """[level+alpha, N] eval over mains+specials -> [level, N] mod Q."""
        p = self.p
        sp = self.special_idx()
        q_sp = self.qcol(sp)
        b = self.intt(c_ext[level:], sp)
        bhat = self.mulmod(b, self.md_s1[:, None], q_sp)
        v = (bhat >= (q_sp + 1) // 2).sum(dim=0)
        bhat_ext = torch.cat([bhat, v[None]])
        main = self.main_idx(level)
        q = self.qcol(main)
        conv = torch.zeros((level, p.n), dtype=torch.int64, device=self.dev)
        for j in range(p.alpha + 1):
            conv = self.addmod(conv, self.mulmod(
                bhat_ext[j][None], self.md_s2[:level, j:j + 1], q), q)
        diff = self.submod(c_ext[:level], self.ntt(conv, main), q)
        return self.mulmod(diff, self.pinv[:level, None], q)

    def keyswitch(self, d_eval: torch.Tensor, key: Sequence[torch.Tensor],
                  level: int):
        """The hybrid key switch of one polynomial [level, N] (eval):
        (e0, e1), each [level, N] eval."""
        p = self.p
        ext = self.ext_idx(level)
        i_ext = self._idx(ext)
        q_ext = self.qcol(ext)
        c_coeff = self.intt(d_eval, self.main_idx(level))
        acc = torch.zeros((2, len(ext), p.n), dtype=torch.int64,
                          device=self.dev)
        for d in range(p.beta(level)):
            ext_eval = self.ntt(self.modup(c_coeff, level, d), ext)
            evk = key[d][:, i_ext]
            acc = self.addmod(acc, self.mulmod(ext_eval[None], evk, q_ext),
                              q_ext)
        return self.moddown(acc[0], level), self.moddown(acc[1], level)

    # ----------------------------------------------------------- rescale
    def rescale(self, ct: torch.Tensor, level: int) -> torch.Tensor:
        """Drop the last limb with the centered remainder: [2, level, N] ->
        [2, level-1, N]."""
        p = self.p
        nl = level - 1
        q_last = int(p.qs[level - 1])
        main = self.main_idx(nl)
        q = self.qcol(main)
        qinv = self.rescale_qinv[level - 1, :nl][:, None]
        out = []
        for k in range(2):
            last = self.intt(ct[k, level - 1:level], [level - 1])[0]
            ind = last >= (q_last + 1) // 2
            v = torch.where(ind[None], last[None] + 2 * q - q_last, last[None])
            v = torch.where(v >= q, v - q, v)
            diff = self.submod(ct[k, :nl], self.ntt(v, main), q)
            out.append(self.mulmod(diff, qinv, q))
        return torch.stack(out)

    # -------------------------------------------------------- operations
    def hmult(self, a: torch.Tensor, b: torch.Tensor,
              level: int) -> torch.Tensor:
        """Tensor product, key switch of d2, relinearisation add, rescale:
        [2, level, N] x [2, level, N] -> [2, level-1, N]."""
        q = self.qcol(self.main_idx(level))
        d0 = self.mulmod(a[0], b[0], q)
        d1 = self.addmod(self.mulmod(a[0], b[1], q),
                         self.mulmod(a[1], b[0], q), q)
        d2 = self.mulmod(a[1], b[1], q)
        e0, e1 = self.keyswitch(d2, self.relin_key, level)
        return self.rescale(torch.stack([self.addmod(d0, e0, q),
                                         self.addmod(d1, e1, q)]), level)

    def hrotate(self, a: torch.Tensor, step: int, level: int) -> torch.Tensor:
        """Automorphism of both components, key switch of the second, add."""
        key = self.rot_keys[step]
        perm = self.perm(self.p.galois_elt(step))
        q = self.qcol(self.main_idx(level))
        e0, e1 = self.keyswitch(a[1][:, perm], key, level)
        return torch.stack([self.addmod(a[0][:, perm], e0, q), e1])

    def pmult(self, a: torch.Tensor, pt: torch.Tensor,
              level: int) -> torch.Tensor:
        return self.mulmod(a, pt[None], self.qcol(self.main_idx(level))[None])

    def hadd(self, a: torch.Tensor, b: torch.Tensor,
             level: int) -> torch.Tensor:
        return self.addmod(a, b, self.qcol(self.main_idx(level))[None])
