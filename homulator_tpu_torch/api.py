"""Public operation API of the port: `CkksEngine` with hmult, hsquare,
hrotate, conjugate, hrotate_hoisted, the elementwise ops (hadd, hsub,
padd, pmult, cmult, cadd), mod_drop / align_levels, keyswitch_poly,
rescale and the ntt / intt host views.

The counterpart of `homulator_tpu/api.py`; `op_cost_counters` counts
one run of the op where the JAX one reads XLA's compiled-program analysis
(stats.torch_counters).
Key generation, encoding, encryption and decryption run on the host
through the exact reference engine (the port's copy of `refimpl.RefCkks`,
pure numpy); keys and ciphertexts are uploaded in the JAX package's
layouts, and the homomorphic operations run on the engine's torch device.
PyTorch runs eagerly, so the op graphs are plain functions (no jit). The
engine's `ntt_mode` picks the key-switch route as in the JAX package:
"auto" the accelerated one, "jnp" the graph one (context.DeviceContext);
both give the same bits. Elementwise ops are PyTorch ops on the int64
carrier, as the JAX package computes them outside any Pallas kernel.

On the accelerated route the op graphs mark their steps for the span
recorder (stats.span; `route_span`): an op (hmult_graph, hsquare_graph,
hrotate_graph, hrotate_hoisted_graph), and inside it the phases `tensor`
(the tensor product), `modup` (modup_conv_all; on the fused route
modup_convs_coeff), `inner_product` (inner_product_pieces; on the fused
route hpip_acc, which also runs ModUp's NTTs), `moddown` (moddown_rescale2,
with the relinearisation add and the rescale, or moddown_pair2),
`automorph` and `rotation_add`. The graph route, kept for parity with the
JAX engine, and a sharded basis (the shard programs of parallel/) record
none.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .context import (
    EVAL, Ciphertext, DeviceContext, KeySwitchLevelTables, Plaintext,
)
from .ops.automorph import automorph_eval
from .ops.keyswitch import (
    hpip_acc, inner_product_moddown, inner_product_pieces, keyswitch,
    keyswitch_fused, keyswitch_pieces, moddown_pair2, moddown_rescale2,
    modup_all, modup_conv_all, modup_convs_coeff, route_span,
)
from .ops.modmath import col, modadd, modsub, mulmod
from .ops.ntt import intt, ntt
from .ops.rescale import rescale_poly
# get_params is re-exported: callers of the port take their parameter sets
# from the port's own API.
from .params import CkksParams, get_params  # noqa: F401
from .refimpl import RefCiphertext, RefCkks
from .stats import Statistic, op_modmul_count

# Route key switches through the fused ModUp-NTT + inner-product kernel
# (B4, ops/hpip.py) instead of the piecewise path. Off by default, as in
# the JAX package; both routes give the same bits. A coefficient-sharded
# key switch (kt.main_nt.shard set) always takes the piecewise route, as
# in the JAX package: B4 runs whole-limb NTTs; the graph route
# (kt.graph) never takes it.
USE_FUSED_HPIP = False


def _fused(kt: KeySwitchLevelTables) -> bool:
    return USE_FUSED_HPIP and kt.main_nt.shard is None and not kt.graph


def _keyswitch_rescale_tail(d0, d1, d2, key, kt: KeySwitchLevelTables):
    """KeySwitch(d2) -> relinearisation add -> rescale of both components.
    The JAX package ends its sharded branch in one moddown_rescale per
    component (api.py:98-103); the batched moddown_rescale2 gives the same
    bits and moves the same rows through each exchange. The graph route
    (kt.graph, JAX api.py:104-110) runs keyswitch's pieces, the adds and
    one rescale_poly per component on the tables kt.rescale. On the
    piecewise and fused routes d0, d1, d2 may carry a leading batch axis
    (batched_hmult_fn): every step then runs once on the whole batch."""
    d2 = d2.to(torch.int32)
    if kt.graph:
        if d2.ndim != 3:
            raise ValueError("the graph route takes one ciphertext a call "
                             "(parallel.sharded.batched_hmult_fn loops)")
        e0, e1 = inner_product_moddown(modup_all(d2, kt), key, kt)
        q = col(kt.main_nt.q)
        return torch.stack([rescale_poly(modadd(d0, e0, q), kt.rescale),
                            rescale_poly(modadd(d1, e1, q), kt.rescale)])
    if _fused(kt):
        alpha = kt.special_nt.q.shape[0]
        with route_span("modup", kt):
            convs = modup_convs_coeff(d2, kt)
        with route_span("inner_product", kt):
            acc0, acc1 = hpip_acc(convs, d2, key, kt).unbind(-4)
        del convs  # not held through ModDown
        with route_span("moddown", kt):
            return moddown_rescale2(
                (acc0[..., :alpha, :, :], acc0[..., alpha:, :, :]),
                (acc1[..., :alpha, :, :], acc1[..., alpha:, :, :]), d0, d1,
                kt)
    with route_span("modup", kt):
        convs = modup_conv_all(d2, kt)
    with route_span("inner_product", kt):
        acc0, acc1 = inner_product_pieces(convs, d2, key, kt)
    with route_span("moddown", kt):
        return moddown_rescale2(acc0, acc1, d0, d1, kt)


def hmult_graph(a: torch.Tensor, b: torch.Tensor, key: torch.Tensor,
                kt: KeySwitchLevelTables) -> torch.Tensor:
    """Tensor product -> KeySwitch(d2) -> relinearisation add -> rescale.
    a, b: int32 [2, level, n2, n1]; returns int32 [2, level-1, n2, n1].
    On the piecewise and fused routes also a batch: a, b [B, 2, level,
    n2, n1] -> [B, 2, level-1, n2, n1], one program for the batch (every
    kernel launch covers it; the key and the tables are read once)."""
    with route_span("hmult_graph", kt):
        q = col(kt.main_nt.q)
        with route_span("tensor", kt):
            a0, a1 = a.unbind(-4)
            b0, b1 = b.unbind(-4)
            d0 = mulmod(a0, b0, q)
            d1 = modadd(mulmod(a0, b1, q), mulmod(a1, b0, q), q)
            d2 = mulmod(a1, b1, q)
        return _keyswitch_rescale_tail(d0, d1, d2, key, kt)


def hsquare_graph(a: torch.Tensor, key: torch.Tensor,
                  kt: KeySwitchLevelTables) -> torch.Tensor:
    """d0 = c0^2, d1 = 2 c0 c1, d2 = c1^2, then the hmult tail. a: int32
    [2, level, n2, n1] -> [2, level-1, n2, n1]; on the piecewise and fused
    routes also a batch [B, 2, level, n2, n1] -> [B, 2, level-1, n2, n1],
    one program for the batch, as hmult_graph."""
    with route_span("hsquare_graph", kt):
        q = col(kt.main_nt.q)
        with route_span("tensor", kt):
            a0, a1 = a.unbind(-4)
            d0 = mulmod(a0, a0, q)
            cross = mulmod(a0, a1, q)
            d1 = modadd(cross, cross, q)
            d2 = mulmod(a1, a1, q)
        return _keyswitch_rescale_tail(d0, d1, d2, key, kt)


def hrotate_tail(r0: torch.Tensor, r1: torch.Tensor, key: torch.Tensor,
                 kt: KeySwitchLevelTables) -> torch.Tensor:
    """hrotate after the automorphism: KeySwitch(r1) -> add r0. The JAX
    package switches each component's ModDown on its own when sharded
    (keyswitch.py:193-197); keyswitch_pieces keeps them batched, with the
    same bits. The graph route takes keyswitch() (JAX api.py:148-149),
    one ciphertext a call. On the piecewise and fused routes r0, r1 may
    carry a leading batch axis: every step then runs once on the whole
    batch."""
    if kt.graph and r1.ndim != 3:
        raise ValueError("the graph route takes one ciphertext a call")
    q = col(kt.main_nt.q)
    ks = (keyswitch if kt.graph else
          keyswitch_fused if _fused(kt) else keyswitch_pieces)
    e0, e1 = ks(r1, key, kt).unbind(-4)
    with route_span("rotation_add", kt):
        return torch.stack([modadd(r0, e0, q).to(torch.int32), e1], dim=-4)


def hrotate_graph(a: torch.Tensor, perm: torch.Tensor, key: torch.Tensor,
                  kt: KeySwitchLevelTables) -> torch.Tensor:
    """AUTO(c0), AUTO(c1) -> KeySwitch(sigma(c1)) -> add. a: int32
    [2, level, n2, n1]; returns the same shape. On the piecewise and fused
    routes also a batch [B, 2, level, n2, n1], one program for the batch
    (every launch covers it; the key and the tables are read once)."""
    with route_span("hrotate_graph", kt):
        with route_span("automorph", kt):
            a0, a1 = a.unbind(-4)
            r0 = automorph_eval(a0, perm)
            r1 = automorph_eval(a1, perm)
        return hrotate_tail(r0, r1, key, kt)


def hrotate_hoisted_graph(a: torch.Tensor, perms: Sequence[torch.Tensor],
                          keys: Sequence[torch.Tensor],
                          kt: KeySwitchLevelTables) -> torch.Tensor:
    """Several rotations of one ciphertext sharing one ModUp (Halevi-Shoup
    hoisting): the automorphism commutes with the digit decomposition, so
    it is applied to each converted piece (the piecewise route, never the
    fused one, as in the JAX package) or, on the graph route, to each
    whole ext digit (JAX api.py:203-209). Returns int32
    [len(perms), 2, level, n2, n1]."""
    q = col(kt.main_nt.q)
    outs = []
    if kt.graph:
        ext_digits = modup_all(a[1], kt)
        for perm, key in zip(perms, keys):
            rot = [automorph_eval(dg, perm) for dg in ext_digits]
            e0, e1 = inner_product_moddown(rot, key, kt)
            r0 = automorph_eval(a[0], perm)
            outs.append(torch.stack([modadd(r0, e0, q).to(torch.int32), e1]))
        return torch.stack(outs)
    with route_span("hrotate_hoisted_graph", kt):
        with route_span("modup", kt):
            convs = modup_conv_all(a[1], kt)
        for perm, key in zip(perms, keys):
            with route_span("automorph", kt):
                rot_convs = [automorph_eval(c, perm) for c in convs]
                r1 = automorph_eval(a[1], perm)
            with route_span("inner_product", kt):
                acc0, acc1 = inner_product_pieces(rot_convs, r1, key, kt)
            with route_span("moddown", kt):
                e = moddown_pair2(acc0, acc1, kt)
            with route_span("automorph", kt):
                r0 = automorph_eval(a[0], perm)
            with route_span("rotation_add", kt):
                outs.append(torch.stack([modadd(r0, e[0], q).to(torch.int32),
                                         e[1]]))
        return torch.stack(outs)


def hadd_graph(a: torch.Tensor, b: torch.Tensor,
               q: torch.Tensor) -> torch.Tensor:
    """a + b mod q: int32 [2, rows, n2, n1] ciphertexts, q [rows] the
    primes of their rows (any slice of rows or columns of the operands
    with the q of its rows: the sharded elementwise ops run this on each
    shard's slice)."""
    return modadd(a, b, col(q)).to(torch.int32)


def hsub_graph(a: torch.Tensor, b: torch.Tensor,
               q: torch.Tensor) -> torch.Tensor:
    """a - b mod q (hadd_graph's operands)."""
    return modsub(a, b, col(q)).to(torch.int32)


def padd_graph(a: torch.Tensor, p: torch.Tensor,
               q: torch.Tensor) -> torch.Tensor:
    """The plaintext p [rows, n2, n1] added to c0 of a [2, rows, n2, n1]."""
    c0 = modadd(a[0], p, col(q)).to(torch.int32)
    return torch.stack([c0, a[1]])


def pmult_graph(a: torch.Tensor, p: torch.Tensor,
                q: torch.Tensor) -> torch.Tensor:
    """Both components of a [2, rows, n2, n1] times the plaintext p."""
    return mulmod(a, p, col(q)).to(torch.int32)


class CkksEngine:
    """One CKKS context on one torch device ("cuda" or "cpu").

    On "cuda" the NTTs and base conversions run as the CUDA kernels of
    csrc/ (built at first use); on "cpu" they run as their plain PyTorch
    versions. The two give the same bits. ntt_mode: "auto" (the
    accelerated key-switch route) or "jnp" (the graph route), as the JAX
    engine's; the two give the same bits."""

    def __init__(self, params: CkksParams, seed: int = 0, device="cuda",
                 ntt_mode: str = "auto"):
        self.params = params
        self.dc = DeviceContext(params, device, ntt_mode)
        self.ref = RefCkks(params, seed)
        self.relin_key: Optional[torch.Tensor] = None
        self.rot_keys: Dict[int, torch.Tensor] = {}
        self._conj_keys: Dict[int, torch.Tensor] = {}
        self._const_cache: Dict[tuple, torch.Tensor] = {}
        # the reference's Statistic counters (same keys as the JAX engine)
        self.stats = Statistic()

    def _count(self, op: str, level: int, components: int = 2) -> None:
        p = self.params
        self.stats.increase(f"op/{op}")
        self.stats.increase(
            "modmul_total",
            op_modmul_count(op, p.n, level, p.alpha, p.beta(level)))
        # words in + out of device memory for the ciphertext operands
        self.stats.increase("MEM_words", 3 * components * level * p.n)

    # ---- keys ------------------------------------------------------------
    def keygen(self) -> None:
        self.ref.keygen()
        self.relin_key = self.dc.upload_kskey_mont(self.ref.relin_key.digits)

    def gen_rotation_key(self, step: int) -> None:
        key = self.ref.gen_rotation_key(step)
        self.rot_keys[step] = self.dc.upload_kskey_mont(key.digits)

    # ---- io --------------------------------------------------------------
    def encrypt_ints(self, coeffs: np.ndarray, level: int,
                     scale: float) -> Ciphertext:
        ct = self.ref.encrypt(self.ref.encode_ints(coeffs, level, scale))
        return self.dc.upload_ct(ct.data, level, scale)

    def plaintext_ints(self, coeffs: np.ndarray, level: int,
                       scale: float) -> Plaintext:
        pt = self.ref.encode_ints(coeffs, level, scale)
        return self.dc.upload_pt(pt.data, level, scale)

    def encrypt_complex(self, values: np.ndarray, level: int,
                        scale: float) -> Ciphertext:
        """Encrypt N/2 complex slots (canonical-embedding encode + encrypt)."""
        ct = self.ref.encrypt(self.ref.encode_complex(values, level, scale))
        return self.dc.upload_ct(ct.data, level, scale)

    def plaintext_complex(self, values: np.ndarray, level: int,
                          scale: float) -> Plaintext:
        pt = self.ref.encode_complex(values, level, scale)
        return self.dc.upload_pt(pt.data, level, scale)

    def to_ref(self, ct: Ciphertext) -> RefCiphertext:
        """The ciphertext as the host reference engine's type."""
        return RefCiphertext(self.dc.download(ct.data), ct.level, ct.scale,
                             ct.domain)

    def decrypt_complex(self, ct: Ciphertext) -> np.ndarray:
        return self.ref.decrypt_complex(self.to_ref(ct))

    def decrypt_bigint(self, ct: Ciphertext, count=None) -> List[int]:
        return self.ref.decrypt_to_bigint(self.to_ref(ct), count=count)

    # ---- ops -------------------------------------------------------------
    def _check_ks_operand(self, a: Ciphertext, min_level: int = 2) -> None:
        if self.relin_key is None:
            raise RuntimeError("call keygen() first")
        if a.level < min_level or a.domain != EVAL:
            raise ValueError(
                f"operand at level {a.level} ({a.domain}): need an eval-domain "
                f"ciphertext at level >= {min_level}"
                + (" (rescale drops one limb)" if min_level > 1 else ""))

    @staticmethod
    def _same_level(a, b) -> None:
        if a.level != b.level:
            raise ValueError(f"levels differ: {a.level} != {b.level}")
        if a.domain != EVAL or b.domain != EVAL:
            raise ValueError(f"domains {a.domain}, {b.domain}: need eval")

    def hadd(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        self._same_level(a, b)
        self._count("hadd", a.level)
        return Ciphertext(hadd_graph(a.data, b.data,
                                     self.dc.q_level(a.level)),
                          a.level, a.scale)

    def hsub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        self._same_level(a, b)
        self._count("hsub", a.level)
        return Ciphertext(hsub_graph(a.data, b.data,
                                     self.dc.q_level(a.level)),
                          a.level, a.scale)

    def padd(self, a: Ciphertext, pt: Plaintext) -> Ciphertext:
        """Add a plaintext to c0."""
        self._same_level(a, pt)
        self._count("padd", a.level)
        return Ciphertext(padd_graph(a.data, pt.data,
                                     self.dc.q_level(a.level)),
                          a.level, a.scale)

    def pmult(self, a: Ciphertext, pt: Plaintext) -> Ciphertext:
        """Multiply both components by a plaintext (no rescale)."""
        self._same_level(a, pt)
        l = a.level
        self._count("pmult", l)
        return Ciphertext(pmult_graph(a.data, pt.data, self.dc.q_level(l)),
                          l, a.scale * pt.scale)

    def cmult(self, a: Ciphertext, value: float,
              scale_bits: Optional[int] = None) -> Ciphertext:
        """Multiply by a public real scalar (no encoding round trip): by
        the residues of round(value * 2^scale_bits), which the JAX engine
        holds in Montgomery form; the product is the same residue."""
        sb = self.params.scale_bits if scale_bits is None else scale_bits
        delta = float(1 << sb)
        c = int(round(value * delta))
        l = a.level
        key = (c, l)
        if key not in self._const_cache:
            qs = self.params.q_arr[:l].astype(np.int64)
            self._const_cache[key] = self.dc.tensor(np.int64(c) % qs)
        q = col(self.dc.q_level(l))
        out = mulmod(a.data, col(self._const_cache[key]), q)
        return Ciphertext(out.to(torch.int32), l, a.scale * delta)

    def cadd(self, a: Ciphertext, value: float) -> Ciphertext:
        """Add a public real scalar (to the constant coefficient)."""
        m = np.zeros(self.params.n, dtype=np.int64)
        m[0] = int(round(value * a.scale))
        return self.padd(a, self.plaintext_ints(m, a.level, a.scale))

    def mod_drop(self, a: Ciphertext, levels: int = 1) -> Ciphertext:
        """Drop limbs without rescaling (modulus switch by truncation);
        used to align operand levels."""
        new_level = a.level - levels
        if new_level < 1:
            raise ValueError(f"mod_drop({levels}) at level {a.level}")
        return Ciphertext(a.data[:, :new_level].contiguous(), new_level,
                          a.scale)

    def align_levels(self, a: Ciphertext, b: Ciphertext):
        if a.level == b.level:
            return a, b
        if a.level > b.level:
            return self.mod_drop(a, a.level - b.level), b
        return a, self.mod_drop(b, b.level - a.level)

    def hmult(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        self._check_ks_operand(a)
        if b.level != a.level:
            raise ValueError(f"levels differ: {a.level} != {b.level}")
        l = a.level
        self._count("hmult", l)
        out = hmult_graph(a.data, b.data, self.relin_key,
                          self.dc.keyswitch_tables(l))
        return Ciphertext(out, l - 1,
                          a.scale * b.scale / self.params.qs[l - 1])

    def hsquare(self, a: Ciphertext) -> Ciphertext:
        self._check_ks_operand(a)
        l = a.level
        self._count("hsquare", l)
        out = hsquare_graph(a.data, self.relin_key,
                            self.dc.keyswitch_tables(l))
        return Ciphertext(out, l - 1, a.scale * a.scale / self.params.qs[l - 1])

    def hrotate(self, a: Ciphertext, step: int) -> Ciphertext:
        """Rotate the slots left by `step` (the rotation key is made on
        first use)."""
        self._check_ks_operand(a, 1)
        if step not in self.rot_keys:
            self.gen_rotation_key(step)
        self._count("hrotate", a.level)
        perm = self.dc.automorph_perm(self.params.galois_elt(step))
        out = hrotate_graph(a.data, perm, self.rot_keys[step],
                            self.dc.keyswitch_tables(a.level))
        return Ciphertext(out, a.level, a.scale)

    def conjugate(self, a: Ciphertext) -> Ciphertext:
        """Complex conjugation of all slots (Galois element 2N-1)."""
        self._check_ks_operand(a, 1)
        g = self.params.galois_conj
        if g not in self._conj_keys:
            key = self.ref._gen_galois_key(g)
            self._conj_keys[g] = self.dc.upload_kskey_mont(key.digits)
        out = hrotate_graph(a.data, self.dc.automorph_perm(g),
                            self._conj_keys[g],
                            self.dc.keyswitch_tables(a.level))
        return Ciphertext(out, a.level, a.scale)

    def hrotate_hoisted(self, a: Ciphertext,
                        steps: Sequence[int]) -> List[Ciphertext]:
        """Rotate one ciphertext by several steps, sharing one ModUp;
        equal to one hrotate per step."""
        self._check_ks_operand(a, 1)
        for step in steps:
            if step not in self.rot_keys:
                self.gen_rotation_key(step)
        perms = [self.dc.automorph_perm(self.params.galois_elt(s))
                 for s in steps]
        outs = hrotate_hoisted_graph(a.data, perms,
                                     [self.rot_keys[s] for s in steps],
                                     self.dc.keyswitch_tables(a.level))
        return [Ciphertext(o, a.level, a.scale) for o in outs]

    def keyswitch_poly(self, d: torch.Tensor, key: torch.Tensor,
                       level: int) -> torch.Tensor:
        """Switch d (int32 [level, n2, n1] eval) under key: always the JAX
        package's keyswitch() (its tables' branches). Returns int32
        [2, level, n2, n1] (e0, e1)."""
        return keyswitch(d, key, self.dc.keyswitch_tables(level))

    def op_cost_counters(self, op: str, a: Ciphertext,
                         b: Optional[Ciphertext] = None,
                         pt: Optional[Plaintext] = None) -> Dict[str, float]:
        """Counters of one run of one of the CLI's ops (hmult, hsquare,
        hrotate by one step, hadd, hsub, padd, pmult) on a, b or pt, with
        the JAX engine's keys: HBM_bytes (counted, not measured),
        MEM_arg_bytes, MEM_out_bytes and, on the card only,
        MEM_temp_bytes (stats.torch_counters). Runs the op graph twice
        and leaves the engine's stats untouched; hrotate makes the
        rotation key of step 1 if it is missing."""
        from .stats import torch_counters

        l, dc = a.level, self.dc
        if op == "hrotate" and 1 not in self.rot_keys:
            self.gen_rotation_key(1)
        runs = {
            "hmult": lambda: hmult_graph(a.data, b.data, self.relin_key,
                                         dc.keyswitch_tables(l)),
            "hsquare": lambda: hsquare_graph(a.data, self.relin_key,
                                             dc.keyswitch_tables(l)),
            "hrotate": lambda: hrotate_graph(
                a.data, dc.automorph_perm(self.params.galois_elt(1)),
                self.rot_keys[1], dc.keyswitch_tables(l)),
            "hadd": lambda: hadd_graph(a.data, b.data, dc.q_level(l)),
            "hsub": lambda: hsub_graph(a.data, b.data, dc.q_level(l)),
            "padd": lambda: padd_graph(a.data, pt.data, dc.q_level(l)),
            "pmult": lambda: pmult_graph(a.data, pt.data, dc.q_level(l)),
        }
        if op not in runs:
            raise ValueError(op)
        return torch_counters(runs[op], dc.device)

    def rescale(self, a: Ciphertext) -> Ciphertext:
        """Divide by the last prime (rescale_poly on each component)."""
        l = a.level
        if l < 2:
            raise ValueError(f"rescale at level {l}: no limb to drop")
        rt = self.dc.rescale_tables(l)
        out = torch.stack([rescale_poly(a.data[k], rt) for k in (0, 1)])
        return Ciphertext(out, l - 1, a.scale / self.params.qs[l - 1])

    def ntt(self, x: torch.Tensor, level: int) -> torch.Tensor:
        """x: int32 [M, N] flat coeff order -> [M, N] flat eval order over
        the first `level` primes (a host-view utility; the op graphs keep
        the tile layouts)."""
        t = self.params.ntt
        y = ntt(x.reshape(x.shape[0], t.n1, t.n2).contiguous(),
                self.dc.ntt_basis(self.dc.main_rows(level)))
        return y.reshape(x.shape[0], self.params.n)

    def intt(self, x: torch.Tensor, level: int) -> torch.Tensor:
        """The inverse of ntt: [M, N] flat eval -> [M, N] flat coeff."""
        t = self.params.ntt
        y = intt(x.reshape(x.shape[0], t.n2, t.n1).contiguous(),
                 self.dc.ntt_basis(self.dc.main_rows(level)))
        return y.reshape(x.shape[0], self.params.n)
