"""Public operation API of the port: `CkksEngine` with hmult and hsquare.

The counterpart of `homulator_tpu/api.py:113-128, 153-167, 263-405`. Key
generation, encoding, encryption and decryption run on the host through
the exact reference engine (`homulator_tpu.refimpl.RefCkks`, pure numpy);
keys and ciphertexts are uploaded in the JAX package's layouts, and the
homomorphic operations run on the engine's torch device. PyTorch runs
eagerly, so the op graphs are plain functions (no jit).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

# get_params is re-exported: callers of the port take their parameter sets
# from the port's own API.
from homulator_tpu.params import CkksParams, get_params  # noqa: F401
from homulator_tpu.refimpl import RefCiphertext, RefCkks
from homulator_tpu.stats import Statistic, op_modmul_count

from .context import EVAL, Ciphertext, DeviceContext, KeySwitchLevelTables
from .ops.keyswitch import inner_product_pieces, moddown_rescale2, modup_conv_all
from .ops.modmath import modadd, mulmod


def _keyswitch_rescale_tail(d0, d1, d2, key, kt: KeySwitchLevelTables):
    """KeySwitch(d2) -> relinearisation add -> rescale of both components
    (the `kt.tail` branch of api._keyswitch_rescale_tail)."""
    d2 = d2.to(torch.int32)
    convs = modup_conv_all(d2, kt)
    acc0, acc1 = inner_product_pieces(convs, d2, key, kt)
    return moddown_rescale2(acc0, acc1, d0, d1, kt)


def hmult_graph(a: torch.Tensor, b: torch.Tensor, key: torch.Tensor,
                kt: KeySwitchLevelTables) -> torch.Tensor:
    """Tensor product -> KeySwitch(d2) -> relinearisation add -> rescale.
    a, b: int32 [2, level, n2, n1]; returns int32 [2, level-1, n2, n1]."""
    q = kt.main_nt.q.long().view(-1, 1, 1)
    d0 = mulmod(a[0], b[0], q)
    d1 = modadd(mulmod(a[0], b[1], q), mulmod(a[1], b[0], q), q)
    d2 = mulmod(a[1], b[1], q)
    return _keyswitch_rescale_tail(d0, d1, d2, key, kt)


def hsquare_graph(a: torch.Tensor, key: torch.Tensor,
                  kt: KeySwitchLevelTables) -> torch.Tensor:
    """d0 = c0^2, d1 = 2 c0 c1, d2 = c1^2, then the hmult tail."""
    q = kt.main_nt.q.long().view(-1, 1, 1)
    d0 = mulmod(a[0], a[0], q)
    cross = mulmod(a[0], a[1], q)
    d1 = modadd(cross, cross, q)
    d2 = mulmod(a[1], a[1], q)
    return _keyswitch_rescale_tail(d0, d1, d2, key, kt)


class CkksEngine:
    """One CKKS context on one torch device ("cuda" or "cpu").

    On "cuda" the NTTs and base conversions run as the CUDA kernels of
    csrc/ (built at first use); on "cpu" they run as their plain PyTorch
    versions. The two give the same bits."""

    def __init__(self, params: CkksParams, seed: int = 0, device="cuda"):
        self.params = params
        self.dc = DeviceContext(params, device)
        # use_native=False: the native host library is an optional
        # accelerator of RefCkks with bit-identical results; the pure numpy
        # path needs no binary built for this machine.
        self.ref = RefCkks(params, seed, use_native=False)
        self.relin_key: Optional[torch.Tensor] = None
        # the reference's Statistic counters (same keys as the JAX engine)
        self.stats = Statistic()

    def _count(self, op: str, level: int) -> None:
        p = self.params
        self.stats.increase(f"op/{op}")
        self.stats.increase(
            "modmul_total",
            op_modmul_count(op, p.n, level, p.alpha, p.beta(level)))
        # words in + out of device memory for the two-component operands
        self.stats.increase("MEM_words", 3 * 2 * level * p.n)

    # ---- keys ------------------------------------------------------------
    def keygen(self) -> None:
        self.ref.keygen()
        self.relin_key = self.dc.upload_kskey_mont(self.ref.relin_key.digits)

    # ---- io --------------------------------------------------------------
    def encrypt_ints(self, coeffs: np.ndarray, level: int,
                     scale: float) -> Ciphertext:
        ct = self.ref.encrypt(self.ref.encode_ints(coeffs, level, scale))
        return self.dc.upload_ct(ct.data, level, scale)

    def encrypt_complex(self, values: np.ndarray, level: int,
                        scale: float) -> Ciphertext:
        """Encrypt N/2 complex slots (canonical-embedding encode + encrypt)."""
        ct = self.ref.encrypt(self.ref.encode_complex(values, level, scale))
        return self.dc.upload_ct(ct.data, level, scale)

    def to_ref(self, ct: Ciphertext) -> RefCiphertext:
        """The ciphertext as the host reference engine's type."""
        return RefCiphertext(self.dc.download(ct.data), ct.level, ct.scale,
                             ct.domain)

    def decrypt_complex(self, ct: Ciphertext) -> np.ndarray:
        return self.ref.decrypt_complex(self.to_ref(ct))

    def decrypt_bigint(self, ct: Ciphertext, count=None) -> List[int]:
        return self.ref.decrypt_to_bigint(self.to_ref(ct), count=count)

    # ---- ops -------------------------------------------------------------
    def _check_ks_operand(self, a: Ciphertext) -> None:
        if self.relin_key is None:
            raise RuntimeError("call keygen() first")
        if a.level < 2 or a.domain != EVAL:
            raise ValueError(
                f"operand at level {a.level} ({a.domain}): need an eval-domain "
                "ciphertext at level >= 2 (rescale drops one limb)")

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
