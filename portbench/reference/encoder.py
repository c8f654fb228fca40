"""Frozen copy of `homulator_tpu_torch/encoder.py` at commit 7ddbfaf4d401
(portbench's yardstick: later changes to the port do not move it).
Imports nothing of the measured program. The original's docstring:

CKKS slot encoder/decoder: canonical embedding, host-side float64 FFT.

The port's own copy of `homulator_tpu/encoder.py`, arithmetic unchanged.

The reference never computes on data, so it has no encoder; a usable CKKS
framework needs one. Messages are vectors of N/2 complex slots. Slot j
corresponds to evaluation of m(X) at zeta^{5^j} (zeta = primitive 2N-th
complex root), the standard ordering that makes sigma_{5} a cyclic slot
rotation — matching params.CkksParams.galois_elt.

encode: slots -> conjugate-symmetric values on all odd powers of zeta ->
inverse embedding (O(N log N) via a length-2N FFT) -> scale by Delta ->
round to integer coefficients.
"""

from __future__ import annotations

import numpy as np


class CkksEncoder:
    def __init__(self, n: int):
        self.n = n
        self.slots = n // 2
        two_n = 2 * n
        # exps[j] = 5^j mod 2N for slot j; conjugate slots at -5^j mod 2N.
        e = 1
        exps = np.zeros(self.slots, dtype=np.int64)
        for j in range(self.slots):
            exps[j] = e
            e = (e * 5) % two_n
        self.exps = exps
        self.conj_exps = (two_n - exps) % two_n

    def encode(self, values: np.ndarray, scale: float) -> np.ndarray:
        """complex128[slots] -> int64[n] coefficients (scaled, rounded)."""
        n, two_n = self.n, 2 * self.n
        values = np.asarray(values, dtype=np.complex128)
        assert values.shape == (self.slots,)
        # Build f[k] = m(zeta^k) on all odd k (conjugate-symmetric).
        f = np.zeros(two_n, dtype=np.complex128)
        f[self.exps] = values
        f[self.conj_exps] = np.conj(values)
        # a_j = (1/N) * sum_{odd k} f[k] * zeta^{-kj}; with f zero on even k
        # this is (2/2N) * sum_k f[k] e^{+2*pi*i*k*j/2N} ... using
        # zeta = e^{i*pi/N}: zeta^{-kj} = e^{-i*pi*k*j/N} = e^{-2i*pi*k*j/2N},
        # i.e. a length-2N forward DFT of f (numpy fft convention), times 1/N.
        a = np.fft.fft(f)[:n] / self.n
        # Coefficients are real up to fp error for conjugate-symmetric input.
        coeffs = np.rint(a.real * scale).astype(np.int64)
        return coeffs

    def decode(self, coeffs: np.ndarray, scale: float) -> np.ndarray:
        """int coefficients (possibly python ints) -> complex128[slots]."""
        n, two_n = self.n, 2 * self.n
        a = np.zeros(two_n, dtype=np.complex128)
        a[:n] = np.asarray([float(c) for c in coeffs], dtype=np.float64)
        # m(zeta^k) for all k via inverse-direction transform:
        # m(zeta^k) = sum_j a_j e^{i*pi*k*j/N} = (2N) * ifft(a)[k].
        vals = np.fft.ifft(a) * two_n
        return vals[self.exps] / scale
