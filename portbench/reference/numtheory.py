"""Frozen copy of `homulator_tpu_torch/numtheory.py` at commit 7ddbfaf4d401
(portbench's yardstick: later changes to the port do not move it).
Imports nothing of the measured program. The original's docstring:

Host-side number theory: NTT-friendly primes, roots of unity, Montgomery constants.

The port's own copy of `homulator_tpu/numtheory.py`, arithmetic unchanged
(tests/test_torch_host.py holds the two equal). The notes below are the
original's.

Everything here runs once at context-construction time with exact Python
integers (no device code). The design decision that shapes the whole
framework (SURVEY.md "hard parts" #1): TPUs have no native 64-bit integer
multiply, so all device arithmetic is uint32 with Montgomery reduction at
radix R = 2**32 and primes q in (2**28, 2**32/6). That keeps

  * a*b with a, b < 2**30  ->  128-bit-free (hi, lo) uint32 pair math,
  * REDC output  (a*b + m*q)/R < 2**28 + q < 2*q  ->  one conditional subtract,
  * modadd sums < 2**31  ->  no overflow,
  * 6q < 2**32           ->  the NTT kernels' lazy [0, 6q) stage values and
                             [0, 3q) approximate-Shoup products never wrap.

The reference models 36-bit words (config_4.cfg:9 `elementBitWidth = 36`);
we use more, smaller primes for the same total modulus bits, which is the
idiomatic mapping onto 32-bit TPU vector lanes. Concretely (generated
primes average 29.30 effective bits at N=2^16): the reference's set-B
workload `hmult 45 35 15` models a 36*45 = 1620-bit main / 1260-bit live /
540-bit special modulus, which this framework matches with L=56, level=43,
alpha=19 (dnum stays 3). `scripts/bench_parity36.py` measures hmult at the
matched shape and writes PARITY36.json (see BENCH_NOTES.md "Bit-width
parity"), so the headline number exists at the reference's limb counts AND
at its modulus magnitude.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

# Montgomery radix for 32-bit device lanes.
R_BITS = 32
R = 1 << R_BITS
R_MASK = R - 1

# Prime magnitude window (see module docstring for why).
PRIME_MAX_BITS = 30
PRIME_MIN_BITS = 28

# Hard cap below 2**32 / 6: the Pallas NTT kernels run Harvey-style lazy
# butterflies with an approximate (3-multiply) Shoup high-word whose error
# is at most 1, so products land in [0, 3q) and stage values in [0, 6q).
# 6q < 2**32 keeps every intermediate wrap-free in uint32 lanes.
PRIME_CAP = (1 << 32) // 6  # 715827882; primes are generated strictly below


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (covers all our 30-bit primes)."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def modinv(a: int, m: int) -> int:
    return pow(a, -1, m)


@functools.lru_cache(maxsize=None)
def gen_ntt_primes(n: int, count: int, start_bits: int = PRIME_MAX_BITS) -> Tuple[int, ...]:
    """Generate `count` distinct primes q with q ≡ 1 (mod 2n), q < 2**start_bits.

    2n | q-1 guarantees a primitive 2n-th root of unity mod q, i.e. the
    negacyclic NTT of length n exists (X^n + 1 splits completely).
    Primes descend from just under 2**start_bits so the leading (base) prime
    is the largest — matching CKKS convention that q_0 carries decryption
    headroom while scale primes sit near the encoding scale Delta.
    """
    two_n = 2 * n
    primes: List[int] = []
    # Largest candidate of the form k*2n + 1 below min(2**start_bits, PRIME_CAP)
    # (see PRIME_CAP: the lazy NTT kernels need 6q < 2**32).
    k = (min((1 << start_bits), PRIME_CAP) - 2) // two_n
    while len(primes) < count:
        cand = k * two_n + 1
        if cand < (1 << PRIME_MIN_BITS):
            raise ValueError(
                f"ran out of {start_bits}-bit NTT primes for n={n} "
                f"(found {len(primes)} of {count})"
            )
        if is_prime(cand):
            primes.append(cand)
        k -= 1
    return tuple(primes)


def find_primitive_2n_root(q: int, n: int) -> int:
    """Find psi with psi^n ≡ -1 (mod q): a primitive 2n-th root of unity."""
    two_n = 2 * n
    assert (q - 1) % two_n == 0
    cof = (q - 1) // two_n
    # Scan small candidates deterministically for reproducible tables.
    for g in range(2, 10_000):
        psi = pow(g, cof, q)
        if pow(psi, n, q) == q - 1:
            return psi
    raise RuntimeError(f"no primitive 2n-th root found for q={q}, n={n}")


def mont_constants(q: int) -> Tuple[int, int, int]:
    """Return (qinv_neg, r2, r1) for Montgomery radix 2**32.

    qinv_neg = -q^{-1} mod 2**32  (the REDC multiplier)
    r2       = (2**32)^2 mod q    (to-Montgomery conversion constant)
    r1       = 2**32 mod q        (Montgomery form of 1)
    """
    qinv = modinv(q, R)
    qinv_neg = (R - qinv) % R
    r2 = (R * R) % q
    r1 = R % q
    return qinv_neg, r2, r1


def to_mont(x: int, q: int) -> int:
    """Host-side to-Montgomery: x * 2**32 mod q (for precomputed constants)."""
    return (x * R) % q


def bit_reverse(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def bit_reverse_perm(n: int) -> List[int]:
    bits = n.bit_length() - 1
    assert 1 << bits == n
    return [bit_reverse(i, bits) for i in range(n)]
