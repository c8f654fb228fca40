// Modular arithmetic on uint32 residues for the kernels of this directory
// (and ilog2, which their hosts check lengths with).
//
// Every prime q is below PRIME_CAP = 2^32/6 < 2^30
// (homulator_tpu_torch/numtheory.py:49), so sums of two residues and the
// Shoup remainder (< 2q) never leave uint32, nor do the lazy [0, 4q) ranges
// of B1 and B2 (ntt_reg.cuh).
// Hopper multiplies 32x32 -> 64 natively: __umulhi gives the exact high
// word, so the TPU's 16-bit partial products and approximate high word
// (homulator_tpu/ops/modmath.py:36-58, 136-157) have no counterpart here.
#pragma once

#include <cstdint>

namespace hk {

__device__ __forceinline__ uint32_t mod_add(uint32_t a, uint32_t b,
                                            uint32_t q) {
  const uint32_t s = a + b;
  return s >= q ? s - q : s;
}

__device__ __forceinline__ uint32_t mod_sub(uint32_t a, uint32_t b,
                                            uint32_t q) {
  return a >= b ? a - b : a + q - b;
}

// a * w - floor(a * w_sh / 2^32) * q for w_sh = floor(w * 2^32 / q), w < q:
// lies in [0, 2q) for any uint32 a.
__device__ __forceinline__ uint32_t shoup_mul_lazy(uint32_t a, uint32_t w,
                                                   uint32_t w_sh,
                                                   uint32_t q) {
  return a * w - __umulhi(a, w_sh) * q;
}

// a * w mod q in [0, q).
__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint32_t w,
                                              uint32_t w_sh, uint32_t q) {
  const uint32_t r = shoup_mul_lazy(a, w, w_sh, q);
  return r >= q ? r - q : r;
}

// sum_{i < n} x[i] * w[i] over register-resident inputs x (any uint32: an
// input may exceed q), each term a lazy Shoup product in [0, 2q) summed in
// uint64, which no n <= MAXND <= 2^31 can overflow; the caller reduces the
// sum mod q once. The multiply-accumulate of both base conversions (B3,
// B5), with w, w_sh one output row of the matrix Shoup pair.
template <int MAXND>
__device__ __forceinline__ uint64_t shoup_dot_lazy(const uint32_t (&x)[MAXND],
                                                   int n, const uint32_t* w,
                                                   const uint32_t* w_sh,
                                                   uint32_t q) {
  uint64_t acc = 0;
#pragma unroll
  for (int i = 0; i < MAXND; ++i) {
    if (i < n) acc += shoup_mul_lazy(x[i], w[i], w_sh[i], q);
  }
  return acc;
}

// log2(n) for a power of two n >= 1, else -1: the hosts' shape checks.
inline int ilog2(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return (1 << l) == n ? l : -1;
}

// a - m if a >= m, else a.
__device__ __forceinline__ uint32_t csub(uint32_t a, uint32_t m) {
  return a >= m ? a - m : a;
}

// Montgomery product a * b * 2^-32 mod q, in [0, 2q) for a, b < q
// (qinv_neg = -q^{-1} mod 2^32): (a*b + m*q) / 2^32 < q^2 / 2^32 + q.
__device__ __forceinline__ uint32_t mont_mul_lazy(uint32_t a, uint32_t b,
                                                  uint32_t q,
                                                  uint32_t qinv_neg) {
  const uint64_t t = (uint64_t)a * b;
  const uint32_t m = (uint32_t)t * qinv_neg;
  return (uint32_t)((t + (uint64_t)m * q) >> 32);
}

}  // namespace hk
