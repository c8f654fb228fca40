// Modular arithmetic on uint32 residues for the kernels of this directory
// (and ilog2, which their hosts check lengths with).
//
// Every prime q is below PRIME_CAP = 2^32/6 < 2^30
// (homulator_tpu_torch/numtheory.py:49), so sums of two residues and the
// Shoup remainder (< 2q) never leave uint32, nor do the lazy [0, 4q) ranges
// of B1 and B2 (ntt_reg.cuh).
// Hopper multiplies 32x32 -> 64 natively: __umulhi gives the exact high
// word, so the TPU's 16-bit partial products and approximate high word
// (homulator_tpu/ops/modmath.py:36-58, 136-157) have no counterpart on any
// op's path; ShoupNatmul and ShoupApprox below time them (kernel B15).
#pragma once

#include <cstdint>

namespace hk {

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

// The lazy Shoup product a * w mod q of the CT butterflies (ntt_reg.cuh's
// ct_lazy, ct_pass, radix_ct_rows take it as their Mul), in [0, 2q) for any
// uint32 a, in three forms of the high word floor(a * w_sh / 2^32):
//   ShoupLazy    __umulhi's exact high word: every kernel's form;
//   ShoupNatmul  the exact high word from four 16-bit partial products with
//                their carries, the TPU's form (scripts/microbench_ntt2.py,
//                shoup_natmul);
//   ShoupApprox  the TPU's three partial products without the low one
//                (microbench_ntt2.py, shoup_approx): short by at most 1, so
//                a * w - hi * q lies in [0, 3q) (3q < 2^32 as q < 2^32/6),
//                and one conditional subtract of 2q brings it to [0, 2q)
//                before a butterfly adds it (7q would wrap uint32).
// Kernel B15 (anatomy.cu) times the three on B1's register passes.
struct ShoupLazy {
  __device__ __forceinline__ static uint32_t mul(uint32_t a, uint32_t w,
                                                 uint32_t w_sh, uint32_t q) {
    return shoup_mul_lazy(a, w, w_sh, q);
  }
};

struct ShoupNatmul {
  __device__ __forceinline__ static uint32_t mul(uint32_t a, uint32_t w,
                                                 uint32_t w_sh, uint32_t q) {
    const uint32_t a0 = a & 0xFFFFu, a1 = a >> 16;
    const uint32_t b0 = w_sh & 0xFFFFu, b1 = w_sh >> 16;
    const uint32_t ll = a0 * b0, lh = a0 * b1, hl = a1 * b0, hh = a1 * b1;
    const uint32_t mid = lh + hl;
    const uint32_t carry_mid = mid < lh;
    const uint32_t lo = ll + (mid << 16);
    const uint32_t carry_lo = lo < ll;
    const uint32_t hi = hh + (mid >> 16) + (carry_mid << 16) + carry_lo;
    return a * w - hi * q;
  }
};

struct ShoupApprox {
  __device__ __forceinline__ static uint32_t mul(uint32_t a, uint32_t w,
                                                 uint32_t w_sh, uint32_t q) {
    const uint32_t a0 = a & 0xFFFFu, a1 = a >> 16;
    const uint32_t b0 = w_sh & 0xFFFFu, b1 = w_sh >> 16;
    const uint32_t lh = a0 * b1, hl = a1 * b0, hh = a1 * b1;
    const uint32_t mid = lh + hl;
    const uint32_t carry_mid = mid < lh;
    const uint32_t hi = hh + (mid >> 16) + (carry_mid << 16);
    return csub(a * w - hi * q, q + q);
  }
};

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
