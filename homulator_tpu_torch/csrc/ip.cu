// Key-switch inner product of the piecewise route (kernel B18) for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves this step
// (homulator_tpu/ops/keyswitch.py::inner_product_pieces) to XLA, which
// fuses its elementwise ops on the TPU; PyTorch runs them eagerly, one
// int64 op at a time over the whole [B, K, n2, n1] block (about 125
// launches a key switch). For every ext row r (specials first, K = alpha +
// level rows), key component k and element b of the batch:
//
//   acc[b, k, r] = sum_d term_d[b, r] * key[d, k, r]     (Montgomery key)
//   term_d[b, r] = conv_d[b, r]                 r < alpha + lo_d
//                = d_eval[b, r - alpha]         r - alpha in [lo_d, hi_d)
//                = conv_d[b, r - (hi_d - lo_d)] otherwise
//
// conv_d holds digit d's converted rows in the EVAL domain (ext order minus
// its own rows: modup_conv_all's pieces, or their automorphisms on the
// hoisted route). Output: [B, 2, K, rows, cols] canonical residues, equal
// bit for bit to the plain version (homulator_tpu_torch/ops/ip.py::
// ip_plain). The work is elementwise over each row's rows x cols words
// (the plane), so a column slice of a coefficient-sharded basis is a
// narrower plane and nothing else.
//
// What bounds it on the card: bytes. At parameter set B, level 35 (N =
// 2^16, K = 50, three digits) a batch of 8 reads the terms once (8 x 3 x
// 50 rows, 315 MB), the key once (3 x 2 x 50 rows, 78.6 MB) and writes
// both accumulators (8 x 2 x 50 rows, 210 MB): 604 MB, 0.18 ms at 3.35
// TB/s. Its int32 work, 7 operations a lazy Montgomery product-accumulate
// (benchlib.OPS), 2 x 150 of them a column of an element, and a subtract
// an output word, is 1.2 G operations, 0.072 ms at the card's int32 rate.
//
// Design. A thread owns 4 consecutive words of one ext row (blockIdx.y)
// and moves them as 16-byte vectors, neighbouring threads on neighbouring
// addresses. It loads its 2 x beta x 4 key words into registers first and
// then loops over the batch, so the key crosses device memory once a
// launch, not once an element. The extended digit is never assembled:
// per digit the thread reads its row from conv_d or from d_eval by the
// digit's span (the index map of hpip.cu's term_d). Montgomery REDC on
// uint32 with a 64-bit product: a term below 2^31 times a key word below q
// gives (a*b + m*q) / 2^32 < 2q; each sum of an accumulator (< 2q) and a
// product (< 2q) stays below 4q < 2^32 (every prime is below 2^32 / 6)
// and goes back below 2q; one subtract of q at the end. The digit count is
// a template argument (1 .. kMaxBeta), so the key words and the digit
// loop stay in registers.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "modarith.cuh"

namespace {

using hk::csub;
using hk::mont_mul_lazy;

constexpr int kMaxBeta = 16;  // digits per key switch, as hpip.cu's
constexpr int kThreads = 256;

// The digits, passed by value as a kernel parameter: converted-row
// pointers and each digit's span of main rows [lo, hi). Read with indices
// the unrolled digit loop makes constant.
struct IpDigits {
  const uint32_t* conv[kMaxBeta];
  int lo[kMaxBeta];
  int hi[kMaxBeta];
};

__device__ __forceinline__ uint4 mont_acc(uint4 acc, uint4 a, uint4 b,
                                          uint32_t q, uint32_t qi,
                                          uint32_t q2) {
  acc.x = csub(acc.x + mont_mul_lazy(a.x, b.x, q, qi), q2);
  acc.y = csub(acc.y + mont_mul_lazy(a.y, b.y, q, qi), q2);
  acc.z = csub(acc.z + mont_mul_lazy(a.z, b.z, q, qi), q2);
  acc.w = csub(acc.w + mont_mul_lazy(a.w, b.w, q, qi), q2);
  return acc;
}

__device__ __forceinline__ uint4 reduce(uint4 a, uint32_t q) {
  return make_uint4(csub(a.x, q), csub(a.y, q), csub(a.z, q), csub(a.w, q));
}

// Words [4t, 4t + 4) of ext row r = blockIdx.y, t = the thread's index in
// the row, for every element of the batch. Rows hold `plane` words; key
// [dnum, 2, k_full, plane], d_eval [batch, level, plane], conv_d [batch,
// K - (hi_d - lo_d), plane], out [batch, 2, K, plane].
template <int kBeta>
__global__ void __launch_bounds__(kThreads)
ip_kernel(IpDigits dg, const uint32_t* __restrict__ d_eval,
          const uint32_t* __restrict__ key, uint32_t* __restrict__ out,
          const uint32_t* __restrict__ q, const uint32_t* __restrict__ qinv,
          int alpha, int level, int k_full, long long plane, int batch) {
  const long long w = 4 * ((long long)blockIdx.x * kThreads + threadIdx.x);
  if (w >= plane) return;
  const int r = blockIdx.y, K = alpha + level;
  const uint32_t qq = q[r], qi = qinv[r], q2 = 2 * qq;
  uint4 k0[kBeta], k1[kBeta];
#pragma unroll
  for (int d = 0; d < kBeta; ++d) {
    const uint32_t* kd = key + ((long long)(2 * d) * k_full + r) * plane + w;
    k0[d] = *reinterpret_cast<const uint4*>(kd);
    k1[d] = *reinterpret_cast<const uint4*>(kd + (long long)k_full * plane);
  }
  uint32_t* o = out + (long long)r * plane + w;
  for (int b = 0; b < batch; ++b) {
    uint4 acc0 = make_uint4(0, 0, 0, 0), acc1 = acc0;
#pragma unroll
    for (int d = 0; d < kBeta; ++d) {
      const int own_lo = alpha + dg.lo[d], nd = dg.hi[d] - dg.lo[d];
      const uint32_t* src =  // block-uniform choice of the term's row
          r < own_lo ? dg.conv[d] + ((long long)b * (K - nd) + r) * plane
          : r < own_lo + nd
              ? d_eval + ((long long)b * level + r - alpha) * plane
              : dg.conv[d] + ((long long)b * (K - nd) + r - nd) * plane;
      const uint4 t = *reinterpret_cast<const uint4*>(src + w);
      acc0 = mont_acc(acc0, t, k0[d], qq, qi, q2);
      acc1 = mont_acc(acc1, t, k1[d], qq, qi, q2);
    }
    uint32_t* ob = o + (long long)b * 2 * K * plane;
    *reinterpret_cast<uint4*>(ob) = reduce(acc0, qq);
    *reinterpret_cast<uint4*>(ob + (long long)K * plane) = reduce(acc1, qq);
  }
}

// f(std::integral_constant<int, B>()) for the runtime beta = B in [1,
// kMaxBeta]: the host's dispatch to the kernel's instantiation.
template <int B = 1, class F>
int with_beta(int beta, F&& f) {
  if constexpr (B > kMaxBeta) {
    return cudaErrorInvalidValue;
  } else {
    if (beta == B) return f(std::integral_constant<int, B>());
    return with_beta<B + 1>(beta, f);
  }
}

}  // namespace

extern "C" {

// convs: host array of beta device pointers, digit d's converted rows
// [batch, K - (hi_d - lo_d), plane]; spans: host int[2 * beta] (lo, hi)
// main-row spans; d_eval [batch, level, plane]; key [dnum, 2, k_full,
// plane] Montgomery, specials first, shared by the batch; out [batch, 2,
// K, plane] with K = alpha + level; q, qinv [K]. plane a multiple of 4,
// every pointer 16-byte aligned (ops/ip.py checks both).
int hk_ip(const void* convs, const void* spans, const void* d_eval,
          const void* key, void* out, const void* q, const void* qinv,
          int beta, int alpha, int level, int k_full, long long plane,
          int batch, void* stream) {
  const int K = alpha + level;
  const long long blocks = (plane / 4 + kThreads - 1) / kThreads;
  if (beta < 1 || beta > kMaxBeta || alpha < 1 || level < 1 || k_full < K ||
      K > 65535 || batch < 1 || plane < 4 || plane % 4 ||
      blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  IpDigits dg;
  for (int d = 0; d < kMaxBeta; ++d) {
    const bool on = d < beta;
    dg.conv[d] = on ? static_cast<const uint32_t* const*>(convs)[d] : nullptr;
    dg.lo[d] = on ? static_cast<const int*>(spans)[2 * d] : 0;
    dg.hi[d] = on ? static_cast<const int*>(spans)[2 * d + 1] : 0;
    if (on && (dg.lo[d] < 0 || dg.hi[d] <= dg.lo[d] || dg.hi[d] > level))
      return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_beta(beta, [&](auto b) {
    constexpr int kBeta = decltype(b)::value;
    ip_kernel<kBeta><<<dim3((unsigned)blocks, K), kThreads, 0, st>>>(
        dg, static_cast<const uint32_t*>(d_eval),
        static_cast<const uint32_t*>(key), static_cast<uint32_t*>(out),
        static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(qinv),
        alpha, level, k_full, plane, batch);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
