// Fused ModUp NTT + key-switch inner product (kernel B4, the HPIP unit)
// for Hopper (sm_90a).
//
// Replaces: homulator_tpu/ops/hpip_pallas.py::hpip_fused. For every ext
// row r (specials first, K = alpha + level rows) and key component k:
//
//   acc[k, r] = sum_d term_d[r] * evk[d, k, r]          (Montgomery key)
//   term_d[r] = NTT(conv_d[row r])   r outside digit d's own rows
//             = d_eval[r - alpha]    r one of them (exact passthrough)
//
// Output: [2, K, n2, n1] canonical residues, equal bit for bit to the plain
// version (homulator_tpu_torch/ops/hpip.py::hpip_plain) and to the inner
// product of the unfused route.
//
// What bounds it on the card. At parameter set B, level 35 (N = 2^16,
// alpha 15, digits (0,15) (15,30) (30,35)) the inputs and output, each
// read or written once, are 170.4 MB: the 115 converted rows (30.1 MB),
// the 35 own rows (9.2 MB), the key's 3 x 2 x 50 rows (78.6 MB), the mid
// twiddle and its Shoup table for the 50 ext rows (26.2 MB) and the output
// (26.2 MB): 0.051 ms at 3.35 TB/s. The integer work, counted as this
// kernel does it (benchlib.hpip_ops), is 115 row NTTs of Harvey
// butterflies and 3 x 2 x 50 rows of lazy Montgomery products: 0.74 G
// int32 operations, 0.044 ms at the card's int32 rate. Bytes bound it.
//
// Design. The TPU kernel keeps a whole limb (256 KiB) in VMEM and carries
// the sum over digits in scratch across a sequential (row, digit) grid. A
// Hopper block has at most 227 KB of shared memory and blocks run in no
// order, so this kernel is two launches, both on the register radix passes
// of B1 (ntt_reg.cuh: a 2^L-point axis is two passes in registers with one
// shared-memory exchange, Harvey's lazy butterflies, the columns a block
// holds, TC, chosen on the host):
//   (a) hpip_radix_a<log n1>, grid (sum_d m_other_d, n2/TC): B1's phase A
//       (CT along n1, times tw_mid, transposed write) on every converted
//       row into a scratch [sum_d m_other_d, n2, n1], each row with the
//       tables of its ext row.
//   (b) hpip_radix_b<log n2>, grid (K, n1/TC): a block owns the [n2, TC]
//       column tile of ext row r, stages row r's tw2 pair in shared memory
//       once and loops over the digits inside the block (the TPU's
//       sequential digit axis). For a converted row it loads the scratch
//       tile's strided rows and runs B1's phase-B passes (radix_ct_rows),
//       which leave each thread the contiguous rows u*R + t in [0, 4q); for
//       one of the digit's own rows it loads those rows of d_eval (no NTT;
//       the branch is the same for the whole block, so the barriers of
//       the other branch are block-uniform). Then, in registers, for
//       k = 0, 1: acc_k = csub(acc_k + mont_mul_lazy(v, evk[d, k, r]), 2q);
//       after the last digit one reduction to [0, q) and one store.
// Lazy ranges: every prime is below 2^32/6, so 4q < 2^32. A term v < 4q
// times a key word b < q gives (v*b + m*q) / 2^32 < 4q^2/2^32 + q < 2q;
// each sum of an accumulator (< 2q) and a product (< 2q) stays below 4q
// and goes back below 2q (tests/test_torch_hpip_radix.py asserts every
// margin on an int64 model of this schedule).
// The eval-domain lifted digits never reach device memory, which is the
// fusion the TPU kernel exists for; the phase-A scratch stays, because no
// block holds a limb. Phase B holds 3R values a thread (the term and both
// sums), so its registers are capped at 128 (two blocks of 256 threads an
// SM at R = 16), where B1's 64 would spill; keeping the sums in shared
// memory instead, at B1's cap, was 7% slower on an H100 (PERF.md §6).
// Both axes are at most 2^8 (N <= 2^16), as for the kernel before: at R =
// 32 the compiler no longer unrolls phase B's passes and v goes to local
// memory.
// A batch of B key switches under one key (the batched hmult's) is one
// launch pair: blockIdx.z picks the element, as a vmap adds a grid axis to
// the TPU kernel. Element b's pieces, scratch and output follow element b
// - 1's (each piece [B, rows_d, n1, n2], the scratch [B, sum rows_d, n2,
// n1], the output [B, 2, K, n2, n1], all contiguous), its d_eval
// d_eval_bstride words after; the key and the tables are the same for
// every element and are read, not copied, by every z-slice.

#include <cuda_runtime.h>

#include <cstdint>

#include "ntt_reg.cuh"

namespace {

using hk::csub;
using hk::mont_mul_lazy;
using hk::RadixSplit;

constexpr int kMaxBeta = 16;  // digits per key switch
constexpr int kMaxLog = 8;    // n1, n2 <= 2^kMaxLog

// The digits, passed by value as a kernel parameter: converted-row
// pointers, each digit's first row in the phase-A scratch, and its span of
// main rows [lo, hi).
struct HpipDigits {
  const uint32_t* conv[kMaxBeta];
  int row0[kMaxBeta + 1];
  int lo[kMaxBeta];
  int hi[kMaxBeta];
  int beta;
};

// Digit d's first scratch row and span: its fields read with constant
// indices, since a runtime index into the parameter struct would copy it
// to local memory.
struct Digit {
  int row0, lo, hi;
};
__device__ __forceinline__ Digit digit(const HpipDigits& dg, int d) {
  Digit out{dg.row0[0], dg.lo[0], dg.hi[0]};
#pragma unroll
  for (int i = 1; i < kMaxBeta; ++i)
    if (i == d) out = Digit{dg.row0[i], dg.lo[i], dg.hi[i]};
  return out;
}

// Ext row of conv-local row l of a digit whose own rows are ext rows
// [own_lo, own_lo + nd): the conversion skips them.
__device__ __forceinline__ int ext_row(int l, int own_lo, int nd) {
  return l < own_lo ? l : l + nd;
}

// Phase A on scratch row g = blockIdx.x: B1's phase A (radix_phase<L,
// true, true>) on conv-local row l of its digit, with the tables of the ext
// row r it lifts to. x rows [n1 = 2^L, ncols = n2], scratch rows [n2, n1].
template <int L>
__global__ void __launch_bounds__(RadixSplit<L>::kMaxThreads,
                                  RadixSplit<L>::kMinBlocks)
hpip_radix_a(HpipDigits dg, uint32_t* __restrict__ scratch,
             const uint32_t* __restrict__ q, const uint32_t* __restrict__ tw1,
             const uint32_t* __restrict__ tw1_sh,
             const uint32_t* __restrict__ mid,
             const uint32_t* __restrict__ mid_sh, int alpha, int ncols,
             int logtc) {
  const int g = blockIdx.x;
  const uint32_t* conv = dg.conv[0];
  int d = 0, rows = dg.row0[1] - dg.row0[0];
#pragma unroll
  for (int i = 1; i < kMaxBeta; ++i)
    if (i < dg.beta && g >= dg.row0[i])
      d = i, conv = dg.conv[i], rows = dg.row0[i + 1] - dg.row0[i];
  const Digit dd = digit(dg, d);
  const int l = g - dd.row0;
  const int r = ext_row(l, alpha + dd.lo, dd.hi - dd.lo);
  const size_t len = (size_t)ncols << L;
  conv += blockIdx.z * rows * len;  // this element's piece
  scratch += blockIdx.z * dg.row0[kMaxBeta] * len;
  hk::radix_phase<L, true, true>(
      conv + l * len, scratch + g * len, q[r], tw1 + ((size_t)r << L),
      tw1_sh + ((size_t)r << L), mid + r * len, mid_sh + r * len, ncols,
      logtc, blockIdx.y << logtc);
}

// Phase B on the [n2 = 2^L, TC] tile at column TC*blockIdx.y of ext row r =
// blockIdx.x: the digit loop of the design note. scratch, d_eval and out
// rows [n2, n1 = ncols]; key [dnum, 2, k_full, n2, n1].
template <int L>
__global__ void __launch_bounds__(RadixSplit<L>::kMaxThreads, 2)
hpip_radix_b(HpipDigits dg, const uint32_t* __restrict__ scratch,
             const uint32_t* __restrict__ d_eval,
             const uint32_t* __restrict__ key, uint32_t* __restrict__ out,
             const uint32_t* __restrict__ q,
             const uint32_t* __restrict__ qinv,
             const uint32_t* __restrict__ tw2,
             const uint32_t* __restrict__ tw2_sh, int alpha, int K,
             int k_full, int ncols, int logtc, long long d_eval_bstride) {
  using S = RadixSplit<L>;
  constexpr int n = 1 << L, R = S::kR, U = S::kU;
  extern __shared__ uint32_t sm[];
  uint32_t* const tws = sm;  // stage row [n], then its Shoup row [n]
  uint32_t* const tile = sm + 2 * n;
  const int r = blockIdx.x;
  const int c = threadIdx.x & ((1 << logtc) - 1);
  const int u = threadIdx.x >> logtc;
  const int col = (blockIdx.y << logtc) + c;
  const size_t len = (size_t)ncols << L;
  scratch += blockIdx.z * dg.row0[kMaxBeta] * len;  // this element's
  d_eval += blockIdx.z * d_eval_bstride;
  out += blockIdx.z * 2 * (size_t)K * len;
  const uint32_t qq = q[r], qi = qinv[r], q2 = 2 * qq;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    tws[k] = tw2[((size_t)r << L) + k];
    tws[n + k] = tw2_sh[((size_t)r << L) + k];
  }
  __syncthreads();
  uint32_t acc0[R], acc1[R];
#pragma unroll
  for (int t = 0; t < R; ++t) acc0[t] = acc1[t] = 0;

  for (int d = 0; d < dg.beta; ++d) {
    const Digit dd = digit(dg, d);
    const int own_lo = alpha + dd.lo, own_hi = alpha + dd.hi;
    uint32_t v[R];
    if (r >= own_lo && r < own_hi) {  // block-uniform: no NTT
      const uint32_t* x = d_eval + (r - alpha) * len;
#pragma unroll
      for (int t = 0; t < R; ++t)  // values < q
        v[t] = x[(size_t)(u * R + t) * ncols + col];
    } else {
      const int l = r < own_lo ? r : r - (own_hi - own_lo);
      const uint32_t* x = scratch + (dd.row0 + l) * len;
#pragma unroll
      for (int t = 0; t < R; ++t)  // values < q
        v[t] = x[(size_t)(u + U * t) * ncols + col];
      hk::radix_ct_rows<L>(v, tile, tws, qq, u, c, logtc);  // [0, 4q)
      __syncthreads();  // the next conversion overwrites the tile
    }
    const uint32_t* k0 = key + ((size_t)(2 * d) * k_full + r) * len;
    const uint32_t* k1 = k0 + (size_t)k_full * len;
#pragma unroll
    for (int t = 0; t < R; ++t) {  // products < 2q, sums < 4q, back < 2q
      const size_t gi = (size_t)(u * R + t) * ncols + col;
      acc0[t] = csub(acc0[t] + mont_mul_lazy(v[t], k0[gi], qq, qi), q2);
      acc1[t] = csub(acc1[t] + mont_mul_lazy(v[t], k1[gi], qq, qi), q2);
    }
  }
  uint32_t* const o0 = out + r * len;
  uint32_t* const o1 = out + ((size_t)K + r) * len;
#pragma unroll
  for (int t = 0; t < R; ++t) {
    const size_t gi = (size_t)(u * R + t) * ncols + col;
    o0[gi] = csub(acc0[t], qq);
    o1[gi] = csub(acc1[t], qq);
  }
}

}  // namespace

extern "C" {

// convs: host array of beta device pointers, digit d's converted rows
// [batch, conv_rows[d], n1, n2] (coeff domain, ext order minus its own
// rows); conv_rows: host int[beta]; spans: host int[2 * beta] (lo, hi)
// main-row spans; d_eval [batch][level, n2, n1], element b at d_eval + b
// d_eval_bstride words; key [dnum, 2, k_full, n2, n1] Montgomery, specials
// first, shared by the batch; scratch [batch, sum conv_rows, n2, n1]; out
// [batch, 2, K, n2, n1] with K = alpha + level; q, qinv [K] and the ext
// basis's forward tables (tw1,
// tw1_sh [K, n1]; mid, mid_sh [K, n1, n2]; tw2, tw2_sh [K, n2]); tiles of
// 2^logtc_a columns (of n2) in phase A, 2^logtc_b (of n1) in phase B
// (ops/hpip.py::hpip_phases).
int hk_hpip(const void* convs, const void* conv_rows, const void* spans,
            const void* d_eval, const void* key, void* scratch, void* out,
            const void* q, const void* qinv, const void* tw1,
            const void* tw1_sh, const void* mid, const void* mid_sh,
            const void* tw2, const void* tw2_sh, int beta, int alpha,
            int level, int k_full, int n1, int n2, int logtc_a, int logtc_b,
            int batch, long long d_eval_bstride, void* stream) {
  const int log1 = hk::ilog2(n1), log2 = hk::ilog2(n2);
  const int K = alpha + level;
  if (log1 < 1 || log2 < 1 || beta < 1 || beta > kMaxBeta || alpha < 1 ||
      level < 1 || k_full < K || batch < 1 || batch > 65535 ||
      (batch > 1 && d_eval_bstride < (long long)level * n1 * n2))
    return cudaErrorInvalidValue;
  HpipDigits dg;
  dg.beta = beta;
  dg.row0[0] = 0;
  for (int d = 0; d < beta; ++d) {
    dg.conv[d] = static_cast<const uint32_t* const*>(convs)[d];
    dg.lo[d] = static_cast<const int*>(spans)[2 * d];
    dg.hi[d] = static_cast<const int*>(spans)[2 * d + 1];
    const int rows = static_cast<const int*>(conv_rows)[d];
    if (dg.lo[d] < 0 || dg.hi[d] <= dg.lo[d] || dg.hi[d] > level ||
        rows != K - (dg.hi[d] - dg.lo[d]))
      return cudaErrorInvalidValue;
    dg.row0[d + 1] = dg.row0[d] + rows;
  }
  for (int d = beta; d < kMaxBeta; ++d) {
    dg.conv[d] = nullptr;
    dg.lo[d] = dg.hi[d] = 0;
    dg.row0[d + 1] = dg.row0[beta];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const uint32_t*>(q);
  int err = hk::with_log<kMaxLog>(log1, [&](auto l) {
    constexpr int L = decltype(l)::value;
    int threads;
    size_t smem;
    const cudaError_t e =
        hk::radix_block<L>(hpip_radix_a<L>, log2, logtc_a, &threads, &smem);
    if (e != cudaSuccess) return (int)e;
    hpip_radix_a<L><<<dim3(dg.row0[beta], n2 >> logtc_a, batch), threads,
                      smem, st>>>(
        dg, static_cast<uint32_t*>(scratch), qp,
        static_cast<const uint32_t*>(tw1),
        static_cast<const uint32_t*>(tw1_sh),
        static_cast<const uint32_t*>(mid),
        static_cast<const uint32_t*>(mid_sh), alpha, n2, logtc_a);
    return (int)cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  return hk::with_log<kMaxLog>(log2, [&](auto l) {
    constexpr int L = decltype(l)::value;
    int threads;
    size_t smem;
    const cudaError_t e =
        hk::radix_block<L>(hpip_radix_b<L>, log1, logtc_b, &threads, &smem);
    if (e != cudaSuccess) return (int)e;
    hpip_radix_b<L><<<dim3(K, n1 >> logtc_b, batch), threads, smem, st>>>(
        dg, static_cast<const uint32_t*>(scratch),
        static_cast<const uint32_t*>(d_eval),
        static_cast<const uint32_t*>(key), static_cast<uint32_t*>(out), qp,
        static_cast<const uint32_t*>(qinv),
        static_cast<const uint32_t*>(tw2),
        static_cast<const uint32_t*>(tw2_sh), alpha, K, k_full, n1,
        logtc_b, d_eval_bstride);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
