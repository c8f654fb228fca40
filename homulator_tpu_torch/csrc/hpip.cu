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
// read or written once, are 170.6 MB: the 115 converted rows (30.1 MB),
// the 35 own rows (9.2 MB), the key's 3 x 2 x 50 rows (78.6 MB), the mid
// twiddle and its Shoup table for the 50 ext rows (26.2 MB) and the output
// (26.2 MB): 0.051 ms at 3.35 TB/s. The integer work is 115 row NTTs
// (N/2 * 16 butterflies + N mid-twiddle products each) and 3 x 2 x 50 rows
// of Montgomery products: about 0.97 G int32 operations, 0.058 ms at the
// card's int32 rate. The two are of the same order.
//
// Design. The TPU kernel keeps a whole limb (256 KiB) in VMEM and carries
// the sum over digits in scratch across a sequential (row, digit) grid. A
// Hopper block has at most 227 KB of shared memory and blocks run in no
// order, so this kernel is two launches:
//   (a) hpip_a, grid (sum_d m_other_d, n2/TC): forward phase A (CT along
//       n1, times tw_mid, transposed write) of every converted row into a
//       scratch [sum_d m_other_d, n2, n1], each row with the tables of its
//       ext row: the device code of ntt_fwd_a (ntt_tile.cuh).
//   (b) hpip_b, grid (K, n1/TC): a block owns an [n2, TC] column tile of
//       ext row r and loops over the digits inside the block (the TPU's
//       sequential digit axis): it loads the d_eval tile for an own row, or
//       the scratch tile and runs the CT stages along n2 with row r's tw2,
//       then multiplies by evk[d, 0, r] and evk[d, 1, r]. Both sums stay in
//       registers, each kept below 2q after every add, and are reduced to
//       [0, q) and written once after the last digit.
// The eval-domain lifted digits never reach device memory, which is the
// fusion the TPU kernel exists for; the phase-A scratch stays, because the
// shared-memory limit forces it. Twiddles come from global memory through
// the cache and stages synchronise the block: making it fast (TMA, tables
// in shared memory, several stages per register pass) is later work.

#include <cuda_runtime.h>

#include <cstdint>

#include "ntt_tile.cuh"

namespace {

using hk::csub;
using hk::kLogTileCols;
using hk::kThreads;
using hk::min_int;
using hk::mont_mul_lazy;
using hk::tile_smem;

constexpr int kMaxBeta = 16;  // digits per key switch
constexpr int kMaxEpt = 32;   // tile elements per thread in phase B

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

// Ext row of conv-local row l of a digit whose own rows are ext rows
// [own_lo, own_lo + nd): the conversion skips them.
__device__ __forceinline__ int ext_row(int l, int own_lo, int nd) {
  return l < own_lo ? l : l + nd;
}

__global__ void __launch_bounds__(kThreads)
hpip_a(HpipDigits dg, uint32_t* __restrict__ scratch,
       const uint32_t* __restrict__ q, const uint32_t* __restrict__ tw1,
       const uint32_t* __restrict__ tw1_sh, const uint32_t* __restrict__ mid,
       const uint32_t* __restrict__ mid_sh, int alpha, int log1, int log2,
       int logtc) {
  extern __shared__ uint32_t s[];
  const int g = blockIdx.x;
  int d = 0;
  while (g >= dg.row0[d + 1]) ++d;
  const int l = g - dg.row0[d];
  const int r = ext_row(l, alpha + dg.lo[d], dg.hi[d] - dg.lo[d]);
  const size_t N = (size_t)1 << (log1 + log2);
  hk::fwd_a_tile(s, dg.conv[d] + l * N, scratch + g * N, q[r],
                 tw1 + ((size_t)r << log1), tw1_sh + ((size_t)r << log1),
                 mid + r * N, mid_sh + r * N, log1, log2, logtc,
                 blockIdx.y << logtc);
}

__global__ void __launch_bounds__(kThreads)
hpip_b(HpipDigits dg, const uint32_t* __restrict__ scratch,
       const uint32_t* __restrict__ d_eval, const uint32_t* __restrict__ key,
       uint32_t* __restrict__ out, const uint32_t* __restrict__ q,
       const uint32_t* __restrict__ qinv, const uint32_t* __restrict__ tw2,
       const uint32_t* __restrict__ tw2_sh, int alpha, int K, int k_full,
       int log1, int log2, int logtc) {
  extern __shared__ uint32_t s[];
  const int ld = (1 << logtc) + 1;
  const int r = blockIdx.x, c0 = blockIdx.y << logtc;
  const int n1 = 1 << log1;
  const size_t N = (size_t)1 << (log1 + log2);
  const int tile = 1 << (log2 + logtc);
  const uint32_t qq = q[r], qi = qinv[r], q2 = 2 * qq;
  uint32_t acc0[kMaxEpt], acc1[kMaxEpt];
#pragma unroll
  for (int i = 0; i < kMaxEpt; ++i) acc0[i] = acc1[i] = 0;

  for (int d = 0; d < dg.beta; ++d) {
    const int own_lo = alpha + dg.lo[d], own_hi = alpha + dg.hi[d];
    if (r >= own_lo && r < own_hi) {  // block-uniform branch
      hk::load_tile(s, d_eval + (size_t)(r - alpha) * N, log2, logtc, ld,
                    n1, c0, nullptr, nullptr, qq);
    } else {
      const int l = r < own_lo ? r : r - (own_hi - own_lo);
      hk::load_tile(s, scratch + (size_t)(dg.row0[d] + l) * N, log2, logtc,
                    ld, n1, c0, nullptr, nullptr, qq);
      hk::ct_rows(s, log2, logtc, ld, tw2 + ((size_t)r << log2),
                  tw2_sh + ((size_t)r << log2), qq);
    }
    const uint32_t* k0 = key + ((size_t)(2 * d) * k_full + r) * N;
    const uint32_t* k1 = key + ((size_t)(2 * d + 1) * k_full + r) * N;
#pragma unroll
    for (int i = 0; i < kMaxEpt; ++i) {
      const int t = threadIdx.x + i * kThreads;
      if (t < tile) {
        const int rr = t >> logtc, c = t & ((1 << logtc) - 1);
        const uint32_t v = s[rr * ld + c];  // term in [0, q)
        const size_t gi = (size_t)rr * n1 + c0 + c;
        // sums < 2q + 2q < 2^32 (q < 2^30), back below 2q
        acc0[i] = csub(acc0[i] + mont_mul_lazy(v, k0[gi], qq, qi), q2);
        acc1[i] = csub(acc1[i] + mont_mul_lazy(v, k1[gi], qq, qi), q2);
      }
    }
    __syncthreads();  // the next digit overwrites the tile
  }
  uint32_t* o0 = out + (size_t)r * N;
  uint32_t* o1 = out + ((size_t)K + r) * N;
#pragma unroll
  for (int i = 0; i < kMaxEpt; ++i) {
    const int t = threadIdx.x + i * kThreads;
    if (t < tile) {
      const size_t gi =
          (size_t)(t >> logtc) * n1 + c0 + (t & ((1 << logtc) - 1));
      o0[gi] = csub(acc0[i], qq);
      o1[gi] = csub(acc1[i], qq);
    }
  }
}

}  // namespace

extern "C" {

// convs: host array of beta device pointers, digit d's converted rows
// [conv_rows[d], n1, n2] (coeff domain, ext order minus its own rows);
// conv_rows: host int[beta]; spans: host int[2 * beta] (lo, hi) main-row
// spans; d_eval [level, n2, n1]; key [dnum, 2, k_full, n2, n1] Montgomery,
// specials first; scratch [sum conv_rows, n2, n1]; out [2, K, n2, n1] with
// K = alpha + level; q, qinv [K] and the ext basis's forward tables (tw1,
// tw1_sh [K, n1]; mid, mid_sh [K, n1, n2]; tw2, tw2_sh [K, n2]).
int hk_hpip(const void* convs, const void* conv_rows, const void* spans,
            const void* d_eval, const void* key, void* scratch, void* out,
            const void* q, const void* qinv, const void* tw1,
            const void* tw1_sh, const void* mid, const void* mid_sh,
            const void* tw2, const void* tw2_sh, int beta, int alpha,
            int level, int k_full, int n1, int n2, void* stream) {
  const int log1 = hk::ilog2(n1), log2 = hk::ilog2(n2);
  const int K = alpha + level;
  const int lta = min_int(kLogTileCols, log2);
  const int ltb = min_int(kLogTileCols, log1);
  if (log1 < 1 || log2 < 1 || log1 > 10 || log2 > 10 || beta < 1 ||
      beta > kMaxBeta || alpha < 1 || level < 1 || k_full < K ||
      (n2 << ltb) > kThreads * kMaxEpt)
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const uint32_t*>(q);
  size_t smem;
  cudaError_t err;
  if ((err = tile_smem(hpip_a, log1, lta, &smem)) != cudaSuccess) return err;
  hpip_a<<<dim3(dg.row0[beta], n2 >> lta), kThreads, smem, st>>>(
      dg, static_cast<uint32_t*>(scratch), qp,
      static_cast<const uint32_t*>(tw1), static_cast<const uint32_t*>(tw1_sh),
      static_cast<const uint32_t*>(mid), static_cast<const uint32_t*>(mid_sh),
      alpha, log1, log2, lta);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = tile_smem(hpip_b, log2, ltb, &smem)) != cudaSuccess) return err;
  hpip_b<<<dim3(K, n1 >> ltb), kThreads, smem, st>>>(
      dg, static_cast<const uint32_t*>(scratch),
      static_cast<const uint32_t*>(d_eval), static_cast<const uint32_t*>(key),
      static_cast<uint32_t*>(out), qp, static_cast<const uint32_t*>(qinv),
      static_cast<const uint32_t*>(tw2), static_cast<const uint32_t*>(tw2_sh),
      alpha, K, k_full, log1, log2, ltb);
  return cudaGetLastError();
}

}  // extern "C"
