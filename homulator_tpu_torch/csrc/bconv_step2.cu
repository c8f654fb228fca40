// RNS base-conversion step 2 (kernel B5) for Hopper (sm_90a).
//
// Replaces: homulator_tpu/ops/bconv_pallas.py::bconv_step2_pallas, the
// kernel form of homulator_tpu/ops/bconv.py::bconv_step2. Per coefficient c
// of nd already-scaled input rows xhat_i (the last one may be the
// centering count row v) it computes
//   out_j = sum_i xhat_i * M[j, i] mod p_j
// with every output the canonical residue, so the result equals the plain
// version (homulator_tpu_torch/ops/bconv.py::bconv_step2_plain) bit for bit.
// The JAX package's graph route (ntt_mode="jnp") runs this function in
// every ModUp digit and every ModDown.
//
// Inputs may exceed the output prime: xhat_i < q_i can be >= p_j, and v is
// a small count. The Shoup product a*w - floor(a*w_sh / 2^32)*p lies in
// [0, 2p) for any uint32 a when w < p (modarith.cuh), so no bound below
// assumes xhat_i < p_j.
//
// What bounds it on the card: integer instruction throughput. A set-B
// ModUp digit (16 rows -> 35) moves 13.4 MB but does 16 * 35 Shoup
// products and 35 64-bit reductions per coefficient.
//
// Design (simple first): one thread per coefficient keeps its nd inputs in
// registers (instantiated for nd <= 16 and nd <= 32; nd reaches 29 at set A,
// alpha 28 plus the count row; a wider nd is refused), and loops over a
// chunk of kRows output rows, the chunk being the block's y index, so a
// 35-row conversion at N = 2^16 runs 256 x 5 blocks. The chunk's matrix
// rows, their Shoup quotients and primes sit in shared memory, read as
// broadcasts; loads and stores are coalesced along the coefficient axis.
// Each product is lazy, summed in uint64 and reduced once
// (hk::shoup_dot_lazy, shared with B3).

#include <cuda_runtime.h>

#include <cstdint>

#include "modarith.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // output rows a block computes
constexpr int kMaxNd = 32;

template <int MAXND>
__global__ void __launch_bounds__(kThreads)
bconv_step2_kernel(const uint32_t* __restrict__ xhat,
                   uint32_t* __restrict__ out,
                   const uint32_t* __restrict__ mat,
                   const uint32_t* __restrict__ mat_sh,
                   const uint32_t* __restrict__ out_q, int nd, int m_out,
                   long long ncoef) {
  __shared__ uint32_t smat[kRows * kMaxNd];
  __shared__ uint32_t smat_sh[kRows * kMaxNd];
  __shared__ uint32_t sq[kRows];
  const int j0 = blockIdx.y * kRows;
  const int rows = min(kRows, m_out - j0);
  for (int t = threadIdx.x; t < rows * nd; t += blockDim.x) {
    smat[t] = mat[(long long)j0 * nd + t];
    smat_sh[t] = mat_sh[(long long)j0 * nd + t];
  }
  for (int t = threadIdx.x; t < rows; t += blockDim.x) sq[t] = out_q[j0 + t];
  __syncthreads();

  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ncoef) return;
  uint32_t x[MAXND];
#pragma unroll
  for (int i = 0; i < MAXND; ++i) x[i] = i < nd ? xhat[i * ncoef + c] : 0;
  for (int j = 0; j < rows; ++j) {
    const uint32_t p = sq[j];
    const uint64_t acc =
        hk::shoup_dot_lazy<MAXND>(x, nd, smat + j * nd, smat_sh + j * nd, p);
    out[(long long)(j0 + j) * ncoef + c] = static_cast<uint32_t>(acc % p);
  }
}

template <int MAXND>
cudaError_t launch(const void* xhat, void* out, const void* mat,
                   const void* mat_sh, const void* out_q, int nd, int m_out,
                   long long ncoef, cudaStream_t st) {
  const dim3 grid((unsigned)((ncoef + kThreads - 1) / kThreads),
                  (unsigned)((m_out + kRows - 1) / kRows));
  bconv_step2_kernel<MAXND><<<grid, kThreads, 0, st>>>(
      static_cast<const uint32_t*>(xhat), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(mat), static_cast<const uint32_t*>(mat_sh),
      static_cast<const uint32_t*>(out_q), nd, m_out, ncoef);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// xhat [nd, ncoef] -> out [m_out, ncoef]; mat, mat_sh [m_out, nd]
// (row-major); out_q [m_out]. nd above 32 is refused.
int hk_bconv_step2(const void* xhat, void* out, const void* mat,
                   const void* mat_sh, const void* out_q, int nd, int m_out,
                   long long ncoef, void* stream) {
  if (nd < 1 || nd > kMaxNd || m_out < 1 || ncoef < 1 ||
      m_out > 65535 * kRows)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nd <= 16)
    return launch<16>(xhat, out, mat, mat_sh, out_q, nd, m_out, ncoef, st);
  return launch<32>(xhat, out, mat, mat_sh, out_q, nd, m_out, ncoef, st);
}

}  // extern "C"
