// RNS base conversion (kernel B3) for Hopper (sm_90a).
//
// Replaces: homulator_tpu/ops/bconv_fused.py::bconv_fused. Per coefficient
// c of nd input limbs x_i (primes q_i) it computes
//   xh_i   = x_i * s_i mod q_i                                (step 1)
//   v      = #{i : xh_i >= (q_i >> 1) + 1}     (only when center is set)
//   out_j  = (sum_i xh_i * M[j, i] + v * M[j, nd]) mod p_j    (step 2)
// which is what the TPU kernel's bf16-plane matmul and pairing epilogue
// compute; every output is the same canonical residue, so the result
// equals the plain version (homulator_tpu_torch/ops/bconv_fused.py) bit
// for bit.
//
// What bounds it on the card: integer instruction throughput, not memory.
// A ModUp digit at N = 2^16 reads 15 limbs and writes 35 (12.5 MiB), but
// does 16 * 35 multiply-accumulates and 35 64-bit reductions per
// coefficient.
//
// Design: one thread per coefficient keeps its xh_i in registers (the
// kernel is instantiated for nd <= 16 and nd <= 32 so the unrolled arrays
// stay in registers; the widest call of parameter set B, the key-switch
// tail, has nd = 18) and loops over the output rows; loads and stores are
// coalesced along the coefficient axis. The matrix M and its Shoup
// quotients (at most ~2 x 45 x 19 words on the main path) and the output
// primes sit in shared memory, read as broadcasts. Each product is reduced
// lazily to [0, 2 p_j) by Shoup's method and summed in uint64, which no
// register-resident input count can overflow: the TPU kernel's nd <= 32
// bound (a bf16 / f32 exactness rule) is not what limits nd here. The
// tensor-core (bf16-plane, wgmma) form is left to later work.

#include <cuda_runtime.h>

#include <cstdint>

#include "modarith.cuh"

namespace {

using hk::shoup_mul;
using hk::shoup_mul_lazy;

constexpr int kThreads = 256;

template <int MAXND>
__global__ void __launch_bounds__(kThreads)
bconv_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
             const uint32_t* __restrict__ s, const uint32_t* __restrict__ s_sh,
             const uint32_t* __restrict__ in_q,
             const uint32_t* __restrict__ mat,
             const uint32_t* __restrict__ mat_sh,
             const uint32_t* __restrict__ out_q, int nd, int center,
             int m_out, long long ncoef) {
  extern __shared__ uint32_t sm[];
  const int ndt = nd + center;
  uint32_t* smat = sm;
  uint32_t* smat_sh = sm + m_out * ndt;
  uint32_t* sq = smat_sh + m_out * ndt;
  for (int t = threadIdx.x; t < m_out * ndt; t += blockDim.x) {
    smat[t] = mat[t];
    smat_sh[t] = mat_sh[t];
  }
  for (int t = threadIdx.x; t < m_out; t += blockDim.x) sq[t] = out_q[t];
  __syncthreads();

  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ncoef) return;
  uint32_t xh[MAXND];
  uint32_t v = 0;
#pragma unroll
  for (int i = 0; i < MAXND; ++i) {
    xh[i] = 0;
    if (i < nd) {
      const uint32_t qi = in_q[i];
      xh[i] = shoup_mul(x[i * ncoef + c], s[i], s_sh[i], qi);
      v += xh[i] >= (qi >> 1) + 1;
    }
  }
  for (int j = 0; j < m_out; ++j) {
    const uint32_t p = sq[j];
    const uint32_t* mj = smat + j * ndt;
    const uint32_t* mjs = smat_sh + j * ndt;
    uint64_t acc = hk::shoup_dot_lazy<MAXND>(xh, nd, mj, mjs, p);
    if (center) acc += shoup_mul_lazy(v, mj[nd], mjs[nd], p);
    out[j * ncoef + c] = static_cast<uint32_t>(acc % p);
  }
}

template <int MAXND>
cudaError_t launch(const void* x, void* out, const void* s, const void* s_sh,
                   const void* in_q, const void* mat, const void* mat_sh,
                   const void* out_q, int nd, int center, int m_out,
                   long long ncoef, cudaStream_t st) {
  const size_t smem = (size_t)(2 * m_out * (nd + center) + m_out) *
                      sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bconv_kernel<MAXND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (ncoef + kThreads - 1) / kThreads;
  bconv_kernel<MAXND><<<(unsigned)blocks, kThreads, smem, st>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(s), static_cast<const uint32_t*>(s_sh),
      static_cast<const uint32_t*>(in_q), static_cast<const uint32_t*>(mat),
      static_cast<const uint32_t*>(mat_sh),
      static_cast<const uint32_t*>(out_q), nd, center, m_out, ncoef);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [nd, ncoef] -> out [m_out, ncoef]; s, s_sh, in_q [nd]; mat, mat_sh
// [m_out, nd + center] (row-major); out_q [m_out].
int hk_bconv(const void* x, void* out, const void* s, const void* s_sh,
             const void* in_q, const void* mat, const void* mat_sh,
             const void* out_q, int nd, int center, int m_out,
             long long ncoef, void* stream) {
  if (nd < 1 || m_out < 1 || ncoef < 1 || (center != 0 && center != 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nd <= 16)
    return launch<16>(x, out, s, s_sh, in_q, mat, mat_sh, out_q, nd, center,
                      m_out, ncoef, st);
  if (nd <= 32)
    return launch<32>(x, out, s, s_sh, in_q, mat, mat_sh, out_q, nd, center,
                      m_out, ncoef, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
