// RNS base conversion (kernel B3) on Hopper's tensor cores (sm_90a).
//
// Replaces: homulator_tpu/ops/bconv_fused.py::bconv_fused. Per coefficient
// c of nd input limbs x_i (primes q_i) it computes
//   xh_i   = x_i * s_i mod q_i                                (step 1)
//   v      = #{i : xh_i >= (q_i >> 1) + 1}     (only when center is set)
//   out_j  = (sum_i xh_i * M[j, i] + v * M[j, nd]) mod p_j    (step 2)
// with step 2 as the TPU kernel computes it: the byte planes of xh (and of
// v, the centering row) against the table mbig of build_bf16_tables
// (homulator_tpu_torch/ops/bconv_fused.py), on the shared tensor-core core
// of csrc/planes_mma.cuh (u8 x u8 -> s32, exact). Every output is the
// canonical residue, so the result equals the plain version (bconv_plain)
// bit for bit.
//
// Epilogue, in registers, per output (j, c) from the plane sums D_0..D_3
// (each < 2^23, planes_mma.cuh):
//   lo = D_0 + 2^8 D_1,  hi = D_2 + 2^8 D_3           (< 257 * 2^23 < 2^31)
//   r  = [hi * 2^16]_lazy + [lo]_lazy                  (each in [0, 2 p_j))
//   out = r reduced from [0, 4 p_j) by two conditional subtracts.
// [hi * 2^16]_lazy is a lazy Shoup product with horner_sh = floor(2^48 /
// p_j) (build_bf16_tables), [lo]_lazy one with w = 1, whose quotient
// floor(2^32 / p_j) is horner_sh >> 16. Both are exact for any uint32
// input when 2^16 < p_j; 4 p_j < 2^32 as every prime is below 2^32 / 6
// (numtheory.PRIME_CAP). The TPU's pairing fold (conditional subtracts of
// 4q and 2q on lo, which needs q >= 2^28) has no counterpart.
//
// What bounds it on the card: bytes. A ModUp digit at N = 2^16 reads 15
// limbs and writes 35 (13.1 MB, 3.9 us at 3.35 TB/s); its int32 work
// (step 1, the count, the epilogue: ~665 operations a coefficient, 2.6 us
// at 16.75 T/s) and its u8 products (1.2 G operations, 0.6 us at 1979
// T/s) are below that. So nothing but x and the output crosses device
// memory: step 1 and the count run on each warp's staged x tile as the A
// fragments are built, the plane sums stay in registers, and each output
// word is written once.

#include <cuda_runtime.h>

#include <cstdint>

#include "modarith.cuh"
#include "planes_mma.cuh"

namespace {

using namespace hk::planes;

struct Conv {
  const uint32_t* s;
  const uint32_t* s_sh;
  const uint32_t* in_q;
  const uint32_t* hsh;
  const uint32_t* out_q;
  uint32_t* out;
  uint4* rowc;  // shared [8 ks]: s, s_sh, q, centering threshold
  uint2* outc;  // shared [8 jb]: q, horner_sh
  Layout lay;
  int nd_in, center, m_out, g, tig;
  long long ncoef;

  __device__ void stage() const {
    for (int t = threadIdx.x; t < 8 * lay.ks; t += blockDim.x) {
      // rows past nd_in: xh = 0 (s = 0), never counted
      rowc[t] = t < nd_in ? make_uint4(s[t], s_sh[t], in_q[t],
                                       (in_q[t] >> 1) + 1)
                          : make_uint4(0, 0, ~0u, ~0u);
    }
    for (int j = threadIdx.x; j < 8 * lay.jb; j += blockDim.x)
      outc[j] = j < m_out ? make_uint2(out_q[j], hsh[j]) : make_uint2(1, 0);
  }

  __device__ uint32_t input(int t, uint32_t x, uint32_t& cnt) const {
    const uint4 c = rowc[t];
    const uint32_t xh = hk::shoup_mul(x, c.x, c.y, c.z);
    cnt += xh >= c.w;
    return xh;
  }

  template <int KS>
  __device__ void count(uint32_t (&a)[2][KS][4],
                        const uint32_t (&cnt)[2][2]) const {
    if (!center) return;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t v = cnt[mt][h];  // the quad's four lanes share a column
        v += __shfl_xor_sync(0xFFFFFFFFu, v, 1);
        v += __shfl_xor_sync(0xFFFFFFFFu, v, 2);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            if (8 * ks + 4 * h2 + tig == nd_in) a[mt][ks][h + 2 * h2] = v;
      }
    }
  }

  // C fragment e of m16 tile mt: output row 8 jb + 2 tig + (e & 1),
  // column c0 + 16 mt + 8 (e >> 1) + g
  __device__ void store(int jb, const int (&d)[2][4][4], long long c0,
                        bool full) const {
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = 8 * jb + 2 * tig + jj;
      if (j >= m_out) continue;
      const uint2 oc = outc[j];
      const uint32_t q = oc.x, q2 = 2 * q, w_sh = oc.y, one_sh = oc.y >> 16;
      uint32_t* o = out + j * ncoef + c0 + g;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 2 * h + jj, col = 16 * mt + 8 * h;
          const uint32_t lo = d[mt][0][e] + ((uint32_t)d[mt][1][e] << 8);
          const uint32_t hi = d[mt][2][e] + ((uint32_t)d[mt][3][e] << 8);
          uint32_t r = (hi << 16) - __umulhi(hi, w_sh) * q;
          r += lo - __umulhi(lo, one_sh) * q;
          r = min(r, r - q2);
          if (full || c0 + col + g < ncoef) o[col] = min(r, r - q);
        }
      }
    }
  }
};

template <int KS>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
bconv_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
             const uint32_t* __restrict__ s, const uint32_t* __restrict__ s_sh,
             const uint32_t* __restrict__ in_q,
             const uint8_t* __restrict__ tab,
             const uint32_t* __restrict__ hsh,
             const uint32_t* __restrict__ out_q, int nd, int center,
             int m_out, long long ncoef, int vec) {
  extern __shared__ __align__(16) uint8_t sm[];
  const Layout lay(nd + center, m_out, 0);
  uint4* rowc = reinterpret_cast<uint4*>(sm + lay.const_offset());
  const int lane = threadIdx.x & 31;
  Conv op{s, s_sh, in_q, hsh, out_q, out, rowc,
          reinterpret_cast<uint2*>(rowc + 8 * lay.ks), lay, nd, center,
          m_out, lane >> 2, lane & 3, ncoef};
  run<KS>(op, x, tab, nd, ncoef, vec, sm, lay);
}

template <int KS>
cudaError_t launch(const void* x, void* out, const void* s, const void* s_sh,
                   const void* in_q, const void* tab, const void* hsh,
                   const void* out_q, int nd, int center, int m_out,
                   long long ncoef, cudaStream_t st) {
  const size_t smem = Layout(nd + center, m_out, 0).bytes();
  const cudaError_t err = allow_smem(bconv_kernel<KS>, smem);
  if (err != cudaSuccess) return err;
  const int vec = ncoef % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  bconv_kernel<KS><<<grid_blocks(ncoef, smem), kThreads, smem, st>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(s), static_cast<const uint32_t*>(s_sh),
      static_cast<const uint32_t*>(in_q), static_cast<const uint8_t*>(tab),
      static_cast<const uint32_t*>(hsh), static_cast<const uint32_t*>(out_q),
      nd, center, m_out, ncoef, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [nd, ncoef] -> out [m_out, ncoef]; s, s_sh, in_q [nd]; tab, the
// device layout of build_bf16_tables' mbig (ops/bconv_fused.py::mma_table,
// [32 ceil(m_out / 8), 32 ceil((nd + center) / 8) + 16] bytes, 16-byte
// aligned), and horner_sh [m_out]; out_q [m_out]; nd + center <= 32.
int hk_bconv(const void* x, void* out, const void* s, const void* s_sh,
             const void* in_q, const void* tab, const void* hsh,
             const void* out_q, int nd, int center, int m_out,
             long long ncoef, void* stream) {
  if (nd < 1 || m_out < 1 || ncoef < 1 || (center != 0 && center != 1) ||
      nd + center > kMaxNd)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((nd + center + 7) / 8) {
    case 1:
      return launch<1>(x, out, s, s_sh, in_q, tab, hsh, out_q, nd, center,
                       m_out, ncoef, st);
    case 2:
      return launch<2>(x, out, s, s_sh, in_q, tab, hsh, out_q, nd, center,
                       m_out, ncoef, st);
    case 3:
      return launch<3>(x, out, s, s_sh, in_q, tab, hsh, out_q, nd, center,
                       m_out, ncoef, st);
    default:
      return launch<4>(x, out, s, s_sh, in_q, tab, hsh, out_q, nd, center,
                       m_out, ncoef, st);
  }
}

}  // extern "C"
