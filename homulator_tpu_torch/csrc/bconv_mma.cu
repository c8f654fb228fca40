// The base conversion's byte-plane product on tensor cores (kernel B17),
// for Hopper (sm_90a).
//
// Replaces: scripts/roofline.py::main._mm_kernel, the matmul of
// homulator_tpu/ops/bconv_fused.py alone (no step 1, no pairing epilogue).
// For x [nd, ncoef] uint32 (a ModUp digit's rows with a zero row
// appended, nd <= 32) and the table mbig [4*m_out, 4*nd] bf16 of
// build_bf16_tables (ops/bconv_fused.py):
//
//   planes[k*nd + t, j] = byte k of x[t, j]            (k = 0..3)
//   D = mbig @ planes            out[r, j] = D[r, j], r < m_out
//
// Rows [:m_out] are D_0, the plane-0 sums. It runs the core of
// csrc/planes_mma.cuh that B3 runs (u8 x u8 -> s32, exact: each sum is
// below 4 * nd * 255^2 < 2^23), with x entering the product as it is and
// an epilogue that stores D_0. As the TPU kernel, it computes all 4 * m_out
// rows (the core's asm is volatile, so the products of the dropped planes
// are issued). The output equals the float64 plain version bit for bit.
//
// What bounds it on the card: the bytes (x read once, D_0 written once:
// 4 * (nd + m_out) * ncoef) at set B's digit 0 (nd = 16, m_out = 35):
// 13.4 MB, 4.0 us at 3.35 TB/s, against 1.17 G u8 products (0.6 us at
// 1979 T/s).

#include <cuda_runtime.h>

#include <cstdint>

#include "planes_mma.cuh"

namespace {

using namespace hk::planes;

struct PlanesMm {
  uint32_t* out;
  int nd, m_out, g, tig;
  long long ncoef;

  __device__ void stage() const {}

  __device__ uint32_t input(int t, uint32_t x, uint32_t&) const {
    return t < nd ? x : 0u;
  }

  template <int KS>
  __device__ void count(uint32_t (&)[2][KS][4],
                        const uint32_t (&)[2][2]) const {}

  __device__ void store(int jb, const int (&d)[2][4][4], long long c0,
                        bool full) const {
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = 8 * jb + 2 * tig + jj;
      if (j >= m_out) continue;
      uint32_t* o = out + j * ncoef + c0 + g;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = 16 * mt + 8 * h;
          if (full || c0 + col + g < ncoef) o[col] = d[mt][0][2 * h + jj];
        }
    }
  }
};

template <int KS>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
planes_mm(const uint32_t* __restrict__ x, const uint16_t* __restrict__ mbig,
          uint32_t* __restrict__ out, int nd, int m_out, long long ncoef,
          int vec) {
  extern __shared__ __align__(16) uint8_t sm[];
  const Layout lay(nd, m_out, 1);
  const int lane = threadIdx.x & 31;
  PlanesMm op{out, nd, m_out, lane >> 2, lane & 3, ncoef};
  run<KS>(op, x, reinterpret_cast<const uint8_t*>(mbig), nd, ncoef, vec, sm,
          lay);
}

template <int KS>
int launch(const void* x, const void* mbig, void* out, int nd, int m_out,
           long long ncoef, void* stream) {
  const size_t smem = Layout(nd, m_out, 1).bytes();
  const cudaError_t err = allow_smem(planes_mm<KS>, smem);
  if (err != cudaSuccess) return err;
  const int vec = ncoef % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  planes_mm<KS><<<grid_blocks(ncoef, smem), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint16_t*>(mbig),
      static_cast<uint32_t*>(out), nd, m_out, ncoef, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [nd, ncoef] uint32, mbig [4*m_out, 4*nd] bf16 -> out [m_out, ncoef]:
// nd in [1, 32], m_out and ncoef positive; mbig 16-byte aligned.
int hk_bconv_planes_mm(const void* x, const void* mbig, void* out, int nd,
                       int m_out, long long ncoef, void* stream) {
  if (nd < 1 || nd > kMaxNd || m_out < 1 || ncoef < 1)
    return cudaErrorInvalidValue;
  switch ((nd + 7) / 8) {
    case 1: return launch<1>(x, mbig, out, nd, m_out, ncoef, stream);
    case 2: return launch<2>(x, mbig, out, nd, m_out, ncoef, stream);
    case 3: return launch<3>(x, mbig, out, nd, m_out, ncoef, stream);
    default: return launch<4>(x, mbig, out, nd, m_out, ncoef, stream);
  }
}

}  // extern "C"
