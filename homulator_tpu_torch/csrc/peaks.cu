// Peak-rate chains of the roofline (scripts/roofline_torch.py), for Hopper
// (sm_90a).
//
// Counterparts of the dependent loops of scripts/roofline.py:182-267,
// which XLA fuses into one loop each on the TPU: the uint32 squaring chain
// y = y*y + 12345, the Shoup chain y = y*w mod q and the Montgomery chain
// y = y*w*2^-32 mod q (S = 32 links an iteration), and the streaming pass
// z = z*2654435761 ^ x. No Pallas kernel stands behind them; in PyTorch
// eager every link would be a kernel of its own and measure device memory
// instead of the ALU, so each chain is one kernel whose thread keeps its
// element in a register for all iters * S links. One template over the
// link. The plain versions are in homulator_tpu_torch/ops/peaks.py.
//
// What bounds them: the chains by int32 operations (one multiply-add a
// squaring link, a Shoup or a Montgomery product 5, as benchlib.OPS counts
// them); the stream by bytes (two arrays read, one written).

#include <cuda_runtime.h>

#include <cstdint>

#include "modarith.cuh"

namespace {

constexpr int kS = 32;  // links an iteration, as roofline.py's S
constexpr int kThreads = 256;

struct SquareLink {
  __device__ __forceinline__ uint32_t operator()(uint32_t y) const {
    return y * y + 12345u;
  }
};

struct ShoupLink {
  uint32_t w, w_sh, q;
  __device__ __forceinline__ uint32_t operator()(uint32_t y) const {
    return hk::shoup_mul(y, w, w_sh, q);
  }
};

struct MontLink {
  uint32_t w_mont, q, qinv_neg;
  __device__ __forceinline__ uint32_t operator()(uint32_t y) const {
    return hk::csub(hk::mont_mul_lazy(y, w_mont, q, qinv_neg), q);
  }
};

template <class Link>
__global__ void __launch_bounds__(kThreads)
chain(const uint32_t* __restrict__ x, uint32_t* __restrict__ y, long long n,
      int iters, Link link) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    uint32_t v = x[i];
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int s = 0; s < kS; ++s) v = link(v);
    }
    y[i] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
stream(const uint32_t* __restrict__ z, const uint32_t* __restrict__ x,
       uint32_t* __restrict__ out, long long n4) {
  const uint4* z4 = reinterpret_cast<const uint4*>(z);
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  uint4* o4 = reinterpret_cast<uint4*>(out);
  constexpr uint32_t c = 2654435761u;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += (long long)gridDim.x * kThreads) {
    const uint4 a = z4[i], b = x4[i];
    o4[i] = make_uint4(a.x * c ^ b.x, a.y * c ^ b.y, a.z * c ^ b.z,
                       a.w * c ^ b.w);
  }
}

unsigned grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return (unsigned)(blocks < (1LL << 20) ? blocks : (1LL << 20));
}

}  // namespace

extern "C" {

// x, y [n] uint32; op 0: squaring, 1: Shoup (a, b, c = w, w_sh, q), 2:
// Montgomery (a, b, c = w * 2^32 mod q, q, -q^-1 mod 2^32).
int hk_peak_chain(const void* x, void* y, long long n, int iters, int op,
                  unsigned a, unsigned b, unsigned c, void* stream_) {
  if (n <= 0 || iters < 0 || op < 0 || op > 2) return cudaErrorInvalidValue;
  const auto* xp = static_cast<const uint32_t*>(x);
  auto* yp = static_cast<uint32_t*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream_);
  const unsigned grid = grid_for(n);
  if (op == 0) {
    chain<<<grid, kThreads, 0, st>>>(xp, yp, n, iters, SquareLink{});
  } else if (op == 1) {
    chain<<<grid, kThreads, 0, st>>>(xp, yp, n, iters, ShoupLink{a, b, c});
  } else {
    chain<<<grid, kThreads, 0, st>>>(xp, yp, n, iters, MontLink{a, b, c});
  }
  return cudaGetLastError();
}

// out = z * 2654435761 ^ x over n uint32 (n a multiple of 4; 16-byte
// aligned arrays).
int hk_peak_stream(const void* z, const void* x, void* out, long long n,
                   void* stream_) {
  if (n <= 0 || n % 4 != 0) return cudaErrorInvalidValue;
  stream<<<grid_for(n / 4), kThreads, 0,
           static_cast<cudaStream_t>(stream_)>>>(
      static_cast<const uint32_t*>(z), static_cast<const uint32_t*>(x),
      static_cast<uint32_t*>(out), n / 4);
  return cudaGetLastError();
}

}  // extern "C"
