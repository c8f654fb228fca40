// Column-tile building blocks of the NTT anatomy's byte-bound variants
// (anatomy.cu: B14's copy^T and midT, B16's transpose and mid): a tile
// loaded, multiplied by a per-element table, stored row-major or
// transposed. No op's path runs them; every stage loop (every NTT kernel
// of an op, and the anatomy's stage variants) runs on ntt_reg.cuh.
//
// A block owns an [n, TC] column tile of one limb in shared memory (row
// stride ld = TC + 1: no bank conflicts in the transposed write; TC =
// min(32, row pitch)). Values stay fully reduced in [0, q).
//
// Every loop below gives thread t the tile column t % TC, and blockDim is a
// multiple of TC, so a thread keeps one column for the whole kernel:
// mul_tile reads its own column of a per-element table.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "modarith.cuh"

namespace hk {

constexpr int kLogTileCols = 5;  // TC = 32 columns: 128-byte row segments

// Load the [n, tc] tile at column c0 of a row-major [n, stride] limb.
__device__ inline void load_tile(uint32_t* s, const uint32_t* __restrict__ src,
                                 int logn, int logtc, int ld, int stride,
                                 int c0) {
  for (int t = threadIdx.x; t < (1 << (logn + logtc)); t += blockDim.x) {
    const int r = t >> logtc;
    const int c = t & ((1 << logtc) - 1);
    s[r * ld + c] = src[(size_t)r * stride + c0 + c];
  }
  __syncthreads();
}

// Store the tile back at column c0 of a row-major [n, stride] limb.
__device__ inline void store_tile(const uint32_t* s, uint32_t* __restrict__ dst,
                                  int logn, int logtc, int ld, int stride,
                                  int c0) {
  for (int t = threadIdx.x; t < (1 << (logn + logtc)); t += blockDim.x) {
    const int r = t >> logtc;
    const int c = t & ((1 << logtc) - 1);
    dst[(size_t)r * stride + c0 + c] = s[r * ld + c];
  }
}

// Store the tile transposed: tile row r, column c goes to dst[c0 + c][r] of
// a row-major [*, n] limb. Consecutive threads take consecutive r (odd
// shared-memory stride ld: no bank conflicts; coalesced global writes).
__device__ inline void store_tile_t(const uint32_t* s,
                                    uint32_t* __restrict__ dst, int logn,
                                    int logtc, int ld, int c0) {
  for (int t = threadIdx.x; t < (1 << (logn + logtc)); t += blockDim.x) {
    const int r = t & ((1 << logn) - 1);
    const int c = t >> logn;
    dst[(size_t)(c0 + c) * (1 << logn) + r] = s[r * ld + c];
  }
}

// Multiply the tile by a per-element Shoup table laid out like its source
// (row-major [n, stride], tile at column c0): coalesced table reads. The
// thread's column is fixed (see above), so w and w_sh are moved to it
// once and rows are `stride` apart.
__device__ inline void mul_tile(uint32_t* s, const uint32_t* __restrict__ w,
                                const uint32_t* __restrict__ w_sh, int logn,
                                int logtc, int ld, int stride, int c0,
                                uint32_t q) {
  const int col = c0 + (threadIdx.x & ((1 << logtc) - 1));
  w += col;
  w_sh += col;
  for (int t = threadIdx.x; t < (1 << (logn + logtc)); t += blockDim.x) {
    const int r = t >> logtc;
    const int c = t & ((1 << logtc) - 1);
    const size_t g = (size_t)r * stride;
    s[r * ld + c] = shoup_mul(s[r * ld + c], w[g], w_sh[g], q);
  }
  __syncthreads();
}

inline int min_int(int a, int b) { return a < b ? a : b; }

// Dynamic shared memory of an [1 << logn, TC] tile, raising the kernel's
// limit above the 48 KB default when needed.
template <typename K>
cudaError_t tile_smem(K kernel, int logn, int logtc, size_t* bytes) {
  *bytes = ((size_t)1 << logn) * ((1 << logtc) + 1) * sizeof(uint32_t);
  if (*bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*bytes);
}

}  // namespace hk
