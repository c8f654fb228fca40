// Register-resident radix passes of the NTT kernels B1 and B2 (ntt.cu),
// written as helpers so that other NTT phases run on them: B4's two
// launches (hpip.cu) and the phases of the coefficient-sharded NTT in
// ntt.cu: forward phase 1 (B6, B10: radix_phase1) and phase 2 (B7, B11:
// B1's phase B, radix_phase<L, true, false>), and the inverse phase 2
// (B8, B12: B2's phase A, radix_phase<L, false, false>) and phase 1 (B9,
// B13: radix_iphase1); and, on no op's path, the anatomy's stage variants
// (B14's and B16's stages1, B14's stages2x and B15's Shoup forms,
// anatomy.cu::stages_radix: radix_ct_rows once or twice, in each form of
// the product).
//
// One phase transforms an [n, ncols] limb along its n = 2^L rows, one
// column at a time; a block holds TC columns. Each transform splits its
// index bits in two (RadixSplit): the top LA = ceil(L/2) bits and the low
// LB = floor(L/2) bits. A column has U = 2^LB threads. In the strided pass
// thread u holds the R = 2^LA rows u + U*t (t < R), which the CT stages 0
// .. LA-1 (GS stages LA-1 .. 0) pair with one another; in the contiguous
// pass it holds the R rows u*R + t, SUB = R / 2^LB units of 2^LB rows each,
// which the CT stages LA .. L-1 (GS stages L-1 .. LA) pair. Each pass runs
// all its stages in registers; the tile goes through shared memory once
// between the two, where a thread gives up one row set for the other: one
// barrier. The twiddle table of the limb (the flat stage row and its Shoup
// row, 2n words) is loaded into shared memory once a block: the other
// barrier of a phase.
//
// Thread t of a block takes column c = t % TC and row-set index u = t / TC,
// so a warp reads and writes TC consecutive columns of each of 32/TC rows of
// the tile. The tile keeps element (i, c) at
// ((i + (i >> LA)) * TC + c): one pad row after every R rows, so that both
// row sets of a warp fall on distinct banks.
//
// Lazy ranges (Harvey): every prime is below PRIME_CAP = 2^32/6
// (homulator_tpu_torch/numtheory.py:49), so 4q < 2^32. A CT butterfly takes
// and gives values in [0, 4q); a GS butterfly takes and gives [0, 2q). The
// kernels reduce to [0, q) once, before they store.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "modarith.cuh"

namespace hk {

template <int L>
struct RadixSplit {
  static_assert(L >= 1 && L <= 10, "axis of 2 to 1024 points");
  static constexpr int kLA = (L + 1) / 2;  // bits of the strided pass
  static constexpr int kLB = L / 2;        // bits of a contiguous unit
  static constexpr int kR = 1 << kLA;      // rows a thread holds
  static constexpr int kU = 1 << kLB;      // threads a column
  static constexpr int kSub = kR >> kLB;   // contiguous units a thread: 1, 2
  // Tiles of at most 16 columns: 256 threads a block at L = 8, four blocks
  // an SM, beat 512-thread blocks of 32 columns by 15-19% on an H100 at
  // set B (PERF.md §6). At R <= 16 values a thread, at most 64 registers
  // (1024 threads an SM stay resident; a cap of 40 spills); the 32 values
  // of L = 9, 10 get up to 255, which keeps them out of local memory.
  static constexpr int kMaxTileCols = 16;
  static constexpr int kMaxThreads = kMaxTileCols << kLB;
  static constexpr int kMinBlocks =
      kR >= 32 ? 1 : (1024 / kMaxThreads < 32 ? 1024 / kMaxThreads : 32);
};

// Harvey CT butterfly (x, y) -> (x + w*y, x - w*y) mod q. In: x in [0, 4q),
// y any uint32. Out: both in [0, 4q). Mul: the form of the lazy Shoup
// product (modarith.cuh), in [0, 2q) for any uint32 y.
template <class Mul = ShoupLazy>
__device__ __forceinline__ void ct_lazy(uint32_t& x, uint32_t& y, uint32_t w,
                                        uint32_t w_sh, uint32_t q,
                                        uint32_t q2) {
  const uint32_t a = csub(x, q2);                      // [0, 2q)
  const uint32_t t = Mul::mul(y, w, w_sh, q);          // [0, 2q)
  x = a + t;                                           // [0, 4q)
  y = a - t + q2;                                      // (0, 4q)
}

// Harvey GS butterfly (x, y) -> (x + y, (x - y)*w) mod q. In and out: [0, 2q).
__device__ __forceinline__ void gs_lazy(uint32_t& x, uint32_t& y, uint32_t w,
                                        uint32_t w_sh, uint32_t q,
                                        uint32_t q2) {
  const uint32_t d = x - y + q2;                       // (0, 4q)
  x = csub(x + y, q2);                                 // [0, 4q) -> [0, 2q)
  y = shoup_mul_lazy(d, w, w_sh, q);                   // [0, 2q)
}

// The CT stages of one register pass over the 2^LR values v[off ..
// off + 2^LR): global stages s0 .. s0 + LR - 1 of a unit whose index bits
// above the pass are g. Local stage s pairs v[j] and v[j + 2^(LR-1-s)];
// block b of it takes the flat twiddle 2^(s0+s) + (g << s) + b. tw holds
// the stage row [n], tw + n its Shoup row; Mul as ct_lazy's.
template <int LR, class Mul = ShoupLazy, int N>
__device__ __forceinline__ void ct_pass(uint32_t (&v)[N], int off,
                                        const uint32_t* tw, int n, int s0,
                                        int g, uint32_t q) {
  const uint32_t q2 = 2 * q;
#pragma unroll
  for (int s = 0; s < LR; ++s) {
    const int h = 1 << (LR - 1 - s);
#pragma unroll
    for (int b = 0; b < (1 << s); ++b) {
      const int k = (1 << (s0 + s)) + (g << s) + b;
      const uint32_t w = tw[k], w_sh = tw[n + k];
#pragma unroll
      for (int j = 0; j < h; ++j)
        ct_lazy<Mul>(v[off + 2 * b * h + j], v[off + 2 * b * h + j + h], w,
                     w_sh, q, q2);
    }
  }
}

// The GS stages of one register pass, in reverse order (s0 + LR - 1 down to
// s0), same pairs and twiddle indices as ct_pass.
template <int LR, int N>
__device__ __forceinline__ void gs_pass(uint32_t (&v)[N], int off,
                                        const uint32_t* tw, int n, int s0,
                                        int g, uint32_t q) {
  const uint32_t q2 = 2 * q;
#pragma unroll
  for (int s = LR - 1; s >= 0; --s) {
    const int h = 1 << (LR - 1 - s);
#pragma unroll
    for (int b = 0; b < (1 << s); ++b) {
      const int k = (1 << (s0 + s)) + (g << s) + b;
      const uint32_t w = tw[k], w_sh = tw[n + k];
#pragma unroll
      for (int j = 0; j < h; ++j)
        gs_lazy(v[off + 2 * b * h + j], v[off + 2 * b * h + j + h], w, w_sh,
                q, q2);
    }
  }
}

// Shared-memory word of tile element (row i, column c): one pad row after
// every 2^LA rows.
template <int L>
__device__ __forceinline__ int tile_at(int i, int c, int logtc) {
  return ((i + (i >> RadixSplit<L>::kLA)) << logtc) + c;
}

// Words of shared memory a phase block takes: the twiddle pair and the tile.
template <int L>
__host__ __device__ constexpr size_t radix_smem_words(int tc) {
  return 2 * ((size_t)1 << L) +
         (((size_t)1 << L) + RadixSplit<L>::kU) * (size_t)tc;
}

// R consecutive words from / to 16-byte aligned global memory (R >= 4) or
// word by word.
template <int R>
__device__ __forceinline__ void load_run(uint32_t (&v)[R],
                                         const uint32_t* __restrict__ p) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int j = 0; j < R / 4; ++j) {
      const uint4 w = reinterpret_cast<const uint4*>(p)[j];
      v[4 * j] = w.x, v[4 * j + 1] = w.y, v[4 * j + 2] = w.z,
      v[4 * j + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int t = 0; t < R; ++t) v[t] = p[t];
  }
}

template <int R>
__device__ __forceinline__ void store_run(uint32_t* __restrict__ p,
                                          const uint32_t (&v)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int j = 0; j < R / 4; ++j)
      reinterpret_cast<uint4*>(p)[j] =
          make_uint4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  } else {
#pragma unroll
    for (int t = 0; t < R; ++t) p[t] = v[t];
  }
}

// The CT stages of one 2^L-point column c of a tile, all in registers but
// for one exchange: v holds the strided rows u + U*t (t < R) of the
// column, each in [0, 4q), and leaves holding its contiguous rows u*R + t
// after all L stages, in [0, 4q). The exchange goes through tile (a
// tile_at layout) and takes one barrier; tws is the stage row and its
// Shoup row in shared memory. The tile may be written again once every
// thread of the block has passed another barrier. B1's phase B stores the
// values; B4's phase B (hpip.cu) multiplies them by its keys, B6 and B10
// (radix_phase1) by the mid table; the anatomy's stage kernels
// (anatomy.cu::stages_radix) run it once, or twice in each form of the
// twiddle product (Mul, as ct_lazy's).
template <int L, class Mul = ShoupLazy>
__device__ __forceinline__ void radix_ct_rows(
    uint32_t (&v)[RadixSplit<L>::kR], uint32_t* tile, const uint32_t* tws,
    uint32_t q, int u, int c, int logtc) {
  using S = RadixSplit<L>;
  constexpr int n = 1 << L, R = S::kR, U = S::kU, LA = S::kLA, LB = S::kLB;
  ct_pass<LA, Mul>(v, 0, tws, n, 0, 0, q);
#pragma unroll
  for (int t = 0; t < R; ++t) tile[tile_at<L>(u + U * t, c, logtc)] = v[t];
  __syncthreads();
#pragma unroll
  for (int t = 0; t < R; ++t) v[t] = tile[tile_at<L>(u * R + t, c, logtc)];
#pragma unroll
  for (int k = 0; k < S::kSub; ++k)
    ct_pass<LB, Mul>(v, k << LB, tws, n, LA, u * S::kSub + k, q);
}

// The GS stages of one 2^L-point column c of a tile, radix_ct_rows's
// mirror image: v holds the contiguous rows u*R + t (t < R) of the column,
// each in [0, 2q), and leaves holding its strided rows u + U*t after all L
// stages, in [0, 2q): the contiguous pass(es), the exchange through tile
// (one barrier), then the strided pass. B2's phases (radix_phase) and B12
// store the values; B13 (radix_iphase1) multiplies them by mid_inv first.
template <int L>
__device__ __forceinline__ void radix_gs_rows(
    uint32_t (&v)[RadixSplit<L>::kR], uint32_t* tile, const uint32_t* tws,
    uint32_t q, int u, int c, int logtc) {
  using S = RadixSplit<L>;
  constexpr int n = 1 << L, R = S::kR, U = S::kU, LA = S::kLA, LB = S::kLB;
#pragma unroll
  for (int k = 0; k < S::kSub; ++k)
    gs_pass<LB>(v, k << LB, tws, n, LA, u * S::kSub + k, q);  // [0, 2q)
#pragma unroll
  for (int t = 0; t < R; ++t) tile[tile_at<L>(u * R + t, c, logtc)] = v[t];
  __syncthreads();
#pragma unroll
  for (int t = 0; t < R; ++t) v[t] = tile[tile_at<L>(u + U * t, c, logtc)];
  gs_pass<LA>(v, 0, tws, n, 0, 0, q);  // [0, 2q)
}

// The limb's stage row and its Shoup row (n = 2^L words each) into shared
// memory, then the block's first barrier.
template <int L>
__device__ __forceinline__ void load_twiddles(
    uint32_t* tws, const uint32_t* __restrict__ tw,
    const uint32_t* __restrict__ tw_sh) {
  constexpr int n = 1 << L;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    tws[k] = tw[k];
    tws[n + k] = tw_sh[k];
  }
  __syncthreads();
}

// One phase of B1 or B2 on the [n, TC] tile at column c0 of one limb x
// [n, ncols] (n = 2^L), with the limb's q, stage twiddle pair (tw, tw_sh
// rows of n) and, for kT, mid pair (rows of the limb's [n, ncols] table).
//   kFwd, !kT  CT along the rows; y [n, ncols] like x          (B1 phase B;
//              B7, B11: the tile at lane c0 of a shard's group)
//   kFwd, kT   CT, times mid, y transposed [ncols, n]          (B1 phase A)
//   !kFwd, !kT GS along the rows; y [n, ncols] like x          (B2 phase A;
//              B12: the tile at lane c0 of a shard's group)
//   !kFwd, kT  x transposed [ncols, n]: times mid, GS; y
//              [n, ncols]                                      (B2 phase B)
// CT runs the strided pass, then the contiguous one; GS the other way
// round. The transposed side is the contiguous row set: 2^LA consecutive
// words a thread. Every store is in [0, q).
template <int L, bool kFwd, bool kT>
__device__ __forceinline__ void radix_phase(
    const uint32_t* __restrict__ x, uint32_t* __restrict__ y, uint32_t q,
    const uint32_t* __restrict__ tw, const uint32_t* __restrict__ tw_sh,
    const uint32_t* __restrict__ mid, const uint32_t* __restrict__ mid_sh,
    int ncols, int logtc, int c0) {
  using S = RadixSplit<L>;
  constexpr int n = 1 << L, R = S::kR, U = S::kU;
  extern __shared__ uint32_t sm[];
  uint32_t* const tws = sm;  // stage row [n], then its Shoup row [n]
  uint32_t* const tile = sm + 2 * n;
  const int c = threadIdx.x & ((1 << logtc) - 1);
  const int u = threadIdx.x >> logtc;
  const int col = c0 + c;
  uint32_t v[R];

  // loads in flight while the block fills the twiddle table
  if constexpr (kFwd) {  // strided rows, values < q
#pragma unroll
    for (int t = 0; t < R; ++t) v[t] = x[(size_t)(u + U * t) * ncols + col];
  } else if constexpr (!kT) {  // contiguous rows, values < q
#pragma unroll
    for (int t = 0; t < R; ++t) v[t] = x[(size_t)(u * R + t) * ncols + col];
  } else {  // a run of the transposed input, times mid: [0, 2q)
    load_run<R>(v, x + (size_t)col * n + u * R);
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const size_t g = (size_t)(u * R + t) * ncols + col;
      v[t] = shoup_mul_lazy(v[t], mid[g], mid_sh[g], q);
    }
  }
  load_twiddles<L>(tws, tw, tw_sh);

  if constexpr (kFwd) {
    radix_ct_rows<L>(v, tile, tws, q, u, c, logtc);  // [0, 4q)
    if constexpr (kT) {
#pragma unroll
      for (int t = 0; t < R; ++t) {  // any uint32 times mid: [0, 2q)
        const size_t g = (size_t)(u * R + t) * ncols + col;
        v[t] = csub(shoup_mul_lazy(v[t], mid[g], mid_sh[g], q), q);
      }
      store_run<R>(y + (size_t)col * n + u * R, v);
    } else {
#pragma unroll
      for (int t = 0; t < R; ++t)
        y[(size_t)(u * R + t) * ncols + col] = csub(csub(v[t], 2 * q), q);
    }
  } else {
    radix_gs_rows<L>(v, tile, tws, q, u, c, logtc);  // [0, 2q)
#pragma unroll
    for (int t = 0; t < R; ++t)
      y[(size_t)(u + U * t) * ncols + col] = csub(v[t], q);
  }
}

// Forward phase 1 of the coefficient-sharded NTT (B6, B10) on the [n, TC]
// tile at column c0 of one limb x (n = 2^L rows, `pitch` words apart): CT
// along the rows (radix_ct_rows), then, at the contiguous rows each thread
// holds, times the limb's mid table, reduced to [0, q) (B1 phase A's
// epilogue); y is stored in x's layout, since on a shard the exchange
// does the transpose. The mid table's rows are `mpitch` words apart, and
// tile column c reads its column mc0 + c: on the lane-packed layout x
// holds k limbs side by side (pitch k*c) while each limb's mid slice is
// [n, c] (pitch c). Two barriers, as radix_phase's.
template <int L>
__device__ __forceinline__ void radix_phase1(
    const uint32_t* __restrict__ x, uint32_t* __restrict__ y, uint32_t q,
    const uint32_t* __restrict__ tw, const uint32_t* __restrict__ tw_sh,
    const uint32_t* __restrict__ mid, const uint32_t* __restrict__ mid_sh,
    int pitch, int mpitch, int logtc, int c0, int mc0) {
  using S = RadixSplit<L>;
  constexpr int n = 1 << L, R = S::kR, U = S::kU;
  extern __shared__ uint32_t sm[];
  uint32_t* const tws = sm;  // stage row [n], then its Shoup row [n]
  uint32_t* const tile = sm + 2 * n;
  const int c = threadIdx.x & ((1 << logtc) - 1);
  const int u = threadIdx.x >> logtc;
  uint32_t v[R];
#pragma unroll
  for (int t = 0; t < R; ++t)  // strided rows, values < q
    v[t] = x[(size_t)(u + U * t) * pitch + c0 + c];
  load_twiddles<L>(tws, tw, tw_sh);
  radix_ct_rows<L>(v, tile, tws, q, u, c, logtc);  // [0, 4q)
#pragma unroll
  for (int t = 0; t < R; ++t) {  // any uint32 times mid: [0, 2q)
    const int i = u * R + t;
    const size_t g = (size_t)i * mpitch + mc0 + c;
    y[(size_t)i * pitch + c0 + c] =
        csub(shoup_mul_lazy(v[t], mid[g], mid_sh[g], q), q);
  }
}

// Inverse phase 1 of the coefficient-sharded NTT (B13) on the [n, TC] tile
// at column c0 of one limb x (n = 2^L rows, `pitch` words apart),
// radix_phase1's mirror image: at the contiguous rows each thread holds,
// times the limb's mid_inv table (rows `mpitch` words apart, tile column c
// at column mc0 + c, as radix_phase1 reads mid), then GS along the rows
// (radix_gs_rows), reduced to [0, q) and stored in x's layout at the
// strided rows. Two barriers, as radix_phase's.
template <int L>
__device__ __forceinline__ void radix_iphase1(
    const uint32_t* __restrict__ x, uint32_t* __restrict__ y, uint32_t q,
    const uint32_t* __restrict__ tw, const uint32_t* __restrict__ tw_sh,
    const uint32_t* __restrict__ mid, const uint32_t* __restrict__ mid_sh,
    int pitch, int mpitch, int logtc, int c0, int mc0) {
  using S = RadixSplit<L>;
  constexpr int n = 1 << L, R = S::kR, U = S::kU;
  extern __shared__ uint32_t sm[];
  uint32_t* const tws = sm;  // stage row [n], then its Shoup row [n]
  uint32_t* const tile = sm + 2 * n;
  const int c = threadIdx.x & ((1 << logtc) - 1);
  const int u = threadIdx.x >> logtc;
  uint32_t v[R];
#pragma unroll
  for (int t = 0; t < R; ++t) {  // values < q times mid_inv: [0, 2q)
    const int i = u * R + t;
    const size_t g = (size_t)i * mpitch + mc0 + c;
    v[t] = shoup_mul_lazy(x[(size_t)i * pitch + c0 + c], mid[g], mid_sh[g],
                          q);
  }
  load_twiddles<L>(tws, tw, tw_sh);
  radix_gs_rows<L>(v, tile, tws, q, u, c, logtc);  // [0, 2q)
#pragma unroll
  for (int t = 0; t < R; ++t)
    y[(size_t)(u + U * t) * pitch + c0 + c] = csub(v[t], q);
}

// The block of a radix phase kernel at axis 2^L and TC = 2^logtc of
// 2^logcols columns: TC * 2^LB threads and radix_smem_words<L>(TC) words
// of dynamic shared memory, the kernel's limit raised above the 48 KB
// default when needed. cudaErrorInvalidValue for a TC it does not take
// (above the columns or RadixSplit's kMaxTileCols).
template <int L, class Kernel>
cudaError_t radix_block(Kernel kernel, int logcols, int logtc, int* threads,
                        size_t* smem) {
  if (logtc < 0 || logtc > logcols ||
      (1 << logtc) > RadixSplit<L>::kMaxTileCols)
    return cudaErrorInvalidValue;
  *threads = (1 << logtc) << RadixSplit<L>::kLB;
  *smem = radix_smem_words<L>(1 << logtc) * sizeof(uint32_t);
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

// f(std::integral_constant<int, L>()) for the runtime logn = L in [1,
// kMaxL]: the host's dispatch to a kernel's instantiation for an axis
// length.
template <int kMaxL = 10, int L = 1, class F>
int with_log(int logn, F&& f) {
  if constexpr (L > kMaxL) {
    return cudaErrorInvalidValue;
  } else {
    if (logn == L) return f(std::integral_constant<int, L>());
    return with_log<kMaxL, L + 1>(logn, f);
  }
}

}  // namespace hk
