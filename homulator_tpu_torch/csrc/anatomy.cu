// NTT anatomy kernels for Hopper (sm_90a): the parts of the forward 4-step
// NTT's first phase, each a kernel of its own, so that B1's time splits
// into data movement, transpose, mid-twiddle product and stage loop.
//
// Replaces: scripts/microbench_ntt.py::make_variant (B14: copy^T, midT,
// stages1, stages2x; its "full" is B1 itself, csrc/ntt.cu),
// scripts/microbench_ntt2.py::make_kernel (B15: 16 CT stages in three
// forms of the Shoup product) and scripts/bench_ntt_variants.py::main's
// kernels k_copy, k_transpose, k_mid, k_stages1 (B16). The plain versions
// are in homulator_tpu_torch/ops/anatomy.py.
//
// B16's copy is a kernel of its own (copy_words): the TPU's k_copy is a
// bare o_ref[...] = x_ref[...], and the 9.2 MB of 35 limbs stay in the
// 50 MB L2, where a copy runs at the cache's rate, above HBM's. So no
// shared memory and no loop: one 16-byte load and store a thread (the
// last n % 4 words one a thread), 256 threads a block, the grid rounded up
// to a multiple of the SM count (read from the device). On an H100 a
// grid-stride loop over 8 or 16 blocks an SM, with 1 to 8 loads in flight
// a thread, took 2-7% longer (PERF.md §6).
//
// copy^T (B14's copy, B16's transpose), mid and midT move bytes alone: one
// column-tile template, its flags fixed at compile time: kMid the Shoup
// product by the mid table, kT a transposed store ([n1, n2] -> [n2, n1]).
// A block owns an [n1, 32] column tile of one limb with the helpers of
// ntt_tile.cuh: coalesced row loads into shared memory (row stride 33),
// the product, and a store that is either row-major or transposed. The odd
// stride makes the transposed read conflict-free: the tile is eight padded
// 32 x 32 transpose tiles stacked. 1024 threads a block. Values stay in
// [0, q) (canonical inputs, fully reduced products), so kernel and plain
// version agree bit for bit.
//
// Every stage variant is one register-pass template, stages_radix<L, Mul,
// kRuns, kT>, on B1 phase A's geometry and ntt_reg.cuh's passes: a block
// per [n1, TC] tile of one limb (TC from ops/ntt_kernels.py::radix_phases'
// phase A), R = 2^ceil(L/2) values a thread, Harvey's lazy ranges, and
//   1. the strided rows loaded, the twiddle pair into shared memory
//      (barrier);
//   2. radix_ct_rows<L, Mul> (one exchange barrier): the contiguous rows
//      after all L stages, in [0, 4q);
//   3. for a second run (kRuns = 2), back to the strided rows through the
//      tile. A thread writes the words of its own contiguous rows, the very
//      words it read at the end of step 2 and that no other thread reads,
//      so only the barrier after the writes is needed; then radix_ct_rows
//      again: ct_lazy takes x in [0, 4q) and any uint32 y, so the two runs
//      chain with no reduction between them;
//   4. one reduction from [0, 4q) to [0, q), and either B1 phase A's
//      transposed store (kT: R consecutive words a thread, without the mid
//      product) or B1 phase B's row-major one (radix_phase<L, true, false>).
// Two barriers at one run, four at two. Its instantiations:
//   B14 stages1   <L, ShoupLazy, 1, true>   8 CT stages along n1 = 256
//   B16 stages1   <L, ShoupLazy, 1, false>  B1's phase B on n1's stages
//   B14 stages2x  <L, ShoupLazy, 2, true>   stage 1 twice (16 stages)
//   B15           <L, Mul, 2, true>         stages2x in each Shoup form
// B15 tells what each TPU workaround would cost in B1 as B1 is now: the
// twiddle's lazy Shoup product (modarith.cuh) in production form
// (__umulhi's exact high word, every kernel's form; B14's stages2x is this
// instantiation), natmul (the exact high word from four 16-bit partial
// products, the TPU's form, microbench_ntt2.py:36-51) or approx (the TPU's
// three partial products, short by at most 1, microbench_ntt2.py:54-66).
// The production form takes n1 up to 2^10; natmul and approx up to 2^8
// (kMaxLForms). One run keeps B1's resident blocks, two take three
// quarters of them (kStageBlocks). Every output equals the plain version
// (the stages fully reduced) bit for bit; the TPU's stage variants leave
// [0, 3q), and agree with these mod q.
//
// What bounds them on the card: copy, transpose and mid move bytes (a limb
// read and written, the mid pair read); the stage variants count their
// register passes' operations (a Harvey butterfly 9): one run as
// benchlib.radix_phase2_ops (B1's phase B) counts it, two as
// benchlib.shoup_forms_ops, one count for all three forms. One run is
// bound by its bytes (x read, the output written) by a hair, two by
// operations.

#include <cuda_runtime.h>

#include <cstdint>

#include "ntt_reg.cuh"
#include "ntt_tile.cuh"

namespace {

using hk::ilog2;
using hk::kLogTileCols;
using hk::min_int;

constexpr int kAnatomyThreads = 1024;

// x, y [rows, n1, n2] (y [rows, n2, n1] when kT); tile [n1, TC] at column
// TC * blockIdx.y of limb blockIdx.x; q and mid pair of basis row limb % M.
template <bool kMid, bool kT>
__global__ void __launch_bounds__(kAnatomyThreads)
anatomy(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
        const uint32_t* __restrict__ q, const uint32_t* __restrict__ mid,
        const uint32_t* __restrict__ mid_sh, int M, int log1, int log2,
        int logtc) {
  extern __shared__ uint32_t s[];
  const int ld = (1 << logtc) + 1;
  const int limb = blockIdx.x, m = limb % M, c0 = blockIdx.y << logtc;
  const size_t len = (size_t)1 << (log1 + log2);
  hk::load_tile(s, x + limb * len, log1, logtc, ld, 1 << log2, c0);
  if constexpr (kMid)
    hk::mul_tile(s, mid + m * len, mid_sh + m * len, log1, logtc, ld,
                 1 << log2, c0, q[m]);
  if constexpr (kT) {
    hk::store_tile_t(s, y + limb * len, log1, logtc, ld, c0);
  } else {
    hk::store_tile(s, y + limb * len, log1, logtc, ld, 1 << log2, c0);
  }
}

// natmul and approx take axes up to 2^kMaxLForms: at 2^9 and 2^10 points
// they kept their 32 values in local memory.
constexpr int kMaxLForms = 8;

// Resident blocks an SM of a stage kernel: B1's at one run (B1's phase A
// without the mid product). The second run keeps a few more values live,
// which at L = 8 (four blocks of 256 threads, 64 registers a thread)
// spilled in every form; at three quarters of B1's blocks no form spills.
template <int L, int kRuns>
constexpr int kStageBlocks =
    kRuns == 1 || hk::RadixSplit<L>::kMinBlocks < 2
        ? hk::RadixSplit<L>::kMinBlocks
        : hk::RadixSplit<L>::kMinBlocks * 3 / 4;

// The stage variants: x [rows, 2^L, ncols] -> y, [rows, ncols, 2^L] when
// kT, else x's layout; the [2^L, TC] tile at column TC * blockIdx.y of limb
// blockIdx.x (TC = 2^logtc), with the flat stage pair (tw, tw_sh [M, 2^L])
// and q of basis row limb % M; kRuns runs of the register passes in Shoup
// form Mul, the schedule of the note above. Two runs are one loop
// (unrolled, it took more registers and, at L = 9 and 10, local memory).
template <int L, class Mul, int kRuns, bool kT>
__global__ void __launch_bounds__(hk::RadixSplit<L>::kMaxThreads,
                                  kStageBlocks<L, kRuns>)
stages_radix(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
             const uint32_t* __restrict__ q, const uint32_t* __restrict__ tw,
             const uint32_t* __restrict__ tw_sh, int M, int ncols,
             int logtc) {
  using S = hk::RadixSplit<L>;
  constexpr int n = 1 << L, R = S::kR, U = S::kU;
  extern __shared__ uint32_t sm[];
  uint32_t* const tws = sm;  // stage row [n], then its Shoup row [n]
  uint32_t* const tile = sm + 2 * n;
  const int m = blockIdx.x % M;
  const int c = threadIdx.x & ((1 << logtc) - 1);
  const int u = threadIdx.x >> logtc;
  const int col = (blockIdx.y << logtc) + c;
  const size_t len = (size_t)ncols << L;
  const uint32_t* const xl = x + blockIdx.x * len;
  uint32_t* const yl = y + blockIdx.x * len;
  const uint32_t qq = q[m];
  uint32_t v[R];
#pragma unroll
  for (int t = 0; t < R; ++t)  // strided rows, values < q
    v[t] = xl[(size_t)(u + U * t) * ncols + col];
  hk::load_twiddles<L>(tws, tw + ((size_t)m << L), tw_sh + ((size_t)m << L));
#pragma unroll 1
  for (int run = 0;; ++run) {
    hk::radix_ct_rows<L, Mul>(v, tile, tws, qq, u, c, logtc);  // [0, 4q)
    if (run == kRuns - 1) break;
#pragma unroll
    for (int t = 0; t < R; ++t)  // the words this thread read last
      tile[hk::tile_at<L>(u * R + t, c, logtc)] = v[t];
    __syncthreads();
#pragma unroll
    for (int t = 0; t < R; ++t)
      v[t] = tile[hk::tile_at<L>(u + U * t, c, logtc)];
  }
#pragma unroll
  for (int t = 0; t < R; ++t) v[t] = hk::csub(hk::csub(v[t], 2 * qq), qq);
  if constexpr (kT) {
    hk::store_run<R>(yl + (size_t)col * n + u * R, v);
  } else {
#pragma unroll
    for (int t = 0; t < R; ++t) yl[(size_t)(u * R + t) * ncols + col] = v[t];
  }
}

constexpr int kCopyThreads = 256;

// y = x over 4 * n4 + tail words, x and y 16-byte aligned: thread i < n4
// copies 16-byte word i, thread n4 + j word 4 * n4 + j of the tail.
__global__ void __launch_bounds__(kCopyThreads)
copy_words(const uint32_t* __restrict__ x, uint32_t* __restrict__ y, int n4,
           int tail) {
  const int i = blockIdx.x * kCopyThreads + threadIdx.x;
  if (i < n4) {
    reinterpret_cast<uint4*>(y)[i] = reinterpret_cast<const uint4*>(x)[i];
  } else if (i - n4 < tail) {
    y[4 * (size_t)n4 + (i - n4)] = x[4 * (size_t)n4 + (i - n4)];
  }
}

using AnatomyKernel = void (*)(const uint32_t*, uint32_t*, const uint32_t*,
                               const uint32_t*, const uint32_t*, int, int,
                               int, int);

// The instantiated column-tile variants, found by their flags
// (ops/anatomy.py names them): mid product, transposed store.
struct Variant {
  bool mid, t;
  AnatomyKernel kernel;
};
const Variant kVariants[] = {
    {false, true, anatomy<false, true>},  // copy^T
    {true, false, anatomy<true, false>},  // mid
    {true, true, anatomy<true, true>},    // midT
};

AnatomyKernel find_variant(int mid, int t) {
  for (const Variant& v : kVariants)
    if (v.mid == (mid != 0) && v.t == (t != 0)) return v.kernel;
  return nullptr;
}

using StageKernel = void (*)(const uint32_t*, uint32_t*, const uint32_t*,
                             const uint32_t*, const uint32_t*, int, int, int);

// The stage kernel at axis 2^L in form 0 (production), 1 (natmul) or 2
// (approx), of `runs` runs, transposed or not; nullptr for one that is not
// instantiated (natmul and approx: two runs, transposed, L <= kMaxLForms;
// production: two runs only transposed).
template <int L>
StageKernel stage_kernel(int form, int runs, bool transposed) {
  if (form == 0) {
    if (runs == 1)
      return transposed ? &stages_radix<L, hk::ShoupLazy, 1, true>
                        : &stages_radix<L, hk::ShoupLazy, 1, false>;
    return runs == 2 && transposed ? &stages_radix<L, hk::ShoupLazy, 2, true>
                                   : nullptr;
  }
  if constexpr (L <= kMaxLForms) {
    if (runs == 2 && transposed)
      return form == 1   ? &stages_radix<L, hk::ShoupNatmul, 2, true>
             : form == 2 ? &stages_radix<L, hk::ShoupApprox, 2, true>
                         : nullptr;
  }
  return nullptr;
}

}  // namespace

extern "C" {

// copy^T, mid, midT: x [rows, n1, n2] -> out [rows, n1, n2], or [rows,
// n2, n1] when transposed; the variant of flags (mid, transposed), one of
// kVariants; mid tables [M, n1, n2] (mid, mid_sh) of basis row limb % M.
// n1 in [2, 1024], n2 >= 2, powers of two.
int hk_ntt_anatomy(const void* x, void* out, const void* q, const void* mid,
                   const void* mid_sh, int mid_product, int transposed,
                   int rows, int M, int n1, int n2, void* stream) {
  const int log1 = ilog2(n1), log2 = ilog2(n2);
  const AnatomyKernel kernel = find_variant(mid_product, transposed);
  if (kernel == nullptr || rows <= 0 || M <= 0 || rows % M != 0 ||
      log1 < 1 || log1 > 10 || log2 < 1)
    return cudaErrorInvalidValue;
  const int lt = min_int(kLogTileCols, log2);
  size_t smem;
  cudaError_t err;
  if ((err = hk::tile_smem(kernel, log1, lt, &smem)) != cudaSuccess)
    return err;
  kernel<<<dim3(rows, n2 >> lt), kAnatomyThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(mid),
      static_cast<const uint32_t*>(mid_sh), M, log1, log2, lt);
  return cudaGetLastError();
}

// The stage variants (B14's stages1 and stages2x, B15, B16's stages1): x
// [rows, n1, n2] -> out [rows, n2, n1] when transposed, else [rows, n1,
// n2]; `runs` runs of the CT stages along n1 in Shoup form `form` (0
// production, 1 natmul, 2 approx), tiles of 2^logtc columns
// (ops/ntt_kernels.py::radix_phases' phase A); tw1, tw1_sh [M, n1] of basis
// row limb % M. Instantiated: production at 1 run either way and 2 runs
// transposed, n1 in [2, 1024]; natmul and approx at 2 runs transposed, n1
// in [2, 256]. n2 >= 2^logtc, powers of two.
int hk_ntt_stages(const void* x, void* out, const void* q, const void* tw1,
                  const void* tw1_sh, int form, int runs, int transposed,
                  int rows, int M, int n1, int n2, int logtc, void* stream) {
  const int log2 = ilog2(n2);
  if (rows <= 0 || M <= 0 || rows % M != 0 || log2 < 1 || log2 > 24)
    return cudaErrorInvalidValue;
  return hk::with_log(ilog2(n1), [&](auto l) {
    constexpr int L = decltype(l)::value;
    const StageKernel kernel = stage_kernel<L>(form, runs, transposed != 0);
    if (kernel == nullptr) return (int)cudaErrorInvalidValue;
    int threads;
    size_t smem;
    const cudaError_t err =
        hk::radix_block<L>(kernel, log2, logtc, &threads, &smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(rows, 1 << (log2 - logtc)), threads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
        static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(tw1),
        static_cast<const uint32_t*>(tw1_sh), M, n2, logtc);
    return (int)cudaGetLastError();
  });
}

// B16's copy: y = x over n < 2^32 words (x, y 16-byte aligned).
int hk_copy_words(const void* x, void* y, long long n, void* stream) {
  int dev, sms;
  cudaError_t err;
  if (n < 0 || n >= (1LL << 32) || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const int n4 = (int)(n >> 2), tail = (int)(n & 3);
  const int blocks = (n4 + tail + kCopyThreads - 1) / kCopyThreads;
  copy_words<<<(blocks + sms - 1) / sms * sms, kCopyThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y), n4, tail);
  return cudaGetLastError();
}

}  // extern "C"
