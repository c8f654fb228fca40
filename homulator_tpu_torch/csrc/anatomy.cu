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
// Every other variant is one kernel template, its flags fixed at compile
// time: kPasses stage-1 CT passes along n1 (2 = the TPU's "stage 1
// twice", 16 stages at n1 = 256), kMid the Shoup product by the mid table
// after them, kT a transposed store ([n1, n2] -> [n2, n1]), Mul the
// twiddle product of the butterflies.
// A block owns an [n1, 32] column tile of one limb, as B1's first kernel
// did, with the helpers of ntt_tile.cuh: coalesced row
// loads into shared memory (row stride 33), the stage loop, and a store
// that is either row-major or transposed. The odd stride makes the
// transposed read conflict-free: the tile is eight padded 32 x 32
// transpose tiles stacked. 1024 threads a block, which halved B10-B13.
//
// Every variant keeps values in [0, q) (canonical inputs, fully reduced
// butterflies and products), so kernel and plain version agree bit for
// bit. The TPU variants leave stages1 and stages2x lazy in [0, 3q); they
// agree with these mod q.
//
// B15's forms of a * w mod q (w_sh = floor(w * 2^32 / q)):
//   production  the exact high word from __umulhi, as every kernel here;
//   natmul      the exact high word from four 16-bit partial products with
//               carries, the TPU's form (microbench_ntt2.py:36-51);
//   approx      the TPU's 3-product high word without the low partial
//               product (microbench_ntt2.py:54-66): short by at most 1, so
//               a*w - hi*q lies in [0, 3q), which uint32 holds because q <
//               2^32/6 (numtheory.py PRIME_CAP); two conditional subtracts.
// They time what each TPU workaround would cost on Hopper.
//
// What bounds them on the card: copy, transpose and mid move bytes (a limb
// read and written, the mid pair read); the stage variants are bounded by
// int32 operations, n1 * n2 / 2 * log2(n1) butterflies a limb and pass, as
// benchlib.OPS counts them. The stage loop synchronises the block after each stage.

#include <cuda_runtime.h>

#include <cstdint>

#include "ntt_tile.cuh"

namespace {

using hk::ilog2;
using hk::kLogTileCols;
using hk::min_int;

constexpr int kAnatomyThreads = 1024;

struct ShoupNatmul {
  __device__ __forceinline__ static uint32_t mul(uint32_t a, uint32_t w,
                                                 uint32_t w_sh, uint32_t q) {
    const uint32_t a0 = a & 0xFFFFu, a1 = a >> 16;
    const uint32_t b0 = w_sh & 0xFFFFu, b1 = w_sh >> 16;
    const uint32_t ll = a0 * b0, lh = a0 * b1, hl = a1 * b0, hh = a1 * b1;
    const uint32_t mid = lh + hl;
    const uint32_t carry_mid = mid < lh;
    const uint32_t lo = ll + (mid << 16);
    const uint32_t carry_lo = lo < ll;
    const uint32_t hi = hh + (mid >> 16) + (carry_mid << 16) + carry_lo;
    return hk::csub(a * w - hi * q, q);
  }
};

struct ShoupApprox {
  __device__ __forceinline__ static uint32_t mul(uint32_t a, uint32_t w,
                                                 uint32_t w_sh, uint32_t q) {
    const uint32_t a0 = a & 0xFFFFu, a1 = a >> 16;
    const uint32_t b0 = w_sh & 0xFFFFu, b1 = w_sh >> 16;
    const uint32_t lh = a0 * b1, hl = a1 * b0, hh = a1 * b1;
    const uint32_t mid = lh + hl;
    const uint32_t carry_mid = mid < lh;
    const uint32_t hi = hh + (mid >> 16) + (carry_mid << 16);
    return hk::csub(hk::csub(a * w - hi * q, q + q), q);
  }
};

// x, y [rows, n1, n2] (y [rows, n2, n1] when kT); tile [n1, TC] at column
// TC * blockIdx.y of limb blockIdx.x; tables of basis row limb % M.
template <int kPasses, bool kMid, bool kT, class Mul>
__global__ void __launch_bounds__(kAnatomyThreads)
anatomy(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
        const uint32_t* __restrict__ q, const uint32_t* __restrict__ tw1,
        const uint32_t* __restrict__ tw1_sh, const uint32_t* __restrict__ mid,
        const uint32_t* __restrict__ mid_sh, int M, int log1, int log2,
        int logtc) {
  extern __shared__ uint32_t s[];
  const int ld = (1 << logtc) + 1;
  const int limb = blockIdx.x, m = limb % M, c0 = blockIdx.y << logtc;
  const size_t len = (size_t)1 << (log1 + log2);
  const uint32_t qq = q[m];
  hk::load_tile(s, x + limb * len, log1, logtc, ld, 1 << log2, c0);
  for (int p = 0; p < kPasses; ++p)
    hk::ct_rows<Mul>(s, log1, logtc, ld, tw1 + ((size_t)m << log1),
                     tw1_sh + ((size_t)m << log1), qq);
  if constexpr (kMid)
    hk::mul_tile(s, mid + m * len, mid_sh + m * len, log1, logtc, ld,
                 1 << log2, c0, qq);
  if constexpr (kT) {
    hk::store_tile_t(s, y + limb * len, log1, logtc, ld, c0);
  } else {
    hk::store_tile(s, y + limb * len, log1, logtc, ld, 1 << log2, c0);
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
                               const uint32_t*, const uint32_t*,
                               const uint32_t*, const uint32_t*, int, int,
                               int, int);

// The instantiated variants, found by their flags (ops/anatomy.py names
// them): stage passes, mid product, transposed store, Shoup form (0
// production, 1 natmul, 2 approx).
struct Variant {
  int passes;
  bool mid, t;
  int form;
  AnatomyKernel kernel;
};
const Variant kVariants[] = {
    {0, false, true, 0, anatomy<0, false, true, hk::ShoupMul>},    // copy^T
    {0, true, false, 0, anatomy<0, true, false, hk::ShoupMul>},    // mid
    {0, true, true, 0, anatomy<0, true, true, hk::ShoupMul>},      // midT
    {1, false, false, 0, anatomy<1, false, false, hk::ShoupMul>},  // stages1
    {1, false, true, 0, anatomy<1, false, true, hk::ShoupMul>},
    {2, false, true, 0, anatomy<2, false, true, hk::ShoupMul>},  // stages2x
    {2, false, true, 1, anatomy<2, false, true, ShoupNatmul>},
    {2, false, true, 2, anatomy<2, false, true, ShoupApprox>},
};

AnatomyKernel find_variant(int passes, int mid, int t, int form) {
  for (const Variant& v : kVariants)
    if (v.passes == passes && v.mid == (mid != 0) && v.t == (t != 0) &&
        v.form == form)
      return v.kernel;
  return nullptr;
}

}  // namespace

extern "C" {

// x [rows, n1, n2] -> out [rows, n1, n2], or [rows, n2, n1] when
// transposed; the variant of flags (passes, mid, transposed, form), one of
// kVariants; tables [M, n1] (tw1, tw1_sh) and [M, n1, n2] (mid,
// mid_sh) of basis row limb % M. n1 in [2, 1024], n2 >= 2, powers of two.
int hk_ntt_anatomy(const void* x, void* out, const void* q, const void* tw1,
                   const void* tw1_sh, const void* mid, const void* mid_sh,
                   int passes, int mid_product, int transposed, int form,
                   int rows, int M, int n1, int n2, void* stream) {
  const int log1 = ilog2(n1), log2 = ilog2(n2);
  const AnatomyKernel kernel =
      find_variant(passes, mid_product, transposed, form);
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
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(tw1),
      static_cast<const uint32_t*>(tw1_sh), static_cast<const uint32_t*>(mid),
      static_cast<const uint32_t*>(mid_sh), M, log1, log2, lt);
  return cudaGetLastError();
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
