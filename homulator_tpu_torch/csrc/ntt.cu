// Negacyclic 4-step NTT (kernel B1) and its inverse (kernel B2) over RNS
// limbs, and the phase kernels of the coefficient-sharded transform, per
// limb (B6-B9) and lane-packed (B10-B13), for Hopper (sm_90a).
//
// Replaces: homulator_tpu/ops/ntt_pallas.py::ntt_pallas (B1),
// ::intt_pallas (B2), ::ntt_phase1_pallas (B6), ::ntt_phase2_pallas (B7),
// ::intt_phase2_pallas (B8), ::intt_phase1_pallas (B9) and their packed
// forms ::ntt_phase1_packed_pallas (B10), ::ntt_phase2_packed_pallas (B11),
// ::intt_phase2_packed_pallas (B12), ::intt_phase1_packed_pallas (B13).
// Same network and tables as the plain versions
// (homulator_tpu_torch/ops/ntt.py), so the outputs are the same canonical
// residues bit for bit.
//
// What bounds B1 and B2 on the card: a whole N = 2^16 limb is 256 KiB of
// uint32, more than the 227 KB of shared memory a block can hold, so the
// TPU design (one limb in VMEM, all stages on chip) does not carry over.
// Each transform is two launches (the phase-split template of
// ntt_pallas.py:274-407) through a scratch array, and each phase reads and
// writes the limb once; the phase with the mid product also reads its value
// and Shoup tables. That is about 1.5 MiB of device memory traffic a limb
// at N = 2^16 against some 9 integer instructions for each of the N/2 *
// log2(N) lazy butterflies, of the same order on an H100; the first version
// (a block synchronising after each of the 8 shared-memory stages of an
// axis, 256 threads, values reduced after every butterfly) ran at 13-21%
// of that bound. B1 and B2 therefore run on ntt_reg.cuh's register passes:
//   - a 2^L-point axis is two register passes (16 x 16 at L = 8), one
//     exchange through shared memory between them, and the twiddle pair
//     loaded into shared memory once a block: two barriers a phase;
//   - Harvey's lazy butterflies, one reduction to [0, q) before each store;
//   - the columns a block holds (TC) come from the host
//     (ops/ntt_kernels.py::radix_phases), so that a few limbs still give
//     the card enough blocks; TC * 2^floor(L/2) threads a block.
// Both global streams of a phase are coalesced: a warp moves TC consecutive
// columns of each of 32/TC rows, and the transposed side (B1 phase A's
// store, B2 phase B's load, where mid_inv is applied) moves 2^ceil(L/2)
// consecutive words a thread. Forward, [rows, n1, n2] coeff -> [rows, n2,
// n1] eval tiles:
//   phase A  ntt_fwd_radix_a<log n1>, grid (rows, n2/TC): CT along n1,
//            times mid, written transposed into scratch [rows, n2, n1]
//   phase B  ntt_fwd_radix_b<log n2>, grid (rows, n1/TC): CT along n2
// Inverse, [rows, n2, n1] -> [rows, n1, n2]:
//   phase A  ntt_inv_radix_a<log n2>, grid (rows, n1/TC): GS along n2,
//            scratch [rows, n2, n1] in the input's layout
//   phase B  ntt_inv_radix_b<log n1>, grid (rows, n2/TC): reads scratch
//            transposed, times mid_inv (carries 1/N), GS along n1
//
// On a coefficient shard the transpose is the all_to_all between the two
// halves (ops/ntt.py), so each half is its own entry point on a column
// slice of c = n/ns columns, output in its input's layout:
//   B6 ntt_phase1_radix  [rows, n1, c] -> [rows, n1, c]
//   B7 ntt_phase2_radix  [rows, n2, c] -> [rows, n2, c]
//   B8 ntt_iphase2_radix [rows, n2, c] -> [rows, n2, c]
//   B9 ntt_iphase1_radix [rows, n1, c] -> [rows, n1, c]
// B6 and B9 take the shard's mid / mid_inv tables as their own contiguous
// [M, n1, c] column slice (DeviceContext builds one per rank), indexed like
// the data. Table rows are limb % M, so rep stacked copies share one
// basis's tables.
//
// B10-B13 are B6-B9 on the JAX package's lane-packed layout [rows, n, k*c]
// (k = 128/c limbs side by side, rows padded to a multiple of k a copy),
// which it takes at c <= 32 to fill the TPU's 128-lane registers; the
// packed layout also fixes which rows cross the exchange, so the port keeps
// it. The kernels read the per-limb tables (the flat stage rows, the
// shard's [M, n1, c] mid slices) at each lane's limb, so no pre-broadcast
// lane table exists on the card.
//
// What bounds the phase kernels on the card: a shard's slice is small (35 limbs
// [256, 64] at 4 shards: 2.3 MB in and out, plus 4.6 MB of mid tables for phase
// 1), so their bound is a few µs of bytes, and the first design (ntt_tile.cuh's
// column tiles: one block's serial loop of 8 shared-memory stages, a barrier
// each, every butterfly fully reduced) took ten to twenty times that. All eight
// run on ntt_reg.cuh's register passes, as B1 does: a block holds an [n, TC]
// tile of ONE limb, TC of 16 or 8 columns within the limb's c chosen on the
// host (ops/ntt_kernels.py::phase_tile_cols: at 4 shards, 140 blocks of 256
// threads; 4-column tiles, with 16-byte row segments, were slower everywhere);
// two register passes with one exchange, the twiddle pair loaded once a block,
// Harvey's lazy ranges. Phase 1 (B6, B10) is radix_phase1: CT along n1, then
// the mid product in registers. Phase 2 (B7, B11) is B1's phase B,
// radix_phase<L, fwd, !transposed>: CT along n2, reduced from [0, 4q) to [0, q)
// by two conditional subtracts before the store. The inverse phases mirror
// them: phase 2 (B8, B12) is B2's phase A, radix_phase<L, !fwd, !transposed>,
// GS along n2 in [0, 2q) and one conditional subtract before the store; phase
// 1 (B9, B13) is radix_iphase1, the mid_inv product in registers, then GS
// along n1 (radix_gs_rows, the passes of B2's phases). Each per-limb kernel is
// its packed twin with k = 1 (G = M groups of one limb): the block's limb is
// min((g mod G)*k + lane0 / c, M - 1) for its first lane lane0, the padding
// lanes of a copy's last group computing limb M - 1's copy, as their data is.
// One template serves all eight, under eight names so that a profile tells
// them apart.
//
// Stage twiddles are flat [M, n] tables: stage s, block b at column 2^s + b.
// Multiplies use Shoup pairs (w, floor(w * 2^32 / q)) and __umulhi.

#include <cuda_runtime.h>

#include <cstdint>

#include "ntt_reg.cuh"

namespace {

using hk::ilog2;
using hk::with_log;

// B1 and B2: one phase each on the [2^L, TC] tile at column TC*blockIdx.y
// of limb blockIdx.x, x and y [rows, 2^L * ncols] (ntt_reg.cuh's
// radix_phase says which side is transposed). mid, mid_sh: [M, 2^L * ncols]
// in the untransposed side's layout (kT only); tw, tw_sh: flat [M, 2^L].
#define HK_RADIX_KERNEL(name, fwd, transposed)                              \
  template <int L>                                                          \
  __global__ void __launch_bounds__(hk::RadixSplit<L>::kMaxThreads,         \
                                    hk::RadixSplit<L>::kMinBlocks)          \
      name(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,        \
           const uint32_t* __restrict__ q, const uint32_t* __restrict__ tw, \
           const uint32_t* __restrict__ tw_sh,                              \
           const uint32_t* __restrict__ mid,                                \
           const uint32_t* __restrict__ mid_sh, int M, int ncols,           \
           int logtc) {                                                     \
    const int limb = blockIdx.x, m = limb % M;                              \
    const size_t len = (size_t)ncols << L;                                  \
    hk::radix_phase<L, fwd, transposed>(                                    \
        x + limb * len, y + limb * len, q[m], tw + ((size_t)m << L),        \
        tw_sh + ((size_t)m << L), transposed ? mid + m * len : nullptr,     \
        transposed ? mid_sh + m * len : nullptr, ncols, logtc,              \
        blockIdx.y << logtc);                                               \
  }
HK_RADIX_KERNEL(ntt_fwd_radix_a, true, true)    // B1: CT n1, mid, transpose
HK_RADIX_KERNEL(ntt_fwd_radix_b, true, false)   // B1: CT n2
HK_RADIX_KERNEL(ntt_inv_radix_a, false, false)  // B2: GS n2
HK_RADIX_KERNEL(ntt_inv_radix_b, false, true)   // B2: transpose, mid_inv, GS n1
#undef HK_RADIX_KERNEL

// The phases B6-B13 on the [2^L, TC] tile at lane lane0 = TC*blockIdx.y
// of group g = blockIdx.x of x [rows, 2^L, k*c] (rows = rep*G groups, G =
// ceil(M/k) a copy; B6-B9: k = 1, G = M), TC <= c so that the tile lies
// in one limb's c lanes; that limb's q and flat stage pair rows (tw, tw_sh
// [M, 2^L]). kMid (phase 1): the limb's mid or mid_inv slice (mid, mid_sh
// [M, 2^L, c]), read at column lane0 mod c, in radix_phase1 (kFwd: B6,
// B10) or radix_iphase1 (B9, B13). !kMid (phase 2): B1's phase B (kFwd:
// B7, B11) or B2's phase A (B8, B12), radix_phase<L, kFwd, false>, whose
// !kT form reads and writes the tile at the data's own pitch and reads no
// per-column table.
template <int L, bool kFwd, bool kMid>
__device__ __forceinline__ void phase_tile(
    const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
    const uint32_t* __restrict__ q, const uint32_t* __restrict__ tw,
    const uint32_t* __restrict__ tw_sh, const uint32_t* __restrict__ mid,
    const uint32_t* __restrict__ mid_sh, int G, int M, int logk, int logc,
    int logtc) {
  const int g = blockIdx.x, lane0 = blockIdx.y << logtc;
  const int limb = min(((g % G) << logk) + (lane0 >> logc), M - 1);
  const int logm = logk + logc;
  const size_t len = (size_t)1 << (L + logm);
  const size_t trow = (size_t)limb << L;
  if constexpr (kMid) {
    const size_t mlen = (size_t)limb << (L + logc);
    const int mc0 = lane0 & ((1 << logc) - 1);
    if constexpr (kFwd)
      hk::radix_phase1<L>(x + g * len, y + g * len, q[limb], tw + trow,
                          tw_sh + trow, mid + mlen, mid_sh + mlen, 1 << logm,
                          1 << logc, logtc, lane0, mc0);
    else
      hk::radix_iphase1<L>(x + g * len, y + g * len, q[limb], tw + trow,
                           tw_sh + trow, mid + mlen, mid_sh + mlen,
                           1 << logm, 1 << logc, logtc, lane0, mc0);
  } else {
    hk::radix_phase<L, kFwd, false>(x + g * len, y + g * len, q[limb],
                                    tw + trow, tw_sh + trow, nullptr,
                                    nullptr, 1 << logm, logtc, lane0);
  }
}

#define HK_PHASE_KERNEL(name, fwd, with_mid)                                \
  template <int L>                                                          \
  __global__ void __launch_bounds__(hk::RadixSplit<L>::kMaxThreads,         \
                                    hk::RadixSplit<L>::kMinBlocks)          \
      name(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,        \
           const uint32_t* __restrict__ q, const uint32_t* __restrict__ tw, \
           const uint32_t* __restrict__ tw_sh,                              \
           const uint32_t* __restrict__ mid,                                \
           const uint32_t* __restrict__ mid_sh, int G, int M, int logk,     \
           int logc, int logtc) {                                           \
    phase_tile<L, fwd, with_mid>(x, y, q, tw, tw_sh, mid, mid_sh, G, M,     \
                                 logk, logc, logtc);                        \
  }
HK_PHASE_KERNEL(ntt_phase1_radix, true, true)        // B6
HK_PHASE_KERNEL(packed_phase1_radix, true, true)     // B10
HK_PHASE_KERNEL(ntt_phase2_radix, true, false)       // B7
HK_PHASE_KERNEL(packed_phase2_radix, true, false)    // B11
HK_PHASE_KERNEL(ntt_iphase2_radix, false, false)     // B8
HK_PHASE_KERNEL(packed_iphase2_radix, false, false)  // B12
HK_PHASE_KERNEL(ntt_iphase1_radix, false, true)      // B9
HK_PHASE_KERNEL(packed_iphase1_radix, false, true)   // B13
#undef HK_PHASE_KERNEL

using PhaseKernel = void (*)(const uint32_t*, uint32_t*, const uint32_t*,
                             const uint32_t*, const uint32_t*,
                             const uint32_t*, const uint32_t*, int, int, int,
                             int, int);

// The phase kernel at axis 2^L: forward or inverse (fwd), phase 1 or 2,
// per limb or lane-packed.
template <int L>
PhaseKernel phase_kernel(bool fwd, bool phase1, bool packed) {
  if (fwd)
    return phase1 ? (packed ? &packed_phase1_radix<L> : &ntt_phase1_radix<L>)
                  : (packed ? &packed_phase2_radix<L> : &ntt_phase2_radix<L>);
  return phase1 ? (packed ? &packed_iphase1_radix<L> : &ntt_iphase1_radix<L>)
                : (packed ? &packed_iphase2_radix<L> : &ntt_iphase2_radix<L>);
}

using RadixKernel = void (*)(const uint32_t*, uint32_t*, const uint32_t*,
                             const uint32_t*, const uint32_t*,
                             const uint32_t*, const uint32_t*, int, int, int);

// One radix phase on rows limbs of [2^L, ncols], tiles of TC = 2^logtc
// columns (ops/ntt_kernels.py::radix_phases chooses it): grid (rows,
// ncols/TC), TC * 2^floor(L/2) threads, TC <= RadixSplit's 16.
template <int L>
int launch_radix(RadixKernel kernel, const void* x, void* y, const void* q,
                 const void* tw, const void* tw_sh, const void* mid,
                 const void* mid_sh, int rows, int M, int logcols, int logtc,
                 cudaStream_t st) {
  int threads;
  size_t smem;
  const cudaError_t err =
      hk::radix_block<L>(kernel, logcols, logtc, &threads, &smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(rows, 1 << (logcols - logtc)), threads, smem, st>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(tw),
      static_cast<const uint32_t*>(tw_sh), static_cast<const uint32_t*>(mid),
      static_cast<const uint32_t*>(mid_sh), M, 1 << logcols, logtc);
  return cudaGetLastError();
}

bool bad_shape(int rows, int M, int log1, int log2) {
  return rows <= 0 || M <= 0 || rows % M != 0 || log1 < 1 || log2 < 1 ||
         log1 > 10 || log2 > 10;
}

// A phase kernel on [rows, n, c]: n a power of two in [2, 1024], c one in
// [1, n].
bool bad_phase(int rows, int M, int logn, int logc) {
  return rows <= 0 || M <= 0 || rows % M != 0 || logn < 1 || logn > 10 ||
         logc < 0 || logc > logn;
}

// A phase on rows = rep*G groups [2^logn, 2^(logk + logc)]: forward
// (`fwd`: B6, B7, B10, B11) or inverse (B8, B9, B12, B13), phase 1 if
// `phase1`, else phase 2; per limb (B6-B9: k = 1, G = M) unless `packed`.
// Tiles of
// TC = 2^logtc <= c lanes: grid (rows, k*c/TC), TC * 2^floor(logn/2)
// threads (radix_block).
int launch_phase(bool fwd, bool phase1, bool packed, const void* x,
                 void* out, const void* q, const void* tw, const void* tw_sh,
                 const void* mid, const void* mid_sh, int rows, int G, int M,
                 int logk, int logn, int logc, int logtc, void* stream) {
  if (rows <= 0 || G <= 0 || M <= 0 || rows % G != 0 || logk < 0 ||
      logc < 0 || logtc > logc || logn < 1 || logn > 10 ||
      (G << logk) < M || ((G - 1) << logk) >= M)
    return cudaErrorInvalidValue;
  return with_log(logn, [&](auto l) {
    constexpr int L = decltype(l)::value;
    const PhaseKernel kernel = phase_kernel<L>(fwd, phase1, packed);
    int threads;
    size_t smem;
    const cudaError_t err =
        hk::radix_block<L>(kernel, logk + logc, logtc, &threads, &smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(rows, 1 << (logk + logc - logtc)), threads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
        static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(tw),
        static_cast<const uint32_t*>(tw_sh),
        static_cast<const uint32_t*>(mid),
        static_cast<const uint32_t*>(mid_sh), G, M, logk, logc, logtc);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" {

const char* hk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// B1: x [rows, n1, n2] -> out [rows, n2, n1]; scratch [rows, n2, n1];
// tiles of 2^logtc_a columns in phase A, 2^logtc_b in phase B.
int hk_ntt_fwd(const void* x, void* scratch, void* out, const void* q,
               const void* tw1, const void* tw1_sh, const void* mid,
               const void* mid_sh, const void* tw2, const void* tw2_sh,
               int rows, int M, int n1, int n2, int logtc_a, int logtc_b,
               void* stream) {
  const int log1 = ilog2(n1), log2 = ilog2(n2);
  if (bad_shape(rows, M, log1, log2)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = with_log(log1, [&](auto l) {
    constexpr int L = decltype(l)::value;
    return launch_radix<L>(ntt_fwd_radix_a<L>, x, scratch, q, tw1,
                           tw1_sh, mid, mid_sh, rows, M, log2, logtc_a, st);
  });
  if (err != cudaSuccess) return err;
  return with_log(log2, [&](auto l) {
    constexpr int L = decltype(l)::value;
    return launch_radix<L>(ntt_fwd_radix_b<L>, scratch, out, q, tw2,
                           tw2_sh, nullptr, nullptr, rows, M, log1, logtc_b,
                           st);
  });
}

// B2: x [rows, n2, n1] -> out [rows, n1, n2]; scratch [rows, n2, n1];
// tiles of 2^logtc_a columns (of n1) in phase A, 2^logtc_b (of n2) in B.
int hk_ntt_inv(const void* x, void* scratch, void* out, const void* q,
               const void* itw2, const void* itw2_sh, const void* mid_inv,
               const void* mid_inv_sh, const void* itw1,
               const void* itw1_sh, int rows, int M, int n1, int n2,
               int logtc_a, int logtc_b, void* stream) {
  const int log1 = ilog2(n1), log2 = ilog2(n2);
  if (bad_shape(rows, M, log1, log2)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = with_log(log2, [&](auto l) {
    constexpr int L = decltype(l)::value;
    return launch_radix<L>(ntt_inv_radix_a<L>, x, scratch, q, itw2,
                           itw2_sh, nullptr, nullptr, rows, M, log1,
                           logtc_a, st);
  });
  if (err != cudaSuccess) return err;
  return with_log(log1, [&](auto l) {
    constexpr int L = decltype(l)::value;
    return launch_radix<L>(ntt_inv_radix_b<L>, scratch, out, q, itw1,
                           itw1_sh, mid_inv, mid_inv_sh, rows, M, log2,
                           logtc_b, st);
  });
}

// B6: x [rows, n1, c] -> out [rows, n1, c]; mid, mid_sh [M, n1, c]; tiles
// of 2^logtc columns (ops/ntt_kernels.py::phase_tile_cols).
int hk_ntt_phase1(const void* x, void* out, const void* q, const void* tw1,
                  const void* tw1_sh, const void* mid, const void* mid_sh,
                  int rows, int M, int n1, int c, int logtc, void* stream) {
  const int log1 = ilog2(n1), logc = ilog2(c);
  if (bad_phase(rows, M, log1, logc)) return cudaErrorInvalidValue;
  return launch_phase(true, true, false, x, out, q, tw1, tw1_sh, mid, mid_sh,
                      rows, M, M, 0, log1, logc, logtc, stream);
}

// B7: x [rows, n2, c] -> out [rows, n2, c]; tiles of 2^logtc columns
// (ops/ntt_kernels.py::phase_tile_cols).
int hk_ntt_phase2(const void* x, void* out, const void* q, const void* tw2,
                  const void* tw2_sh, int rows, int M, int n2, int c,
                  int logtc, void* stream) {
  const int log2 = ilog2(n2), logc = ilog2(c);
  if (bad_phase(rows, M, log2, logc)) return cudaErrorInvalidValue;
  return launch_phase(true, false, false, x, out, q, tw2, tw2_sh, nullptr,
                      nullptr, rows, M, M, 0, log2, logc, logtc, stream);
}

// B8: x [rows, n2, c] -> out [rows, n2, c]; tiles of 2^logtc columns.
int hk_intt_phase2(const void* x, void* out, const void* q, const void* itw2,
                   const void* itw2_sh, int rows, int M, int n2, int c,
                   int logtc, void* stream) {
  const int log2 = ilog2(n2), logc = ilog2(c);
  if (bad_phase(rows, M, log2, logc)) return cudaErrorInvalidValue;
  return launch_phase(false, false, false, x, out, q, itw2, itw2_sh, nullptr,
                      nullptr, rows, M, M, 0, log2, logc, logtc, stream);
}

// B9: x [rows, n1, c] -> out [rows, n1, c]; mid_inv, mid_inv_sh [M, n1, c];
// tiles of 2^logtc columns.
int hk_intt_phase1(const void* x, void* out, const void* q,
                   const void* mid_inv, const void* mid_inv_sh,
                   const void* itw1, const void* itw1_sh, int rows, int M,
                   int n1, int c, int logtc, void* stream) {
  const int log1 = ilog2(n1), logc = ilog2(c);
  if (bad_phase(rows, M, log1, logc)) return cudaErrorInvalidValue;
  return launch_phase(false, true, false, x, out, q, itw1, itw1_sh, mid_inv,
                      mid_inv_sh, rows, M, M, 0, log1, logc, logtc, stream);
}

// B10: x [rows, n1, k*c] -> out, same layout; mid, mid_sh [M, n1, c];
// tiles of 2^logtc <= c lanes (ops/ntt_kernels.py::phase_tile_cols).
int hk_ntt_phase1_packed(const void* x, void* out, const void* q,
                         const void* tw1, const void* tw1_sh, const void* mid,
                         const void* mid_sh, int rows, int G, int M, int k,
                         int n1, int c, int logtc, void* stream) {
  return launch_phase(true, true, true, x, out, q, tw1, tw1_sh, mid, mid_sh,
                      rows, G, M, ilog2(k), ilog2(n1), ilog2(c), logtc,
                      stream);
}

// B11: x [rows, n2, k*c] -> out, same layout; tiles of 2^logtc <= c lanes.
int hk_ntt_phase2_packed(const void* x, void* out, const void* q,
                         const void* tw2, const void* tw2_sh, int rows, int G,
                         int M, int k, int n2, int c, int logtc,
                         void* stream) {
  return launch_phase(true, false, true, x, out, q, tw2, tw2_sh, nullptr,
                      nullptr, rows, G, M, ilog2(k), ilog2(n2), ilog2(c),
                      logtc, stream);
}

// B12: x [rows, n2, k*c] -> out, same layout; tiles of 2^logtc <= c lanes.
int hk_intt_phase2_packed(const void* x, void* out, const void* q,
                          const void* itw2, const void* itw2_sh, int rows,
                          int G, int M, int k, int n2, int c, int logtc,
                          void* stream) {
  return launch_phase(false, false, true, x, out, q, itw2, itw2_sh, nullptr,
                      nullptr, rows, G, M, ilog2(k), ilog2(n2), ilog2(c),
                      logtc, stream);
}

// B13: x [rows, n1, k*c] -> out, same layout; mid_inv, mid_inv_sh
// [M, n1, c]; tiles of 2^logtc <= c lanes.
int hk_intt_phase1_packed(const void* x, void* out, const void* q,
                          const void* mid_inv, const void* mid_inv_sh,
                          const void* itw1, const void* itw1_sh, int rows,
                          int G, int M, int k, int n1, int c, int logtc,
                          void* stream) {
  return launch_phase(false, true, true, x, out, q, itw1, itw1_sh, mid_inv,
                      mid_inv_sh, rows, G, M, ilog2(k), ilog2(n1), ilog2(c),
                      logtc, stream);
}

}  // extern "C"
