// Negacyclic 4-step NTT (kernel B1) and its inverse (kernel B2) over RNS
// limbs, and the four phase kernels of the coefficient-sharded transform
// (B6-B9), for Hopper (sm_90a).
//
// Replaces: homulator_tpu/ops/ntt_pallas.py::ntt_pallas (B1),
// ::intt_pallas (B2), ::ntt_phase1_pallas (B6), ::ntt_phase2_pallas (B7),
// ::intt_phase2_pallas (B8) and ::intt_phase1_pallas (B9). Same network and
// tables as the plain versions (homulator_tpu_torch/ops/ntt.py), so the
// outputs are the same canonical residues bit for bit.
//
// What bounds it on the card: a whole N = 2^16 limb is 256 KiB of uint32,
// more than the 227 KB of shared memory a block can hold, so the TPU design
// (one limb in VMEM, all stages on chip) does not carry over. Each
// transform is two launches (the phase-split template of
// ntt_pallas.py:274-407): a block owns an [n, TC] column tile of one limb,
// loads it with coalesced row reads, runs all log2(n) butterfly stages of
// one axis in shared memory, and writes it out; the 4-step transpose
// happens in the write of the first phase (through a scratch array). Per
// limb each phase reads and writes the limb once, and the mid-twiddle phase
// also reads its value and Shoup tables: about 1.5 MiB of device memory
// traffic per limb at N = 2^16, against some 12 integer instructions for
// each of the N/2 * log2(N) butterflies, so the two are of the same order
// on an H100. This first version is kept simple: values are fully reduced
// after every butterfly, twiddles come from global memory through the
// cache, and a block synchronises between stages.
//
// Every kernel takes its limbs as rows of pitch 2^logc and tiles of TC =
// min(32, 2^logc) columns. Forward, [rows, n1, n2] coeff -> [rows, n2, n1]
// eval tiles:
//   phase A  ntt_fwd_a<true>, grid (rows, n2/TC), pitch n2: CT stages along
//            n1, times tw_mid, written transposed into scratch [rows, n2, n1]
//   phase B  ntt_fwd_b, grid (rows, n1/TC), pitch n1: CT stages along n2
// Inverse, [rows, n2, n1] -> [rows, n1, n2]:
//   phase A  ntt_inv_a<true>, pitch n1: GS stages along n2, written
//            transposed into scratch [rows, n1, n2]
//   phase B  ntt_inv_b, pitch n2: times tw_mid_inv (carries 1/N), GS stages
//            along n1
// On a coefficient shard the transpose is the all_to_all between the two
// halves (ops/ntt.py), so each half is its own entry point on a column
// slice of c = n/ns columns, output in its input's layout:
//   B6 ntt_fwd_a<false>  [rows, n1, c] -> [rows, n1, c]
//   B7 ntt_fwd_b         [rows, n2, c] -> [rows, n2, c]
//   B8 ntt_inv_a<false>  [rows, n2, c] -> [rows, n2, c]
//   B9 ntt_inv_b         [rows, n1, c] -> [rows, n1, c]
// B6 and B9 take the shard's mid / mid_inv tables as their own contiguous
// [M, n1, c] column slice (DeviceContext builds one per rank), indexed like
// the data. A grid is (rows, c/TC): at N = 2^16 and 4 shards, B6 on 35 limbs
// is 70 blocks, about half the card's 132 SMs.
// Table rows are limb % M, so rep stacked copies share one basis's tables.
// Stage twiddles are flat [M, n] tables: stage s, block b at column 2^s + b.
// Multiplies use Shoup pairs (w, floor(w * 2^32 / q)) and __umulhi.

#include <cuda_runtime.h>

#include <cstdint>

#include "ntt_tile.cuh"

namespace {

using hk::ct_rows;
using hk::gs_rows;
using hk::ilog2;
using hk::kLogTileCols;
using hk::kThreads;
using hk::load_tile;
using hk::min_int;
using hk::store_tile;
using hk::store_tile_t;
using hk::tile_smem;

// Forward stage 1 (B1 phase A, B6): x[limb] is [n1, 2^logc]; tile [n1, TC]
// at column c0.
template <bool kTranspose>
__global__ void __launch_bounds__(kThreads)
ntt_fwd_a(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
          const uint32_t* __restrict__ q, const uint32_t* __restrict__ tw1,
          const uint32_t* __restrict__ tw1_sh,
          const uint32_t* __restrict__ mid,
          const uint32_t* __restrict__ mid_sh, int M, int log1, int logc,
          int logtc) {
  extern __shared__ uint32_t s[];
  const int limb = blockIdx.x, m = limb % M;
  const size_t len = (size_t)1 << (log1 + logc);
  hk::fwd_a_tile<kTranspose>(
      s, x + limb * len, y + limb * len, q[m], tw1 + ((size_t)m << log1),
      tw1_sh + ((size_t)m << log1), mid + m * len, mid_sh + m * len, log1,
      logc, logtc, blockIdx.y << logtc);
}

// Forward stage 2 (B1 phase B, B7): y[limb] is [n2, 2^logc]; tile [n2, TC]
// at column c0.
__global__ void __launch_bounds__(kThreads)
ntt_fwd_b(const uint32_t* __restrict__ y, uint32_t* __restrict__ out,
          const uint32_t* __restrict__ q, const uint32_t* __restrict__ tw2,
          const uint32_t* __restrict__ tw2_sh, int M, int log2, int logc,
          int logtc) {
  extern __shared__ uint32_t s[];
  const int ld = (1 << logtc) + 1;
  const int limb = blockIdx.x, m = limb % M, c0 = blockIdx.y << logtc;
  const size_t len = (size_t)1 << (log2 + logc);
  const uint32_t qq = q[m];
  load_tile(s, y + limb * len, log2, logtc, ld, 1 << logc, c0, nullptr,
            nullptr, qq);
  ct_rows(s, log2, logtc, ld, tw2 + ((size_t)m << log2),
          tw2_sh + ((size_t)m << log2), qq);
  store_tile(s, out + limb * len, log2, logtc, ld, 1 << logc, c0);
}

// Inverse stage 2 (B2 phase A, B8): x[limb] is [n2, 2^logc]; tile [n2, TC]
// at column c0. kTranspose: written transposed into y [2^logc, n2].
template <bool kTranspose>
__global__ void __launch_bounds__(kThreads)
ntt_inv_a(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
          const uint32_t* __restrict__ q, const uint32_t* __restrict__ itw2,
          const uint32_t* __restrict__ itw2_sh, int M, int log2, int logc,
          int logtc) {
  extern __shared__ uint32_t s[];
  const int ld = (1 << logtc) + 1;
  const int limb = blockIdx.x, m = limb % M, c0 = blockIdx.y << logtc;
  const size_t len = (size_t)1 << (log2 + logc);
  const uint32_t qq = q[m];
  load_tile(s, x + limb * len, log2, logtc, ld, 1 << logc, c0, nullptr,
            nullptr, qq);
  gs_rows(s, log2, logtc, ld, itw2 + ((size_t)m << log2),
          itw2_sh + ((size_t)m << log2), qq);
  if constexpr (kTranspose) {
    store_tile_t(s, y + limb * len, log2, logtc, ld, c0);
  } else {
    store_tile(s, y + limb * len, log2, logtc, ld, 1 << logc, c0);
  }
}

// Inverse stage 1 (B2 phase B, B9): y[limb] is [n1, 2^logc] and so is the
// limb's mid_inv table; tile [n1, TC] at column c0.
__global__ void __launch_bounds__(kThreads)
ntt_inv_b(const uint32_t* __restrict__ y, uint32_t* __restrict__ out,
          const uint32_t* __restrict__ q,
          const uint32_t* __restrict__ mid_inv,
          const uint32_t* __restrict__ mid_inv_sh,
          const uint32_t* __restrict__ itw1,
          const uint32_t* __restrict__ itw1_sh, int M, int log1, int logc,
          int logtc) {
  extern __shared__ uint32_t s[];
  const int ld = (1 << logtc) + 1;
  const int limb = blockIdx.x, m = limb % M, c0 = blockIdx.y << logtc;
  const size_t len = (size_t)1 << (log1 + logc);
  const uint32_t qq = q[m];
  load_tile(s, y + limb * len, log1, logtc, ld, 1 << logc, c0,
            mid_inv + m * len, mid_inv_sh + m * len, qq);
  gs_rows(s, log1, logtc, ld, itw1 + ((size_t)m << log1),
          itw1_sh + ((size_t)m << log1), qq);
  store_tile(s, out + limb * len, log1, logtc, ld, 1 << logc, c0);
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

}  // namespace

extern "C" {

const char* hk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x [rows, n1, n2] -> out [rows, n2, n1]; scratch [rows, n2, n1].
int hk_ntt_fwd(const void* x, void* scratch, void* out, const void* q,
               const void* tw1, const void* tw1_sh, const void* mid,
               const void* mid_sh, const void* tw2, const void* tw2_sh,
               int rows, int M, int n1, int n2, void* stream) {
  const int log1 = ilog2(n1), log2 = ilog2(n2);
  if (bad_shape(rows, M, log1, log2)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const uint32_t*>(q);
  size_t smem;
  cudaError_t err;
  const int lta = min_int(kLogTileCols, log2);
  if ((err = tile_smem(ntt_fwd_a<true>, log1, lta, &smem)) != cudaSuccess)
    return err;
  ntt_fwd_a<true><<<dim3(rows, n2 >> lta), kThreads, smem, st>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(scratch), qp,
      static_cast<const uint32_t*>(tw1), static_cast<const uint32_t*>(tw1_sh),
      static_cast<const uint32_t*>(mid), static_cast<const uint32_t*>(mid_sh),
      M, log1, log2, lta);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int ltb = min_int(kLogTileCols, log1);
  if ((err = tile_smem(ntt_fwd_b, log2, ltb, &smem)) != cudaSuccess)
    return err;
  ntt_fwd_b<<<dim3(rows, n1 >> ltb), kThreads, smem, st>>>(
      static_cast<const uint32_t*>(scratch), static_cast<uint32_t*>(out), qp,
      static_cast<const uint32_t*>(tw2), static_cast<const uint32_t*>(tw2_sh),
      M, log2, log1, ltb);
  return cudaGetLastError();
}

// x [rows, n2, n1] -> out [rows, n1, n2]; scratch [rows, n1, n2].
int hk_ntt_inv(const void* x, void* scratch, void* out, const void* q,
               const void* itw2, const void* itw2_sh, const void* mid_inv,
               const void* mid_inv_sh, const void* itw1,
               const void* itw1_sh, int rows, int M, int n1, int n2,
               void* stream) {
  const int log1 = ilog2(n1), log2 = ilog2(n2);
  if (bad_shape(rows, M, log1, log2)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const uint32_t*>(q);
  size_t smem;
  cudaError_t err;
  const int lta = min_int(kLogTileCols, log1);
  if ((err = tile_smem(ntt_inv_a<true>, log2, lta, &smem)) != cudaSuccess)
    return err;
  ntt_inv_a<true><<<dim3(rows, n1 >> lta), kThreads, smem, st>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(scratch), qp,
      static_cast<const uint32_t*>(itw2),
      static_cast<const uint32_t*>(itw2_sh), M, log2, log1, lta);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int ltb = min_int(kLogTileCols, log2);
  if ((err = tile_smem(ntt_inv_b, log1, ltb, &smem)) != cudaSuccess)
    return err;
  ntt_inv_b<<<dim3(rows, n2 >> ltb), kThreads, smem, st>>>(
      static_cast<const uint32_t*>(scratch), static_cast<uint32_t*>(out), qp,
      static_cast<const uint32_t*>(mid_inv),
      static_cast<const uint32_t*>(mid_inv_sh),
      static_cast<const uint32_t*>(itw1),
      static_cast<const uint32_t*>(itw1_sh), M, log1, log2, ltb);
  return cudaGetLastError();
}

// B6: x [rows, n1, c] -> out [rows, n1, c]; mid, mid_sh [M, n1, c].
int hk_ntt_phase1(const void* x, void* out, const void* q, const void* tw1,
                  const void* tw1_sh, const void* mid, const void* mid_sh,
                  int rows, int M, int n1, int c, void* stream) {
  const int log1 = ilog2(n1), logc = ilog2(c);
  if (bad_phase(rows, M, log1, logc)) return cudaErrorInvalidValue;
  const int lt = min_int(kLogTileCols, logc);
  size_t smem;
  cudaError_t err;
  if ((err = tile_smem(ntt_fwd_a<false>, log1, lt, &smem)) != cudaSuccess)
    return err;
  ntt_fwd_a<false><<<dim3(rows, c >> lt), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(tw1),
      static_cast<const uint32_t*>(tw1_sh), static_cast<const uint32_t*>(mid),
      static_cast<const uint32_t*>(mid_sh), M, log1, logc, lt);
  return cudaGetLastError();
}

// B7: x [rows, n2, c] -> out [rows, n2, c].
int hk_ntt_phase2(const void* x, void* out, const void* q, const void* tw2,
                  const void* tw2_sh, int rows, int M, int n2, int c,
                  void* stream) {
  const int log2 = ilog2(n2), logc = ilog2(c);
  if (bad_phase(rows, M, log2, logc)) return cudaErrorInvalidValue;
  const int lt = min_int(kLogTileCols, logc);
  size_t smem;
  cudaError_t err;
  if ((err = tile_smem(ntt_fwd_b, log2, lt, &smem)) != cudaSuccess)
    return err;
  ntt_fwd_b<<<dim3(rows, c >> lt), kThreads, smem,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(tw2),
      static_cast<const uint32_t*>(tw2_sh), M, log2, logc, lt);
  return cudaGetLastError();
}

// B8: x [rows, n2, c] -> out [rows, n2, c].
int hk_intt_phase2(const void* x, void* out, const void* q, const void* itw2,
                   const void* itw2_sh, int rows, int M, int n2, int c,
                   void* stream) {
  const int log2 = ilog2(n2), logc = ilog2(c);
  if (bad_phase(rows, M, log2, logc)) return cudaErrorInvalidValue;
  const int lt = min_int(kLogTileCols, logc);
  size_t smem;
  cudaError_t err;
  if ((err = tile_smem(ntt_inv_a<false>, log2, lt, &smem)) != cudaSuccess)
    return err;
  ntt_inv_a<false><<<dim3(rows, c >> lt), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(itw2),
      static_cast<const uint32_t*>(itw2_sh), M, log2, logc, lt);
  return cudaGetLastError();
}

// B9: x [rows, n1, c] -> out [rows, n1, c]; mid_inv, mid_inv_sh [M, n1, c].
int hk_intt_phase1(const void* x, void* out, const void* q,
                   const void* mid_inv, const void* mid_inv_sh,
                   const void* itw1, const void* itw1_sh, int rows, int M,
                   int n1, int c, void* stream) {
  const int log1 = ilog2(n1), logc = ilog2(c);
  if (bad_phase(rows, M, log1, logc)) return cudaErrorInvalidValue;
  const int lt = min_int(kLogTileCols, logc);
  size_t smem;
  cudaError_t err;
  if ((err = tile_smem(ntt_inv_b, log1, lt, &smem)) != cudaSuccess)
    return err;
  ntt_inv_b<<<dim3(rows, c >> lt), kThreads, smem,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(mid_inv),
      static_cast<const uint32_t*>(mid_inv_sh),
      static_cast<const uint32_t*>(itw1), static_cast<const uint32_t*>(itw1_sh),
      M, log1, logc, lt);
  return cudaGetLastError();
}

}  // extern "C"
