// Negacyclic 4-step NTT (kernel B1) and its inverse (kernel B2) over RNS
// limbs, for Hopper (sm_90a).
//
// Replaces: homulator_tpu/ops/ntt_pallas.py::ntt_pallas (B1) and
// ::intt_pallas (B2). Same network and tables as the plain version
// (homulator_tpu_torch/ops/ntt.py), so the outputs are the same canonical
// residues bit for bit.
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
// Forward, [rows, n1, n2] coeff tiles -> [rows, n2, n1] eval tiles:
//   phase A  grid (rows, n2/TC): CT stages along n1, times tw_mid,
//            written transposed into scratch [rows, n2, n1]
//   phase B  grid (rows, n1/TC): CT stages along n2 -> out
// Inverse, [rows, n2, n1] -> [rows, n1, n2]:
//   phase A  grid (rows, n1/TC): GS stages along n2, written transposed
//            into scratch [rows, n1, n2]
//   phase B  grid (rows, n2/TC): times tw_mid_inv (carries 1/N), GS stages
//            along n1 -> out
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

// Forward phase A: x[limb] is [n1, n2]; tile [n1, TC] at column c0 of n2.
__global__ void __launch_bounds__(kThreads)
ntt_fwd_a(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
          const uint32_t* __restrict__ q, const uint32_t* __restrict__ tw1,
          const uint32_t* __restrict__ tw1_sh,
          const uint32_t* __restrict__ mid,
          const uint32_t* __restrict__ mid_sh, int M, int log1, int log2,
          int logtc) {
  extern __shared__ uint32_t s[];
  const int limb = blockIdx.x, m = limb % M;
  const size_t N = (size_t)1 << (log1 + log2);
  hk::fwd_a_tile(s, x + limb * N, y + limb * N, q[m],
                 tw1 + ((size_t)m << log1), tw1_sh + ((size_t)m << log1),
                 mid + m * N, mid_sh + m * N, log1, log2, logtc,
                 blockIdx.y << logtc);
}

// Forward phase B: y[limb] is [n2, n1]; tile [n2, TC] at column c0 of n1.
__global__ void __launch_bounds__(kThreads)
ntt_fwd_b(const uint32_t* __restrict__ y, uint32_t* __restrict__ out,
          const uint32_t* __restrict__ q, const uint32_t* __restrict__ tw2,
          const uint32_t* __restrict__ tw2_sh, int M, int log1, int log2,
          int logtc) {
  extern __shared__ uint32_t s[];
  const int ld = (1 << logtc) + 1;
  const int limb = blockIdx.x, m = limb % M, c0 = blockIdx.y << logtc;
  const size_t N = (size_t)1 << (log1 + log2);
  const uint32_t qq = q[m];
  load_tile(s, y + limb * N, log2, logtc, ld, 1 << log1, c0, nullptr,
            nullptr, qq);
  ct_rows(s, log2, logtc, ld, tw2 + ((size_t)m << log2),
          tw2_sh + ((size_t)m << log2), qq);
  store_tile(s, out + limb * N, log2, logtc, ld, 1 << log1, c0);
}

// Inverse phase A: x[limb] is [n2, n1]; tile [n2, TC] at column c0 of n1.
__global__ void __launch_bounds__(kThreads)
ntt_inv_a(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
          const uint32_t* __restrict__ q, const uint32_t* __restrict__ itw2,
          const uint32_t* __restrict__ itw2_sh, int M, int log1, int log2,
          int logtc) {
  extern __shared__ uint32_t s[];
  const int ld = (1 << logtc) + 1;
  const int limb = blockIdx.x, m = limb % M, c0 = blockIdx.y << logtc;
  const size_t N = (size_t)1 << (log1 + log2);
  const uint32_t qq = q[m];
  load_tile(s, x + limb * N, log2, logtc, ld, 1 << log1, c0, nullptr,
            nullptr, qq);
  gs_rows(s, log2, logtc, ld, itw2 + ((size_t)m << log2),
          itw2_sh + ((size_t)m << log2), qq);
  store_tile_t(s, y + limb * N, log2, logtc, ld, c0);
}

// Inverse phase B: y[limb] is [n1, n2]; tile [n1, TC] at column c0 of n2.
__global__ void __launch_bounds__(kThreads)
ntt_inv_b(const uint32_t* __restrict__ y, uint32_t* __restrict__ out,
          const uint32_t* __restrict__ q,
          const uint32_t* __restrict__ mid_inv,
          const uint32_t* __restrict__ mid_inv_sh,
          const uint32_t* __restrict__ itw1,
          const uint32_t* __restrict__ itw1_sh, int M, int log1, int log2,
          int logtc) {
  extern __shared__ uint32_t s[];
  const int ld = (1 << logtc) + 1;
  const int limb = blockIdx.x, m = limb % M, c0 = blockIdx.y << logtc;
  const size_t N = (size_t)1 << (log1 + log2);
  const uint32_t qq = q[m];
  load_tile(s, y + limb * N, log1, logtc, ld, 1 << log2, c0, mid_inv + m * N,
            mid_inv_sh + m * N, qq);
  gs_rows(s, log1, logtc, ld, itw1 + ((size_t)m << log1),
          itw1_sh + ((size_t)m << log1), qq);
  store_tile(s, out + limb * N, log1, logtc, ld, 1 << log2, c0);
}

bool bad_shape(int rows, int M, int log1, int log2) {
  return rows <= 0 || M <= 0 || rows % M != 0 || log1 < 1 || log2 < 1 ||
         log1 > 10 || log2 > 10;
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
  if ((err = tile_smem(ntt_fwd_a, log1, lta, &smem)) != cudaSuccess)
    return err;
  ntt_fwd_a<<<dim3(rows, n2 >> lta), kThreads, smem, st>>>(
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
      M, log1, log2, ltb);
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
  if ((err = tile_smem(ntt_inv_a, log2, lta, &smem)) != cudaSuccess)
    return err;
  ntt_inv_a<<<dim3(rows, n1 >> lta), kThreads, smem, st>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(scratch), qp,
      static_cast<const uint32_t*>(itw2),
      static_cast<const uint32_t*>(itw2_sh), M, log1, log2, lta);
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

}  // extern "C"
