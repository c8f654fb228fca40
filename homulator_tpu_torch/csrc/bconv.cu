// RNS base conversion (kernel B3) and its step 2 alone (kernel B5) on
// Hopper's tensor cores (sm_90a).
//
// B3 replaces homulator_tpu/ops/bconv_fused.py::bconv_fused. Per coefficient
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
// B5 replaces homulator_tpu/ops/bconv_pallas.py::bconv_step2_pallas, the
// graph route's step 2 (ntt_mode="jnp": every ModUp digit and ModDown):
// out_j = sum_t xhat_t * M[j, t] mod p_j on rows xhat already scaled by
// step 1 outside the kernel, as the JAX function takes them, the count row
// v last when the conversion is centered (its column is the table's last).
// It is B3's device code with step 1 and the count turned off (Step2
// below): the staged word is the A fragment itself, and the byte planes
// take any uint32, so inputs may exceed the output prime. Its first form,
// one thread a coefficient with nd Shoup products and a 64-bit remainder
// an output, was bound by integer instructions at 34-42% of its bound;
// on the tensor cores it moves the same bytes as B3 (PERF.md §6).
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
// What bounds both on the card: bytes. A ModUp digit at N = 2^16 reads 15
// limbs (B5: 16 rows, the count row included) and writes 35 (13.1 MB, 3.9
// us at 3.35 TB/s; B5 13.4 MB, 4.0 us); B3's int32 work
// (step 1, the count, the epilogue: ~665 operations a coefficient, 2.6 us
// at 16.75 T/s) and its u8 products (1.2 G operations, 0.6 us at 1979
// T/s) are below that. So nothing but x and the output crosses device
// memory: step 1 and the count run on each warp's staged x tile as the A
// fragments are built, the plane sums stay in registers, and each output
// word is written once.
//
// A batch of B conversions on the same table (the batched hmult's, one
// for each ciphertext) is one launch: blockIdx.z picks the element, whose
// x and out start x_bstride and out_bstride words after the previous
// one's (so x may be a row slice of a larger batch). This is what a vmap
// does to the TPU kernel's pallas_call: one more grid axis. Each z-slice
// stages the table itself (from L2 after the first); nothing is copied
// B times. The persistent grid is shared out: grid_blocks gives each of
// the B slices 1/B of the blocks that fit, so at B = 1 the launch is the
// one it was.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "modarith.cuh"
#include "planes_mma.cuh"

namespace {

using namespace hk::planes;

// The epilogue of both ops: the residues of output rows 8 jb .. 8 jb + 7
// of a warp tile from their plane sums (see the note above), with the
// output rows' q and horner_sh staged in outc.
struct Residues {
  const uint32_t* hsh;
  const uint32_t* out_q;
  uint32_t* out;
  uint2* outc;  // shared [8 jb]: q, horner_sh
  int m_out, g, tig;
  long long ncoef;

  __device__ void stage() const {
    for (int j = threadIdx.x; j < (m_out + 7) / 8 * 8; j += blockDim.x)
      outc[j] = j < m_out ? make_uint2(out_q[j], hsh[j]) : make_uint2(1, 0);
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

// B3: step 1 and the centering count on the staged words, then step 2.
struct Conv {
  Residues res;
  const uint32_t* s;
  const uint32_t* s_sh;
  const uint32_t* in_q;
  uint4* rowc;  // shared [8 ks]: s, s_sh, q, centering threshold
  Layout lay;
  int nd_in, center;

  __device__ void stage() const {
    for (int t = threadIdx.x; t < 8 * lay.ks; t += blockDim.x) {
      // rows past nd_in: xh = 0 (s = 0), never counted
      rowc[t] = t < nd_in ? make_uint4(s[t], s_sh[t], in_q[t],
                                       (in_q[t] >> 1) + 1)
                          : make_uint4(0, 0, ~0u, ~0u);
    }
    res.stage();
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
            if (8 * ks + 4 * h2 + res.tig == nd_in) a[mt][ks][h + 2 * h2] = v;
      }
    }
  }

  __device__ void store(int jb, const int (&d)[2][4][4], long long c0,
                        bool full) const {
    res.store(jb, d, c0, full);
  }
};

// B5: step 2 alone. The staged words are the rows xhat_t themselves (the
// count row, when there is one, the last of them), so an A-fragment
// register is the word as it was loaded; rows past nd hold no data and
// enter as 0.
struct Step2 {
  Residues res;
  int nd;

  __device__ void stage() const { res.stage(); }

  __device__ uint32_t input(int t, uint32_t x, uint32_t&) const {
    return t < nd ? x : 0u;
  }

  template <int KS>
  __device__ void count(uint32_t (&)[2][KS][4],
                        const uint32_t (&)[2][2]) const {}

  __device__ void store(int jb, const int (&d)[2][4][4], long long c0,
                        bool full) const {
    res.store(jb, d, c0, full);
  }
};

// The epilogue's view of a launch: its output, the output rows' constants
// in shared memory after the input rows' (a uint4 each, B3's), and the
// thread's fragment coordinates.
__device__ Residues residues(uint32_t* out, const uint32_t* hsh,
                             const uint32_t* out_q, int m_out,
                             long long ncoef, uint8_t* sm,
                             const Layout& lay) {
  const int lane = threadIdx.x & 31;
  return Residues{hsh, out_q, out,
                  reinterpret_cast<uint2*>(sm + lay.const_offset() +
                                           16 * 8 * lay.ks),
                  m_out, lane >> 2, lane & 3, ncoef};
}

template <int KS>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
bconv_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
             const uint32_t* __restrict__ s, const uint32_t* __restrict__ s_sh,
             const uint32_t* __restrict__ in_q,
             const uint8_t* __restrict__ tab,
             const uint32_t* __restrict__ hsh,
             const uint32_t* __restrict__ out_q, int nd, int center,
             int m_out, long long ncoef, int vec, long long x_bstride,
             long long out_bstride) {
  extern __shared__ __align__(16) uint8_t sm[];
  x += blockIdx.z * x_bstride;
  out += blockIdx.z * out_bstride;
  const Layout lay(nd + center, m_out, 0);
  Conv op{residues(out, hsh, out_q, m_out, ncoef, sm, lay), s, s_sh, in_q,
          reinterpret_cast<uint4*>(sm + lay.const_offset()), lay, nd,
          center};
  run<KS>(op, x, tab, nd, ncoef, vec, sm, lay);
}

template <int KS>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
bconv_step2_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                   const uint8_t* __restrict__ tab,
                   const uint32_t* __restrict__ hsh,
                   const uint32_t* __restrict__ out_q, int nd, int m_out,
                   long long ncoef, int vec, long long x_bstride,
                   long long out_bstride) {
  extern __shared__ __align__(16) uint8_t sm[];
  x += blockIdx.z * x_bstride;
  out += blockIdx.z * out_bstride;
  const Layout lay(nd, m_out, 0);
  Step2 op{residues(out, hsh, out_q, m_out, ncoef, sm, lay), nd};
  run<KS>(op, x, tab, nd, ncoef, vec, sm, lay);
}

// f(std::integral_constant<int, KS>()) for the k32 steps KS = ceil(nd / 8)
// of a table of nd <= 32 columns / 4: the host's dispatch to an
// instantiation.
template <class F>
cudaError_t with_ks(int nd, F&& f) {
  switch ((nd + 7) / 8) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    default: return f(std::integral_constant<int, 4>());
  }
}

// A launch of B3's or B5's kernel over ncoef coefficients of each of
// `batch` elements (x_bstride / out_bstride words apart), nd table columns
// / 4 and m_out output rows: the grid of grid_blocks in x, the batch in z,
// kThreads a block, Layout's shared memory; vec when x, its batch stride
// and ncoef allow 16-byte loads.
template <class Kernel, class... Args>
cudaError_t launch(Kernel kernel, int nd, int m_out, const void* x,
                   long long ncoef, int batch, long long x_bstride,
                   long long out_bstride, cudaStream_t st, Args... args) {
  const size_t smem = Layout(nd, m_out, 0).bytes();
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int vec = ncoef % 4 == 0 && x_bstride % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  kernel<<<dim3(grid_blocks(ncoef, smem, batch), 1, batch), kThreads, smem,
           st>>>(static_cast<const uint32_t*>(x), args..., ncoef, vec,
                 x_bstride, out_bstride);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [batch][nd, ncoef] -> out [batch][m_out, ncoef], element b of x at
// x + b x_bstride, of out at out + b out_bstride (words; rows contiguous
// within an element); s, s_sh, in_q [nd]; tab, the device layout of
// build_bf16_tables' mbig (ops/bconv_fused.py::mma_table, [32 ceil(m_out /
// 8), 32 ceil((nd + center) / 8) + 16] bytes, 16-byte aligned), and
// horner_sh [m_out]; out_q [m_out]; nd + center <= 32; batch <= 65535.
int hk_bconv(const void* x, void* out, const void* s, const void* s_sh,
             const void* in_q, const void* tab, const void* hsh,
             const void* out_q, int nd, int center, int m_out,
             long long ncoef, int batch, long long x_bstride,
             long long out_bstride, void* stream) {
  if (nd < 1 || m_out < 1 || ncoef < 1 || (center != 0 && center != 1) ||
      nd + center > kMaxNd || batch < 1 || batch > 65535 ||
      (batch > 1 && (x_bstride < nd * ncoef || out_bstride < m_out * ncoef)))
    return cudaErrorInvalidValue;
  return with_ks(nd + center, [&](auto ks) {
    return launch(bconv_kernel<decltype(ks)::value>, nd + center, m_out, x,
                  ncoef, batch, x_bstride, out_bstride,
                  static_cast<cudaStream_t>(stream),
                  static_cast<uint32_t*>(out),
                  static_cast<const uint32_t*>(s),
                  static_cast<const uint32_t*>(s_sh),
                  static_cast<const uint32_t*>(in_q),
                  static_cast<const uint8_t*>(tab),
                  static_cast<const uint32_t*>(hsh),
                  static_cast<const uint32_t*>(out_q), nd, center, m_out);
  });
}

// B5: xhat [nd, ncoef] (any uint32 words; the count row, if any, last) ->
// out [m_out, ncoef]; tab, the device layout of the step-2 matrix's
// build_bf16_tables table ([32 ceil(m_out / 8), 32 ceil(nd / 8) + 16]
// bytes, 16-byte aligned), horner_sh and out_q [m_out]; nd <= 32.
int hk_bconv_step2(const void* xhat, void* out, const void* tab,
                   const void* hsh, const void* out_q, int nd, int m_out,
                   long long ncoef, void* stream) {
  if (nd < 1 || nd > kMaxNd || m_out < 1 || ncoef < 1)
    return cudaErrorInvalidValue;
  return with_ks(nd, [&](auto ks) {
    return launch(bconv_step2_kernel<decltype(ks)::value>, nd, m_out, xhat,
                  ncoef, 1, 0, 0, static_cast<cudaStream_t>(stream),
                  static_cast<uint32_t*>(out),
                  static_cast<const uint8_t*>(tab),
                  static_cast<const uint32_t*>(hsh),
                  static_cast<const uint32_t*>(out_q), nd, m_out);
  });
}

}  // extern "C"
