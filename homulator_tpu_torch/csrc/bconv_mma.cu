// The base conversion's bf16-plane product on tensor cores (kernel B17),
// for Hopper (sm_90a).
//
// Replaces: scripts/roofline.py::main._mm_kernel, the matmul of
// homulator_tpu/ops/bconv_fused.py alone (no step 1, no pairing epilogue).
// For x [nd, ncoef] uint32 (a ModUp digit's rows with a zero row
// appended, nd <= 32) and the table mbig [4*m_out, 4*nd] bf16 of
// build_bf16_tables (ops/bconv_fused.py):
//
//   planes[k*nd + t, j] = byte k of x[t, j]            (k = 0..3)
//   D = mbig @ planes  (f32 accumulation)   out[r, j] = D[r, j], r < m_out
//
// Rows [:m_out] are D_0, the plane-0 sums. Every plane entry is < 256 and
// every table entry a byte, both exact in bf16; each sum is below
// 4 * nd * 255^2 < 2^24, which f32 holds exactly, whatever the order of
// summation (bconv_fused.py:20-24). So the output is exact and equals the
// float64 plain version bit for bit.
//
// Design: mma.sync.aligned.m16n8k16 (bf16 in, f32 accumulate), through
// inline PTX. A block of 8 warps takes 256 coefficients: it stages mbig
// (zero-padded to [mp, kp], multiples of 16, rows 16 bytes apart more than
// kp to spread the banks) and its [nd, 256] slice of x in shared memory.
// Each warp owns 32 coefficients (four n8 tiles): it builds the B
// fragments of all k16 steps once, extracting each byte plane from x with
// a table of (row, shift) per k, then walks the m16 tiles, loading the A
// fragments from shared memory. As the TPU kernel, it computes all
// 4 * m_out rows and stores the first m_out: the asm is volatile, so the
// products of the dropped rows are issued, not optimised away.
//
// What bounds it on the card: the bytes (x read once, D_0 written once:
// 4 * (nd + m_out) * ncoef) at set B's digit 0 (nd = 16, m_out = 35):
// 13.4 MB, 4.0 us at 3.35 TB/s, against 1.17 GFLOP of bf16 products (1.2
// us at 989 TFLOP/s).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpCols = 32;                  // four n8 tiles a warp
constexpr int kBlockCols = kWarpCols * kWarps;  // 256 coefficients
constexpr int kNt = kWarpCols / 8;
constexpr int kXPad = 4;  // x rows 260 words apart: no bank conflicts

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16 bits of an integer below 256: the top half of its f32 bits (exact,
// since it has at most 8 significant bits).
__device__ __forceinline__ uint32_t byte_bf16(uint32_t v) {
  return __float_as_uint(static_cast<float>(v)) >> 16;
}

// KS: k16 steps a warp keeps B fragments for (kp / 16 <= KS).
template <int KS>
__global__ void __launch_bounds__(kThreads)
planes_mm(const uint32_t* __restrict__ x, const uint16_t* __restrict__ mbig,
          uint32_t* __restrict__ out, int nd, int mrows, int m_out,
          long long ncoef) {
  extern __shared__ uint32_t smem[];
  const int kc = 4 * nd;
  const int kp = (kc + 15) & ~15, mp = (mrows + 15) & ~15;
  const int lda = kp + 8;  // bf16 units
  const int ldx = kBlockCols + kXPad;
  uint16_t* sa = reinterpret_cast<uint16_t*>(smem);
  uint32_t* sx = smem + (mp * lda + 1) / 2;
  int* ktab = reinterpret_cast<int*>(sx + nd * ldx);
  const long long col0 = (long long)blockIdx.x * kBlockCols;

  for (int i = threadIdx.x; i < mp * kp; i += kThreads) {
    const int r = i / kp, k = i % kp;
    sa[r * lda + k] = (r < mrows && k < kc) ? mbig[r * kc + k] : 0;
  }
  for (int i = threadIdx.x; i < nd * kBlockCols; i += kThreads) {
    const int t = i / kBlockCols, c = i % kBlockCols;
    sx[t * ldx + c] = x[t * ncoef + col0 + c];
  }
  for (int k = threadIdx.x; k < kp; k += kThreads)  // (row t, shift 8 * plane)
    ktab[k] = k < kc ? ((k % nd) | ((8 * (k / nd)) << 16)) : -1;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wc = warp * kWarpCols;
  uint32_t b[KS][kNt][2];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // k = 16 ks + 8 h + 2 tig + e
      const int k = 16 * ks + 8 * h + 2 * tig;
      const int e0 = ks * 16 < kp ? ktab[k] : -1;
      const int e1 = ks * 16 < kp ? ktab[k + 1] : -1;
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        const int c = wc + nt * 8 + g;
        const uint32_t v0 =
            e0 < 0 ? 0 : (sx[(e0 & 0xFFFF) * ldx + c] >> (e0 >> 16)) & 255u;
        const uint32_t v1 =
            e1 < 0 ? 0 : (sx[(e1 & 0xFFFF) * ldx + c] >> (e1 >> 16)) & 255u;
        b[ks][nt][h] = byte_bf16(v0) | (byte_bf16(v1) << 16);
      }
    }
  }

  const uint32_t* sa32 = reinterpret_cast<const uint32_t*>(sa);
  const int lda32 = lda / 2;
  for (int mt = 0; mt < mp / 16; ++mt) {
    float acc[kNt][4] = {};
    const int r0 = mt * 16 + g;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (ks * 16 >= kp) break;
      const int kw = ks * 8 + tig;  // word of k = 16 ks + 2 tig
      const uint32_t a[4] = {sa32[r0 * lda32 + kw],
                             sa32[(r0 + 8) * lda32 + kw],
                             sa32[r0 * lda32 + kw + 4],
                             sa32[(r0 + 8) * lda32 + kw + 4]};
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
        mma_bf16(acc[nt], a, b[ks][nt][0], b[ks][nt][1]);
    }
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      const long long c = col0 + wc + nt * 8 + 2 * tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows r0 and r0 + 8
        const int r = r0 + 8 * h;
        if (r < m_out) {
          out[r * ncoef + c] =
              static_cast<uint32_t>(__float2int_rn(acc[nt][2 * h]));
          out[r * ncoef + c + 1] =
              static_cast<uint32_t>(__float2int_rn(acc[nt][2 * h + 1]));
        }
      }
    }
  }
}

template <int KS>
int launch(const void* x, const void* mbig, void* out, int nd, int m_out,
           long long ncoef, void* stream) {
  const int mrows = 4 * m_out, kc = 4 * nd;
  const int kp = (kc + 15) & ~15, mp = (mrows + 15) & ~15;
  const size_t smem = ((size_t)mp * (kp + 8) + 1) / 2 * 4 +
                      (size_t)nd * (kBlockCols + kXPad) * 4 + (size_t)kp * 4;
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(planes_mm<KS>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  planes_mm<KS><<<(unsigned)(ncoef / kBlockCols), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint16_t*>(mbig),
      static_cast<uint32_t*>(out), nd, mrows, m_out, ncoef);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [nd, ncoef] uint32, mbig [4*m_out, 4*nd] bf16 -> out [m_out, ncoef]:
// nd in [1, 32], m_out in [1, 64], ncoef a positive multiple of 256.
int hk_bconv_planes_mm(const void* x, const void* mbig, void* out, int nd,
                       int m_out, long long ncoef, void* stream) {
  if (nd < 1 || nd > 32 || m_out < 1 || m_out > 64 || ncoef <= 0 ||
      ncoef % kBlockCols != 0)
    return cudaErrorInvalidValue;
  if (4 * nd <= 64) return launch<4>(x, mbig, out, nd, m_out, ncoef, stream);
  return launch<8>(x, mbig, out, nd, m_out, ncoef, stream);
}

}  // extern "C"
