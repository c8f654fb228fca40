// The byte-plane product of the base conversion on Hopper's tensor cores:
// the core shared by kernels B3 and B5 (csrc/bconv.cu: the whole
// conversion, and its step 2 on rows already scaled) and kernel B17
// (csrc/bconv_mma.cu, the product alone).
//
// B3 and B17 replace a TPU kernel that splits each input word into four
// byte planes and contracts them with a table of bytes in ONE bf16 matmul
// (homulator_tpu/ops/bconv_fused.py:1-27, 72-110); B5 replaces one that
// sums Shoup products (bconv_pallas.py) and runs this product too, on the
// same tables. For x [nd, ncoef]
// (32-bit words xh_t) and the table mbig [4 m_out, 4 nd] of
// build_bf16_tables (row i*m_out + j, column p*nd + t holds byte i of
// mat[j, t] * 2^(8p) mod q_j, an integer in [0, 256)), the plane sums are
//
//   D_i[j, c] = sum_{p, t} mbig[i*m_out + j, p*nd + t] * byte_p(xh_t[c])
//
// and sum_i 2^(8i) D_i[j, c] = sum_t mat[j, t] * xh_t[c] (mod q_j).
//
// The form used here: u8 x u8 -> s32 (mma.sync m16n8k32, integer
// tensor-core products, twice the bf16 rate). Exactness is by
// construction: every product of two bytes is below 2^16 and exact in s32,
// and a sum has 4 nd <= 128 of them, so D_i < 4 nd 255^2 <= 8,323,200 <
// 2^23 at nd <= 32 (build_bf16_tables' bound): no s32 sum can wrap,
// whatever the order in which the tensor core adds. There is no float
// rounding and no conversion back to integers.
// tests/test_torch_bconv_mma.py asserts these margins on the worst case
// (every byte 255, nd 32) and models this schedule bit for bit.
//
// The K axis is ordered k = 4 t + p (input row t, byte plane p). In the
// m16n8k32 A fragment a thread holds four consecutive k of one row as one
// 32-bit register, lowest k in the lowest byte: that register is the word
// xh_t itself. So the byte planes cost no instruction at all.
//
// Orientation: M = 16 coefficients, N = 8 output rows of one plane, K = 32
// (8 input rows). A warp tile is 32 coefficients (two m16 tiles), all
// 8 KS input rows (KS = ceil(nd / 8) k32 steps). Per block of 8 output
// rows (jb) a warp runs the four planes' n8 tiles, so each thread ends
// with D_0..D_3 of the same (j, c) in its accumulators (C fragment: rows
// g, g+8 of the m16 tile, columns 2 tig, 2 tig + 1 of the n8 tile) and the
// epilogue runs in registers; D never leaves them.
//
// Shared memory, per block of 8 warps:
//  - x tiles: every warp double-buffers its own [8 KS, 32] tile of x with
//    16-byte cp.async (4-byte where ncoef or x is not 16-byte aligned),
//    zero-filled past ncoef, so tile n + 1's loads fly while tile n's
//    products and stores run. Rows are kXStride = 40 words apart, which
//    keeps the fragment reads free of bank conflicts.
//  - the table in the device layout: row R = (jb * 4 + i) * 8 + r (output
//    j = 8 jb + r, plane i), byte k = 4 t + p, zero where j >= m_out or
//    t >= nd (ops/bconv_fused.py::mma_table builds it from mbig). Rows are
//    32 KS + 16 bytes apart, so each ldmatrix phase (8 rows of 16 bytes) is
//    free of bank conflicts; ldmatrix.x4 gives a thread the B fragments
//    (bytes 4 tig .. 4 tig + 3 of row g) of two planes at one k32 step. It
//    is staged once a block with 16-byte cp.async, all of it in flight at
//    once beside the first x tile: B3 and B5 copy the layout that their
//    context built once on the host; B17, whose caller hands it mbig, copies mbig
//    as it is and rewrites it into the layout in shared memory.
//  - the kernel's per-row constants (B3: the step-1 Shoup pair, q and the
//    centering threshold of every input row; q and horner_sh of every
//    output row; B5: the output rows' only).
//
// Blocks are persistent: the grid is the number of blocks that fit on the
// card at once (two per SM; fewer where there are fewer tiles), and warp w
// of the grid walks tiles w, w + W, ... (W warps in the grid). At ncoef =
// 2^16 that is 256 blocks and one tile a warp, at 2^14 (a 4-shard slice)
// 64 blocks; the double buffer overlaps loads and stores only from two
// tiles a warp on.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace hk {
namespace planes {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 32;            // coefficients of a warp tile
constexpr int kXStride = kCols + 8;  // words between staged x rows
constexpr int kTabPad = 16;          // bytes after each staged table row
constexpr int kMaxNd = 32;           // table columns / 4 (build_bf16_tables)
constexpr int kBlocksPerSm = 2;

// Shared-memory layout of a launch, in this order (bytes): the warps' x
// buffers, the table in the device layout, mbig as it is (raw: B17 only),
// the kernel's constants (B3 and B5: a uint4 per input row, used by B3
// only, and a uint2 per output row).
struct Layout {
  int nd, m_out, raw;
  int ks, jb;  // k32 steps, blocks of 8 output rows
  __host__ __device__ Layout(int nd_, int m_out_, int raw_)
      : nd(nd_), m_out(m_out_), raw(raw_), ks((nd_ + 7) / 8),
        jb((m_out_ + 7) / 8) {}
  __host__ __device__ int tab_stride() const { return 32 * ks + kTabPad; }
  __host__ __device__ int x_words() const { return 8 * ks * kXStride; }
  __host__ __device__ size_t x_bytes() const {
    return (size_t)kWarps * 2 * x_words() * 4;
  }
  __host__ __device__ size_t tab_bytes() const {
    return (size_t)jb * 32 * tab_stride();
  }
  __host__ __device__ size_t raw_bytes() const {  // a multiple of 32
    return raw ? (size_t)32 * m_out * nd : 0;
  }
  __host__ __device__ size_t const_offset() const {
    return x_bytes() + tab_bytes() + raw_bytes();
  }
  __host__ __device__ size_t bytes() const {
    return const_offset() + (size_t)8 * ks * 16 + (size_t)jb * 8 * 8;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d = a * b (first) or d += a * b over one m16n8k32 tile, u8 x u8 -> s32;
// first is known where the caller's loop is unrolled. volatile: the planes
// a caller does not store (B17's D_1..D_3) are still computed.
__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1, bool first) {
  if (first) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "r"(0));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// Rewrite mbig (bf16 [4 m_out, 4 nd], integers in [0, 256), staged as it
// is in raw) into the device layout: word t of row R = (jb * 4 + i) * 8 + r
// packs the bytes k = 4 t + p, p = 0..3, each mbig[i * m_out + j,
// p * nd + t] (0 where j >= m_out or t >= nd). Consecutive threads take
// consecutive words, four at once so that their loads overlap. A value
// v < 256 is exact in bf16, and v + 256 in float has v in its mantissa
// bits 15..22.
__device__ __forceinline__ void convert_table(uint8_t* tab,
                                              const uint16_t* raw,
                                              const Layout& lay) {
  const int nd = lay.nd, m_out = lay.m_out;
  const int words = 8 * lay.ks, ts = lay.tab_stride();
  const int total = lay.jb * 32 * words;
  for (int base = threadIdx.x; base < total; base += 4 * blockDim.x) {
    uint32_t w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = base + u * blockDim.x;
      const int R = idx / words, t = idx - R * words;
      const int r = R & 7, i = (R >> 3) & 3, j = (R >> 5) * 8 + r;
      w[u] = 0;
      if (idx < total && j < m_out && t < nd) {
        const uint16_t* row = raw + (i * m_out + j) * 4 * nd + t;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float v = __uint_as_float((uint32_t)row[p * nd] << 16);
          w[u] |= ((__float_as_uint(v + 256.0f) >> 15) & 255u) << (8 * p);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = base + u * blockDim.x;
      const int R = idx / words;
      if (idx < total)
        *reinterpret_cast<uint32_t*>(tab + R * ts + 4 * (idx - R * words)) =
            w[u];
    }
  }
}

// The shared schedule. Op supplies the kernel's own parts:
//   void stage(): stages the kernel's constants; run calls it with the
//     first x tile and mbig in flight, then waits for the whole block;
//   uint32_t input(int t, uint32_t x, uint32_t& cnt): the word xh_t that
//     enters the product for staged input x of row t (0 for rows past the
//     table's; staged rows past nd_in hold no data); adds 1 to cnt when
//     xh_t counts toward the centering row;
//   void count(uint32_t (&a)[2][KS][4], const uint32_t (&cnt)[2][2]):
//     puts the count row (B3 with centering) into the A fragments;
//   void store(int jb, const int (&d)[2][4][4], long long c0, bool full):
//     the epilogue of output rows 8 jb .. 8 jb + 7 of the warp tile at c0
//     (full: all its 32 columns lie below ncoef), d[mt][plane][e] the C
//     fragments.
// Every thread of the block calls run; x is [nd_in, ncoef]; table, 16-byte
// aligned, is mbig (lay.raw) or the device layout.
template <int KS, class Op>
__device__ __forceinline__ void run(Op& op, const uint32_t* __restrict__ x,
                                    const uint8_t* __restrict__ table,
                                    int nd_in, long long ncoef, int vec,
                                    uint8_t* smem, const Layout& lay) {
  uint32_t* xbuf = reinterpret_cast<uint32_t*>(smem);
  uint8_t* tab = smem + lay.x_bytes();
  uint16_t* raw = reinterpret_cast<uint16_t*>(tab + lay.tab_bytes());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const long long ntiles = (ncoef + kCols - 1) / kCols;
  const long long wstride = (long long)gridDim.x * kWarps;
  uint32_t* mine = xbuf + warp * 2 * lay.x_words();

  auto prefetch = [&](long long tile, int buf) {
    const long long c0 = tile * kCols;
    uint32_t* dst = mine + buf * lay.x_words();
    if (vec) {  // 8 chunks of 16 bytes a row; ncoef % 4 == 0
      for (int id = lane; id < nd_in * 8; id += 32) {
        const int t = id >> 3, ch = id & 7;
        const long long c = c0 + 4 * ch;
        const bool in = c < ncoef;
        cp_async16(smem_addr(dst + t * kXStride + 4 * ch),
                   in ? x + t * ncoef + c : x, in ? 16 : 0);
      }
    } else {
      const long long c = c0 + lane;
      const bool in = c < ncoef;
      for (int t = 0; t < nd_in; ++t)
        cp_async4(smem_addr(dst + t * kXStride + lane),
                  in ? x + t * ncoef + c : x, in ? 4 : 0);
    }
    cp_async_commit();
  };

  long long tile = (long long)blockIdx.x * kWarps + warp;
  if (tile < ntiles) prefetch(tile, 0);
  uint8_t* dst = lay.raw ? reinterpret_cast<uint8_t*>(raw) : tab;
  const int chunks = (int)((lay.raw ? lay.raw_bytes() : lay.tab_bytes()) / 16);
  for (int i = threadIdx.x; i < chunks; i += blockDim.x)
    cp_async16(smem_addr(dst + 16 * i), table + 16 * i, 16);
  cp_async_commit();
  op.stage();
  cp_async_wait<0>();
  __syncthreads();
  if (lay.raw) {
    convert_table(tab, raw, lay);
    __syncthreads();
  }

  const uint32_t tab_base = smem_addr(tab);
  const int ts = lay.tab_stride();
  // ldmatrix.x4: lanes 8m .. 8m + 7 address matrix m = (plane 2ip + m/2,
  // k half m % 2), one table row each
  const uint32_t lane_row =
      tab_base + (((lane >> 4) * 8 + (lane & 7)) * ts) + 16 * ((lane >> 3) & 1);
  for (int it = 0; tile < ntiles; tile += wstride, ++it) {
    const int buf = it & 1;
    if (tile + wstride < ntiles) {
      prefetch(tile + wstride, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const uint32_t* xs = mine + buf * lay.x_words();
    // A fragments: a[mt][ks] = {(t0, c), (t0, c + 8), (t0 + 4, c),
    // (t0 + 4, c + 8)}, t0 = 8 ks + tig, c = 16 mt + g
    uint32_t a[2][KS][4];
    uint32_t cnt[2][2] = {{0, 0}, {0, 0}};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int t = 8 * ks + 4 * h2 + tig;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            a[mt][ks][h + 2 * h2] =
                op.input(t, xs[t * kXStride + 16 * mt + 8 * h + g],
                         cnt[mt][h]);
        }
      }
    }
    __syncwarp();  // every lane has read buf before it is refilled
    op.count(a, cnt);
    const long long c0 = tile * kCols;
    const bool full = c0 + kCols <= ncoef;
    for (int jb = 0; jb < lay.jb; ++jb) {
      int d[2][4][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int ip = 0; ip < 2; ++ip) {
          uint32_t b[4];
          ldmatrix_x4(b, lane_row + (jb * 4 + 2 * ip) * 8 * ts + 32 * ks);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_u8(d[mt][2 * ip], a[mt][ks], b[0], b[1], ks == 0);
            mma_u8(d[mt][2 * ip + 1], a[mt][ks], b[2], b[3], ks == 0);
          }
        }
      }
      op.store(jb, d, c0, full);
    }
  }
}

// Grid of a launch, per element of a batch of `batch` (the grid's z
// extent): the blocks that fit on the card at once shared out over the
// batch (at least one an element), fewer where there are fewer warp tiles.
inline int grid_blocks(long long ncoef, size_t smem, int batch = 1) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // 228 KB of shared memory an SM, 1 KB of it reserved a block
  const int fit = (int)(233472 / (smem + 1024));
  long long cap = (long long)sms * (fit < kBlocksPerSm ? fit : kBlocksPerSm);
  cap = cap / batch > 0 ? cap / batch : 1;
  const long long want = ((ncoef + kCols - 1) / kCols + kWarps - 1) / kWarps;
  return (int)(want < cap ? want : cap);
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace planes
}  // namespace hk
