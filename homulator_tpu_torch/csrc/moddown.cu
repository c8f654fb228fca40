// ModDown's elementwise steps (kernels B19-B21) for Hopper (sm_90a).
//
// Replace no Pallas kernel: the JAX package leaves these steps
// (homulator_tpu/ops/keyswitch.py::moddown_rescale, ::moddown_pair) to
// XLA, which fuses them on the TPU; PyTorch ran them eagerly as int64 ops
// over the whole [B, 2, rows, n2, n1] block, about a hundred launches an
// hmult. They sit between the port's kernels of the key switch's last
// phase (ops/keyswitch.py; P the product of the alpha special primes p_j,
// q_last the dropped limb's prime):
//
//   B2 on the specials: b = iNTT(acc_sp)
//   B19 md_zl    zl = acc_main[lm1] + P * d[lm1] mod q_last    (eval tile)
//   B2 on zl (one limb)
//   B20 md_head  bhat_j = b_j * [(P/p_j)^-1]_{p_j} mod p_j,
//                v = #{j : bhat_j >= (p_j >> 1) + 1},
//                conv = sum_j bhat_j [P/p_j]_{q_last} + v [-P]_{q_last},
//                w = (zl - conv) * P^-1 mod q_last, ind = [w >= (q_last >>
//                1) + 1]: rows bhat, v, w, ind of B3's input
//   B3 on those alpha + 3 rows (the tail table), B1 on its output e
//   B21 md_tail  out_i = (acc_main_i + P d_i - e_i) (P q_last)^-1 mod q_i
//
// md_zl and md_head run only in the hmult's merged ModDown + rescale
// (moddown_rescale2); a rotation's ModDown pair (moddown_pair2) runs B2,
// B3 with the centered ModDown table, B1 and md_tail without the P d term
// and with P^-1. Every output is the canonical residue, so each kernel
// equals its plain version (homulator_tpu_torch/ops/moddown.py) bit for
// bit, both centerings (v, ind) included.
//
// What bounds them on the card: bytes. At parameter set B (N = 2^16,
// alpha 15, level 35) a batch of 8 hmults' md_head reads 2 x 8 x 16 rows
// and writes 2 x 8 x 18 (71 MB, 21 us at 3.35 TB/s), md_tail reads
// acc_main and e as int32 and d as int64 (2 x 8 x 34 rows of each) and
// writes 2 x 8 x 34 int32 rows (357 MB, 0.11 ms). Their int32 work, a few
// Shoup products a word, is far below that. So each word crosses device
// memory once: a thread owns 4 consecutive words of a row as 16-byte
// vectors (int64 d as two), md_head loops over the alpha rows at its
// position with the q_last sum in registers (lazy in [0, 2 q_last), one
// conditional subtract a term), and no intermediate is stored. Per-row
// constants are read from the context's small tables (each warp reads one
// word: a broadcast). Shoup products are lazy ([0, 2q) for any uint32
// input) with one conditional subtract at the end; every sum stays below
// 4q < 2^32, every prime being below 2^32 / 6 (numtheory.PRIME_CAP).
//
// The work is elementwise over each row's words (the plane), so the
// shapes come from the wrapper: the batch, alpha, the rows, the plane (a
// coefficient-sharded shard's [R, C/ns] tile is a narrower plane).

#include <cuda_runtime.h>

#include <cstdint>

#include "modarith.cuh"

namespace {

using hk::csub;
using hk::shoup_mul_lazy;

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t shoup(uint32_t a, uint32_t w,
                                          uint32_t w_sh, uint32_t q) {
  return csub(shoup_mul_lazy(a, w, w_sh, q), q);
}

// 4 words of a uint32 row, or the low words of 4 int64 residues (d).
template <bool kI64>
__device__ __forceinline__ uint4 load4(const void* p, long long i) {
  if constexpr (kI64) {
    const longlong2* v = reinterpret_cast<const longlong2*>(
        static_cast<const long long*>(p) + i);
    const longlong2 a = v[0], b = v[1];
    return make_uint4((uint32_t)a.x, (uint32_t)a.y, (uint32_t)b.x,
                      (uint32_t)b.y);
  } else {
    return *reinterpret_cast<const uint4*>(static_cast<const uint32_t*>(p) +
                                           i);
  }
}

// Word i of a vector (i a constant of an unrolled loop).
__device__ __forceinline__ uint32_t& at(uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t at(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// B19. Row y = 2 b + k of zl [2 batch, plane]: acc_k's and d_k's (int64)
// row lm1 of element b (the pointers already at row lm1; elements acc_bs,
// d_bs words apart). q, pm, pm_sh: q_last and [P]_{q_last}'s Shoup pair.
__global__ void __launch_bounds__(kThreads)
md_zl_kernel(const uint32_t* __restrict__ acc0,
             const uint32_t* __restrict__ acc1, long long acc_bs,
             const void* __restrict__ d0, const void* __restrict__ d1,
             long long d_bs, uint32_t* __restrict__ zl,
             const uint32_t* __restrict__ q, const uint32_t* __restrict__ pm,
             const uint32_t* __restrict__ pm_sh, long long plane) {
  const long long w = 4 * ((long long)blockIdx.x * kThreads + threadIdx.x);
  if (w >= plane) return;
  const int b = blockIdx.y >> 1, k = blockIdx.y & 1;
  const uint32_t ql = *q, m = *pm, m_sh = *pm_sh;
  const uint4 a = load4<false>(k ? acc1 : acc0, b * acc_bs + w);
  const uint4 d = load4<true>(k ? d1 : d0, b * d_bs + w);
  uint4 r;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    at(r, i) = csub(at(a, i) + shoup(at(d, i), m, m_sh, ql), ql);
  *reinterpret_cast<uint4*>(zl + blockIdx.y * plane + w) = r;
}

// B20. Row y = 2 b + k: b [2 batch, alpha, plane] (coeff, from B2), zl
// [2 batch, plane] (coeff, from B2) -> out [2 batch, alpha + 3, plane]:
// rows bhat_0 .. bhat_{alpha-1}, v, w, ind. sp_q, s1, s1_sh [alpha]; m2,
// m2_sh [alpha + 1] ([P/p_j]_{q_last} and the centering entry); q, pinv,
// pinv_sh: q_last and [P^-1]_{q_last}'s Shoup pair.
__global__ void __launch_bounds__(kThreads)
md_head_kernel(const uint32_t* __restrict__ bc,
               const uint32_t* __restrict__ zl, uint32_t* __restrict__ out,
               const uint32_t* __restrict__ sp_q,
               const uint32_t* __restrict__ s1,
               const uint32_t* __restrict__ s1_sh,
               const uint32_t* __restrict__ m2,
               const uint32_t* __restrict__ m2_sh,
               const uint32_t* __restrict__ q,
               const uint32_t* __restrict__ pinv,
               const uint32_t* __restrict__ pinv_sh, int alpha,
               long long plane) {
  const long long w = 4 * ((long long)blockIdx.x * kThreads + threadIdx.x);
  if (w >= plane) return;
  const uint32_t ql = *q, ql2 = 2 * ql;
  const uint32_t* x = bc + (long long)blockIdx.y * alpha * plane + w;
  uint32_t* o = out + (long long)blockIdx.y * (alpha + 3) * plane + w;
  uint4 v = make_uint4(0, 0, 0, 0), conv = v;
  for (int j = 0; j < alpha; ++j) {
    const uint32_t p = sp_q[j], half = (p >> 1) + 1, s = s1[j],
                   s_sh = s1_sh[j], c = m2[j], c_sh = m2_sh[j];
    const uint4 xj = *reinterpret_cast<const uint4*>(x + j * plane);
    uint4 bh;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      at(bh, i) = shoup(at(xj, i), s, s_sh, p);
      at(v, i) += at(bh, i) >= half;
      at(conv, i) = csub(at(conv, i) + shoup_mul_lazy(at(bh, i), c, c_sh, ql),
                         ql2);
    }
    *reinterpret_cast<uint4*>(o + j * plane) = bh;
  }
  *reinterpret_cast<uint4*>(o + alpha * plane) = v;
  const uint32_t c = m2[alpha], c_sh = m2_sh[alpha], pi = *pinv,
                 pi_sh = *pinv_sh, halfq = (ql >> 1) + 1;
  const uint4 z = *reinterpret_cast<const uint4*>(zl + blockIdx.y * plane +
                                                  w);
  uint4 ww, ind;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t cv = csub(
        csub(at(conv, i) + shoup_mul_lazy(at(v, i), c, c_sh, ql), ql2), ql);
    at(ww, i) = shoup(at(z, i) + ql - cv, pi, pi_sh, ql);
    at(ind, i) = at(ww, i) >= halfq;
  }
  *reinterpret_cast<uint4*>(o + (alpha + 1) * plane) = ww;
  *reinterpret_cast<uint4*>(o + (alpha + 2) * plane) = ind;
}

// B21. Element z = b rep + k, row i = blockIdx.y: out[z, i] = (acc_k[b,
// i] (+ P_i d_k[b, i]) - e[z, i]) c_i mod q_i, for e and out [batch rep,
// rows, plane] and acc_k, d_k rows contiguous within an element (elements
// acc_bs, d_bs words apart; d int64, read when kD). pm, pm_sh: [P]_{q_i}'s
// Shoup pairs (kD); c, c_sh: the final factor's.
template <bool kD>
__global__ void __launch_bounds__(kThreads)
md_tail_kernel(const uint32_t* __restrict__ acc0,
               const uint32_t* __restrict__ acc1, long long acc_bs,
               const void* __restrict__ d0, const void* __restrict__ d1,
               long long d_bs, const uint32_t* __restrict__ e,
               uint32_t* __restrict__ out, const uint32_t* __restrict__ q,
               const uint32_t* __restrict__ pm,
               const uint32_t* __restrict__ pm_sh,
               const uint32_t* __restrict__ c,
               const uint32_t* __restrict__ c_sh, int rep, int rows,
               long long plane) {
  const long long w = 4 * ((long long)blockIdx.x * kThreads + threadIdx.x);
  if (w >= plane) return;
  const int i = blockIdx.y, b = blockIdx.z / rep, k = blockIdx.z % rep;
  const uint32_t qi = q[i], ci = c[i], ci_sh = c_sh[i];
  const long long row = (long long)i * plane + w;
  uint4 a = load4<false>(k ? acc1 : acc0, b * acc_bs + row);
  if constexpr (kD) {
    const uint32_t m = pm[i], m_sh = pm_sh[i];
    const uint4 d = load4<true>(k ? d1 : d0, b * d_bs + row);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      at(a, j) = csub(at(a, j) + shoup(at(d, j), m, m_sh, qi), qi);
  }
  const long long eo = (long long)blockIdx.z * rows * plane + row;
  const uint4 ev = *reinterpret_cast<const uint4*>(e + eo);
  uint4 r;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    at(r, j) = shoup(at(a, j) + qi - at(ev, j), ci, ci_sh, qi);
  *reinterpret_cast<uint4*>(out + eo) = r;
}

unsigned blocks_of(long long plane) {
  return (unsigned)((plane / 4 + kThreads - 1) / kThreads);
}

bool bad_plane(long long plane) {
  return plane < 4 || plane % 4 || plane / 4 / kThreads >= 0x7fffffffLL;
}

}  // namespace

extern "C" {

// B19: acc0/acc1 uint32 and d0/d1 int64 at row lm1 of element 0; zl [2
// batch, plane]; q, pm, pm_sh single words (device).
int hk_md_zl(const void* acc0, const void* acc1, long long acc_bs,
             const void* d0, const void* d1, long long d_bs, void* zl,
             const void* q, const void* pm, const void* pm_sh,
             long long plane, int batch, void* stream) {
  if (bad_plane(plane) || batch < 1 || 2 * batch > 65535)
    return cudaErrorInvalidValue;
  auto u = [](const void* p) { return static_cast<const uint32_t*>(p); };
  md_zl_kernel<<<dim3(blocks_of(plane), 2 * batch), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      u(acc0), u(acc1), acc_bs, d0, d1, d_bs, static_cast<uint32_t*>(zl),
      u(q), u(pm), u(pm_sh), plane);
  return (int)cudaGetLastError();
}

// B20: b [2 batch, alpha, plane], zl [2 batch, plane] -> out [2 batch,
// alpha + 3, plane]; the constants as md_head_kernel takes them.
int hk_md_head(const void* b, const void* zl, void* out, const void* sp_q,
               const void* s1, const void* s1_sh, const void* m2,
               const void* m2_sh, const void* q, const void* pinv,
               const void* pinv_sh, int alpha, long long plane, int batch,
               void* stream) {
  if (bad_plane(plane) || alpha < 1 || batch < 1 || 2 * batch > 65535)
    return cudaErrorInvalidValue;
  auto u = [](const void* p) { return static_cast<const uint32_t*>(p); };
  md_head_kernel<<<dim3(blocks_of(plane), 2 * batch), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      u(b), u(zl), static_cast<uint32_t*>(out), u(sp_q), u(s1), u(s1_sh),
      u(m2), u(m2_sh), u(q), u(pinv), u(pinv_sh), alpha, plane);
  return (int)cudaGetLastError();
}

// B21: acc0 (acc1 when rep is 2) uint32 and, when with_d, d0/d1 int64, at
// row 0 of element 0; e, out [batch rep, rows, plane]; q, c, c_sh [rows],
// pm, pm_sh [rows] when with_d.
int hk_md_tail(const void* acc0, const void* acc1, long long acc_bs,
               const void* d0, const void* d1, long long d_bs, int with_d,
               const void* e, void* out, const void* q, const void* pm,
               const void* pm_sh, const void* c, const void* c_sh, int rep,
               int rows, long long plane, int batch, void* stream) {
  if (bad_plane(plane) || rep < 1 || rep > 2 || rows < 1 || rows > 65535 ||
      batch < 1 || batch * rep > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(blocks_of(plane), rows, batch * rep);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto u = [](const void* p) { return static_cast<const uint32_t*>(p); };
  auto go = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, st>>>(
        u(acc0), u(acc1 ? acc1 : acc0), acc_bs, d0, d1, d_bs, u(e),
        static_cast<uint32_t*>(out), u(q), u(pm), u(pm_sh), u(c), u(c_sh),
        rep, rows, plane);
  };
  if (with_d) go(md_tail_kernel<true>);
  else go(md_tail_kernel<false>);
  return (int)cudaGetLastError();
}

}  // extern "C"
