// Hopper's bfloat16 tensor cores through `mma.sync.m16n8k16`: bfloat16 tiles
// staged in shared memory by 16-byte `cp.async`, fragments loaded by
// `ldmatrix` (`.trans` for an operand whose k runs along a tile's rows), and
// float32 accumulators, and the pre-scaling pass of the backward bodies.
// Shared by the bfloat16 forward body of K1, K1-bias and K6
// (hstu_attention_fwd_bf16.cuh), the bfloat16 backward body of K2 and K4
// (hstu_attention_bwd_dkv_bf16.cuh), that of K3 (hstu_attention_bwd_dq_bf16.cuh)
// that of K7 and K7-det (hstu_attention_relbias_bwd_bf16.cuh) and the wide
// backward's (hstu_attention_wide.cuh).
//
// Every tile is [rows][pitch] bfloat16 with a pitch of its width + 8
// elements: 16 bytes more than a multiple of 64, so the eight 16-byte rows an
// `ldmatrix` reads at once fall on eight different bank groups.
//
// The fragments of m16n8k16 (g = lane / 4, t = lane % 4; each register two
// bfloat16, the lower k in the lower half):
//   A (16 x 16): a0 (row g, k 2t..2t+1), a1 (row g + 8, k 2t..), a2 (row g,
//                k 2t + 8..), a3 (row g + 8, k 2t + 8..)
//   B (16 x 8):  b0 (k 2t..2t+1, col g), b1 (k 2t + 8.., col g)
//   C (16 x 8):  c0, c1 (row g, cols 2t, 2t + 1), c2, c3 (row g + 8, ...)
// so the C fragments of two neighbouring 8-column tiles, rounded and packed
// in pairs, are the A fragment of the next product's 16-deep k-step (P of
// S = Q K^T as the A operand of P V, with no trip through shared memory).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace hstu_bf16 {

using bf16 = __nv_bfloat16;

// 16 bytes from global to shared memory without passing through registers,
// or 16 bytes of zeros where !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// Rows [r0, r0 + ROWS) of one head of a strided bfloat16 [.., N, H, w] tensor
// into a [ROWS][P] bfloat16 shared tile; zeros at rows >= lim and in the pad
// columns [w, W). vec (the pointer, the strides and w allow pieces of 8
// elements): by 16-byte `cp.async`, in place after the wait and the barrier
// that follow. Else element by element, synchronously: in place after the
// barrier that follows.
template <int W, int P, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long sn, int r0, int lim, int w,
                                          bool vec) {
  if (vec) {
    constexpr int C8 = W / 8;
    for (int idx = threadIdx.x; idx < ROWS * C8; idx += THREADS) {
      const int r = idx / C8, c = idx % C8 * 8;
      const bool ok = r0 + r < lim && c < w;
      cp_async16(dst + r * P + c, ok ? src + (long long)(r0 + r) * sn + c : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * W; idx += THREADS) {
      const int r = idx / W, c = idx % W;
      dst[r * P + c] = r0 + r < lim && c < w ? src[(long long)(r0 + r) * sn + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// Two floats as a pair of bfloat16 (each rounded to the nearest, ties to
// even), the first in the lower half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// The same rows as `load_rows`, each element x stored as bfloat16(x scale)
// (alpha q, the TPU kernels' bfloat16 product), synchronously
template <int W, int P, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows_scaled(bf16* dst, const bf16* src, long long sn, int r0, int lim,
                                                 int w, bool vec, float scale) {
  if (vec) {
    constexpr int C8 = W / 8;
    for (int idx = threadIdx.x; idx < ROWS * C8; idx += THREADS) {
      const int r = idx / C8, c = idx % C8 * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < lim && c < w) x = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * sn + c);
      uint32_t* e = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
      for (int i = 0; i < 4; ++i)  // a bfloat16 is the top half of the float32 of the same value
        e[i] = pack(__uint_as_float(e[i] << 16) * scale, __uint_as_float(e[i] & 0xffff0000u) * scale);
      *reinterpret_cast<uint4*>(dst + r * P + c) = x;
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * W; idx += THREADS) {
      const int r = idx / W, c = idx % W;
      const float x = r0 + r < lim && c < w ? __bfloat162float(src[(long long)(r0 + r) * sn + c]) : 0.f;
      dst[r * P + c] = __float2bfloat16_rn(x * scale);
    }
  }
}

// Four 8 x 8 bfloat16 matrices from shared memory, lane l giving the address
// of row l % 8 of matrix l / 8; register m holds row g, columns 2t, 2t + 1 of
// matrix m (`trans`: column g, rows 2t, 2t + 1)
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* at) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(at);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* at) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(at);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The lane's address for `ldsm` of a 16 x 16 A fragment of a [m][k] tile at
// (m0, k0): a0..a3 as m16n8k16 takes them
__device__ __forceinline__ const bf16* a_at(const bf16* X, int pitch, int m0, int k0) {
  const int lane = threadIdx.x & 31;
  return X + (m0 + (lane & 15)) * pitch + k0 + (lane >> 4) * 8;
}

// The lane's address for `ldsm` of the B fragments of two 8-column tiles
// (n0 and n0 + 8) of a tile stored [n][k], at k0: r0, r1 tile n0's b0, b1;
// r2, r3 tile n0 + 8's
__device__ __forceinline__ const bf16* b_nk_at(const bf16* X, int pitch, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  return X + (n0 + (lane & 7) + ((lane >> 4) << 3)) * pitch + k0 + ((lane >> 3) & 1) * 8;
}

// The lane's address for `ldsm_t` of the same two B fragments of a tile
// stored [k][n] (V in P V, dO and Q in dV and dK, K in dQ)
__device__ __forceinline__ const bf16* b_kn_at(const bf16* X, int pitch, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  return X + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * pitch + n0 + ((lane >> 4) << 3);
}

// The lane's address for `ldsm_t` of one 8-column tile's B fragments at two
// k-steps (k0 and k0 + 16) of a tile stored [k][n]: r0, r1 step k0's b0, b1;
// r2, r3 step k0 + 16's (K in dQ where a warp owns one 8-column tile)
__device__ __forceinline__ const bf16* b_kn_pair_at(const bf16* X, int pitch, int k0, int n0) {
  return X + (k0 + (threadIdx.x & 31)) * pitch + n0;
}

// The lane's address for `ldsm_t` of a 16 x 16 A fragment that is the
// transpose of a tile stored [k][m] (P^T and dS^T in dV and dK), at (m0, k0)
__device__ __forceinline__ const bf16* a_t_at(const bf16* X, int pitch, int m0, int k0) {
  const int lane = threadIdx.x & 31;
  return X + (k0 + (lane & 7) + ((lane >> 4) << 3)) * pitch + m0 + ((lane >> 3) & 1) * 8;
}

// c += a b on the bfloat16 tensor cores, float32 accumulation
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// y = bfloat16(x bfloat16(scale)) on the live rows of a strided bfloat16
// [B, N, H, w] tensor x, into the contiguous [B, N, H, w] y: alpha q and
// dO / norm as the TPU kernels round them (the scalar itself in bfloat16, as
// JAX's weakly typed Python float), once per call. One block a (batch row,
// row).
__global__ void prescale_kernel(const bf16* x, long long sb, long long sn, long long sh, int w, bf16* y,
                                const int* lengths, int N, int H, float scale_) {
  const int b = (int)(blockIdx.x / (unsigned)N), row = (int)(blockIdx.x % (unsigned)N);
  if (row >= min(lengths[b], N)) return;
  const float scale = hstu_tf32::round_bf16(scale_);
  const bf16* src = x + b * sb + row * sn;
  bf16* dst = y + ((long long)b * N + row) * H * w;
  for (int e = threadIdx.x; e < H * w; e += blockDim.x)
    dst[e] = __float2bfloat16_rn(__bfloat162float(src[e / w * sh + e % w]) * scale);
}

// The pre-scaling pass of a bfloat16 backward body, on the parameters `p`
// of any of them: bfloat16(alpha q) into the wrapper's buffer p.qs (where
// alpha != 1) and bfloat16(dO / norm) into p.dos, contiguous [B, N, H, D]
// and [B, N, H, V]; p's q and dO then point at them, read in 16-byte pieces
// where the width allows. Returns the launches' error, or
// cudaErrorInvalidValue where a buffer is missing.
template <typename P>
cudaError_t prescale(P& p, cudaStream_t s) {
  if (p.dos == nullptr || (p.alpha != 1.f && p.qs == nullptr)) return cudaErrorInvalidValue;
  const long long rows = (long long)p.B * p.N;
  if (rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (p.alpha != 1.f) {
    prescale_kernel<<<(unsigned)rows, 128, 0, s>>>(p.q, p.q_sb, p.q_sn, p.q_sh, p.D, p.qs, p.lengths, p.N, p.H,
                                                   p.alpha);
    p.q = p.qs;
    p.q_sb = (long long)p.N * p.H * p.D;
    p.q_sn = (long long)p.H * p.D;
    p.q_sh = p.D;
    p.vec_q = p.D % 8 == 0;
  }
  prescale_kernel<<<(unsigned)rows, 128, 0, s>>>(p.dout, p.do_sb, p.do_sn, p.do_sh, p.V, p.dos, p.lengths, p.N, p.H,
                                                 p.inv_norm);
  p.dout = p.dos;
  p.do_sb = (long long)p.N * p.H * p.V;
  p.do_sn = (long long)p.H * p.V;
  p.do_sh = p.V;
  p.vec_do = p.V % 8 == 0;
  return cudaGetLastError();
}

}  // namespace hstu_bf16
