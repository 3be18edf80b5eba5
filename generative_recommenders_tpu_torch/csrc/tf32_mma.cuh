// Float32-accurate products on Hopper's tensor cores: `mma.sync.m16n8k8`
// TF32 with the 3xTF32 split, the fragment loads from shared-memory tiles and
// `cp.async` with the tile load built on it. Shared by the relative-bias
// backward K7 (hstu_mha_relbias_bwd.cu), the forward body of K1 and K6
// (hstu_attention_fwd.cuh) and the backward bodies of K2 and K4
// (hstu_attention_bwd_dkv.cuh) and of K3 and K7-det's dq pass
// (hstu_attention_bwd_dq.cuh).
//
// The bfloat16 kernels (K1, K2, K6, K7 and K7-det on bfloat16 q, k, v) read
// their tiles through `load_tile`'s bfloat16 overload, which converts to
// float32 on the way into shared memory, and multiply with `mma<true>`: one
// TF32 product, exact, because every operand they multiply is a bfloat16
// value (the inputs, alpha q, dO / norm, and P and dS rounded to bfloat16 as
// the TPU kernels round them), and a bfloat16 value is exact in TF32 (its
// split leaves small = 0). Those that sum dq with atomics (K2, K7) sum it in
// a float32 buffer that `to_bf16` writes as bfloat16.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hstu_tf32 {

// Copies `bytes` (16 or 4) from global to shared memory without passing
// through registers, or fills them with zeros when !ok.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [r0, r0 + ROWS) of one head of a strided [.., N, H, w] tensor into a
// [ROWS][P] shared tile, asynchronously; zeros at rows >= lim and in the pad
// columns [w, W).
template <int W, int P, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long sn, int r0,
                                          int lim, int w, bool vec) {
  if (vec) {
    constexpr int C4 = W / 4;
    for (int idx = threadIdx.x; idx < ROWS * C4; idx += THREADS) {
      const int r = idx / C4, c = (idx % C4) * 4;
      const bool ok = r0 + r < lim && c < w;
      cp_async16(dst + r * P + c, ok ? src + (long long)(r0 + r) * sn + c : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * W; idx += THREADS) {
      const int r = idx / W, c = idx % W;
      const bool ok = r0 + r < lim && c < w;
      cp_async4(dst + r * P + c, ok ? src + (long long)(r0 + r) * sn + c : src, ok);
    }
  }
}

// x rounded to the nearest bfloat16 (ties to even), as a float32
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Rows [r0, r0 + ROWS) of one head of a strided bfloat16 [.., N, H, w]
// tensor into a [ROWS][P] float32 shared tile, converted on the way, with
// the same zeros as the float32 load; where scale != 1 each element is
// multiplied by it and rounded to bfloat16 again (the TPU kernels' bfloat16
// products alpha q and dO / norm). Synchronous: the tile is in place after
// the barrier that follows, as an asynchronous one is after its wait and that
// barrier. vec: rows readable in 8-byte pieces of 4 elements. The float32
// overload has no scale: a float32 kernel applies alpha and 1 / norm in
// float32 after its products, so a kernel templated on the element type
// passes a scale under `if constexpr` only.
template <int W, int P, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(float* dst, const __nv_bfloat16* src, long long sn,
                                          int r0, int lim, int w, bool vec, float scale = 1.f) {
  if (vec) {
    constexpr int C4 = W / 4;
    for (int idx = threadIdx.x; idx < ROWS * C4; idx += THREADS) {
      const int r = idx / C4, c = (idx % C4) * 4;
      uint2 raw = make_uint2(0u, 0u);
      if (r0 + r < lim && c < w)
        raw = *reinterpret_cast<const uint2*>(src + (long long)(r0 + r) * sn + c);
      // a bfloat16 is the top half of the float32 of the same value
      float4 x = make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                             __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
      if (scale != 1.f)
        x = make_float4(round_bf16(x.x * scale), round_bf16(x.y * scale), round_bf16(x.z * scale),
                        round_bf16(x.w * scale));
      *reinterpret_cast<float4*>(dst + r * P + c) = x;
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * W; idx += THREADS) {
      const int r = idx / W, c = idx % W;
      const bool ok = r0 + r < lim && c < w;
      const float x = ok ? __bfloat162float(src[(long long)(r0 + r) * sn + c]) : 0.f;
      dst[r * P + c] = scale != 1.f ? round_bf16(x * scale) : x;
    }
  }
}

// A bfloat16 kernel's dq, summed in a float32 buffer, written as bfloat16
__global__ void to_bf16_kernel(const float* x, __nv_bfloat16* y, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    y[i] = __float2bfloat16_rn(x[i]);
}

// Launches `to_bf16_kernel` over n elements on `stream`; returns its
// cudaGetLastError().
inline cudaError_t to_bf16(const float* x, __nv_bfloat16* y, long long n, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  const long long blocks = n / 256 + 1 < 4096 ? n / 256 + 1 : 4096;
  to_bf16_kernel<<<(unsigned)blocks, 256, 0, stream>>>(x, y, n);
  return cudaGetLastError();
}

// x = big + small + (an error under 2^-21 |x|): big holds x's first 11
// significant bits, small the float32 residual, of which the tensor core
// reads the sign, the exponent and the first 10 mantissa bits. big is rounded
// on the bits (add half of the last kept place, clear the 13 dropped bits):
// the same value as `cvt.rna.tf32.f32`, whose rate is a quarter of the
// integer unit's, and a fragment element is split by every warp that reads it.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// A 16 x 8 (A) or 8 x 8 (B) operand of mma.m16n8k8, split in two.
struct FragA { uint32_t big[4], small[4]; };
struct FragB { uint32_t big[2], small[2]; };

// The fragment loads. Every tile's pitch is 8 more than a multiple of 32
// floats. A fragment whose k runs along a tile's rows is read as it is
// stored, a lane's two k at rows t and t + 4: banks 8 t + g, no conflicts. A
// fragment whose k runs along the columns is read in pairs, a lane's two k
// at columns 2 t and 2 t + 1 in one 8-byte load (banks 8 g + 2 t): the k of a
// product may be taken in any order as long as both operands agree, so the
// partner of such a fragment is read in pairs too.

// A[m][k] = X[(m0 + m) * pitch + k0 + k], k in pairs
__device__ __forceinline__ FragA load_a(const float* X, int pitch, int m0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* x = X + (m0 + g) * pitch + k0 + 2 * t;
  const float2 lo = *reinterpret_cast<const float2*>(x);
  const float2 hi = *reinterpret_cast<const float2*>(x + 8 * pitch);
  FragA f;
  split(lo.x, f.big[0], f.small[0]);
  split(hi.x, f.big[1], f.small[1]);
  split(lo.y, f.big[2], f.small[2]);
  split(hi.y, f.big[3], f.small[3]);
  return f;
}

// A[m][k] = X[(k0 + k) * pitch + m0 + m]: the transpose of a stored tile
__device__ __forceinline__ FragA load_a_t(const float* X, int pitch, int m0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* x = X + (k0 + t) * pitch + m0 + g;
  FragA f;
  split(x[0], f.big[0], f.small[0]);
  split(x[8], f.big[1], f.small[1]);
  split(x[4 * pitch], f.big[2], f.small[2]);
  split(x[4 * pitch + 8], f.big[3], f.small[3]);
  return f;
}

// B[k][n] = X[(n0 + n) * pitch + k0 + k]: a tile stored [n][k], k in pairs
__device__ __forceinline__ FragB load_b_nk(const float* X, int pitch, int n0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float2 x = *reinterpret_cast<const float2*>(X + (n0 + g) * pitch + k0 + 2 * t);
  FragB f;
  split(x.x, f.big[0], f.small[0]);
  split(x.y, f.big[1], f.small[1]);
  return f;
}

// B[k][n] = X[(k0 + k) * pitch + n0 + n]: a tile stored [k][n]; PAIRS: k in
// pairs, for a partner read by `load_a` (rows 2 t and 2 t + 1 then meet
// another lane's on one bank: the one load here with a conflict, two-way)
template <bool PAIRS = false>
__device__ __forceinline__ FragB load_b_kn(const float* X, int pitch, int k0, int n0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* x = X + (k0 + (PAIRS ? 2 * t : t)) * pitch + n0 + g;
  FragB f;
  split(x[0], f.big[0], f.small[0]);
  split(x[(PAIRS ? 1 : 4) * pitch], f.big[1], f.small[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32; a thread's c[0..3] are (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1) of the 16 x 8 tile, g = lane / 4, t = lane % 4
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, const FragB& b) {
  mma_tf32(c, a.small, b.big);
  mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.big, b.big);
}

// c += a b: EXACT (both operands bfloat16 values, exact in TF32) one TF32
// product, else 3xTF32
template <bool EXACT>
__device__ __forceinline__ void mma(float (&c)[4], const FragA& a, const FragB& b) {
  if constexpr (EXACT) {
    mma_tf32(c, a.big, b.big);
  } else {
    mma3(c, a, b);
  }
}

}  // namespace hstu_tf32
