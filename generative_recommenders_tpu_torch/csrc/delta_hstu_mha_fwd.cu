// K5: M-FALCON cached-decode attention forward for Hopper (sm_90a), float32
// (`delta_hstu_mha_fwd`) and bfloat16 (`delta_hstu_mha_fwd_bf16`).
// The M newest queries of each row (positions length-M .. length-1,
// [B, M, H, D]) attend over the cache + delta keys/values ([B, N, H, D],
// [B, N, H, V]); out is [B, M, H, V]:
//
//   S = alpha * Q K^T   P = silu(S) * valid_mask   O = (P V) / norm
//
// Replaces `_delta_fwd_kernel_rkv` (called from `delta_hstu_mha_pallas`) of
// generative_recommenders_tpu/ops/pallas/hstu_attention.py. The mask is
// `valid_elem` of hstu_attention.cuh with the length guard off, on the row
// min(max(length - M + r, 0), N - 1).
//
// Bound on the H100: the bytes of K and V. At the serving chunk (M = 5,
// D = V = 128) every K/V element is used five times, about 2.5 float32
// operations per byte read, far under the card's 20. So the design is a
// streaming one:
// * The key range is cut across blocks in chunks of 64 columns: grid
//   (chunk, head x row tile, batch row). Chunks at or past a row's length
//   exit at once (chunk 0 always runs, so a row of length 0 still gets its
//   zeros). Several hundred blocks of equal work at the serving shape,
//   several resident per SM, and the longest row no longer sets the time.
//   (Chunks inside the length but outside a `max_attn_len` window are not
//   skipped: they compute zeros.)
// * silu attention has no softmax normaliser, so partial sums over disjoint
//   key ranges simply add. A row with one live chunk writes `out` directly.
//   Otherwise each block writes its partial to a [chunks, B, M, H, V]
//   scratch, and the last block to arrive for its (row, head, row tile),
//   found with a counter, sums the live chunks in chunk order and writes
//   `out`: a fixed order, the same bits on every run. The counter is reset by
//   that block, so one zeroed buffer serves every launch on a stream.
// * K and V go straight from global memory to registers in 16-byte loads,
//   neighbouring lanes on neighbouring addresses, never through shared
//   memory. A warp takes four key columns at a time: eight lanes per K row
//   (four `float4` each at D = 128), the whole warp per V row. The scalar
//   path serves a pointer, stride or width that is not a multiple of four
//   floats (D = 25; D = 40 takes the 16-byte loads with a zero-padded
//   tail). The next step's K rows are requested while this step's P is
//   formed, its V rows while P V is summed.
// * Only live query rows cost arithmetic: a block serves up to 8 rows (M = 5
//   at the serving chunk; larger M tiles over blocks). The eight partial dot
//   products of a lane group are summed by a transposing butterfly (7
//   shuffles), which leaves row r's sum on lane r of the group, where the
//   mask and the silu are computed once; P then reaches the warp by shuffle.
// * Any width: V is cut into chunks of 128 columns, one a block (a factor of
//   the grid's y), each with its own arrival counter; D up to 256 is padded
//   to 32, 64, 128 or 256 and q staged in shared memory, and a wider D takes
//   an instance that walks it in chunks of 256, reading q's chunk from
//   device memory (through the L1 cache) beside K's, S summed over the
//   chunks.
//
// On bfloat16 q, k and v (`delta_bf16_kernel`) the kernel keeps the
// rounding points of `_delta_fwd_kernel_rkv`: q enters as bfloat16(alpha q)
// where alpha != 1 (alpha itself rounded to bfloat16, the TPU kernel's
// weakly typed scalar), S and the sums are float32 (a product of two
// bfloat16 values is exact in float32), P is rounded to bfloat16 before
// P V, and the output is (P V) / norm rounded once to bfloat16: by the block
// of a row with one live chunk, else by the last block to arrive, whose
// chunk sums stay float32 in `scratch`. Bound: the bytes of K and V at 2 per
// element. Its lane layout is its own, so that a load instruction brings 16
// bytes as the float32 kernel's do: a lane takes 8 elements of a K row in
// one 16-byte load (eight lanes a row, D padded to 64, 128 or 256, four rows
// a step as in float32), and in P V a lane owns 8 V columns, so a half-warp
// covers a V row of 128 and the warp takes two of the step's four rows at a
// time (the halves' sums added once at the block's end). q is staged in
// shared memory as float32, in the order the lanes read it, from 16-byte
// loads where its rows allow; rows that are not 16-byte pieces (D 25, a
// pointer or stride off 8 elements) are read element by element.
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>

#include "hstu_attention.cuh"

namespace hstu_delta {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = 4;
constexpr int kChunk = 64;     // key columns per block: 16 per warp
constexpr int kIters = kChunk / kWarps / 4;  // a warp's steps of 4 columns
constexpr int kRows = 8;       // query rows per block
constexpr int kMaxV = 128;     // one float4 per lane
constexpr unsigned kFull = 0xffffffffu;

// E: float, or __nv_bfloat16 (q, k, v and out); the scratch is float32
template <typename E>
struct Params {
  const E* q;
  const E* k;
  const E* v;
  E* out;          // contiguous [B, M, H, V]
  float* scratch;  // contiguous [chunks, B, M, H, V]; unused with one chunk
  int* counters;   // [B, H, row tiles], zero between launches
  const int* lengths;      // int32 [B]
  const int* num_targets;  // int32 [B] or null (no targets)
  int B, M, N, H, D, V;
  int n_vc;  // V's chunks of kMaxV columns
  long long q_sb, q_sn, q_sh;
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  float alpha, inv_norm;
  int max_attn_len, contextual_seq_len, min_full_attn_seq_len;
  int vec_k, vec_v;  // pointer, strides and width: multiples of 4 float32 or 8 bfloat16 elements
  int vec_q;         // the same of q
};

__device__ __forceinline__ float4 load4(const float* p, int at, int w, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(p + at));
  float4 r;
  r.x = at < w ? __ldg(p + at) : 0.f;
  r.y = at + 1 < w ? __ldg(p + at + 1) : 0.f;
  r.z = at + 2 < w ? __ldg(p + at + 2) : 0.f;
  r.w = at + 3 < w ? __ldg(p + at + 3) : 0.f;
  return r;
}

// bfloat16: 8 elements of a row from `at` on as 4 pairs (the first in the
// lower half of each), in one 16-byte load where `vec`, else element by
// element with zeros at and past w
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p, int at, int w, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p + at));
  const unsigned short* e = reinterpret_cast<const unsigned short*>(p + at);
  unsigned x[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = at + i < w ? __ldg(e + i) : 0u;
  return make_uint4(x[0] | x[1] << 16, x[2] | x[3] << 16, x[4] | x[5] << 16, x[6] | x[7] << 16);
}

// the 8 elements of `load8` as float32 (a bfloat16 is the top half of the
// float32 of the same value)
__device__ __forceinline__ void unpack8(uint4 r, float* f) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store4(float* p, int at, int w, bool vec, float4 x) {
  if (vec) {
    *reinterpret_cast<float4*>(p + at) = x;
    return;
  }
  if (at < w) p[at] = x.x;
  if (at + 1 < w) p[at + 1] = x.y;
  if (at + 2 < w) p[at + 2] = x.z;
  if (at + 3 < w) p[at + 3] = x.w;
}

// the output on bfloat16, each element rounded once
__device__ __forceinline__ void store4(__nv_bfloat16* p, int at, int w, bool vec, float4 x) {
  if (vec) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y), hi = __floats2bfloat162_rn(x.z, x.w);
    *reinterpret_cast<uint2*>(p + at) =
        make_uint2(*reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
    return;
  }
  if (at < w) p[at] = __float2bfloat16_rn(x.x);
  if (at + 1 < w) p[at + 1] = __float2bfloat16_rn(x.y);
  if (at + 2 < w) p[at + 2] = __float2bfloat16_rn(x.z);
  if (at + 3 < w) p[at + 3] = __float2bfloat16_rn(x.w);
}

// The block's end, shared by both kernels: the sums of its 4 warps in `red`
// added in warp order; a row with one live chunk writes `out`, else the
// block writes its chunk's partial and the last block to arrive sums the
// live chunks in chunk order (the same bits on every run).
template <typename E>
__device__ __forceinline__ void finish(const Params<E>& p, float (*red)[kRows][kMaxV], int* s_last, int chunk,
                                       int n_live, int b, int h, int rt, int row_tiles, int vc, int v0, int vw,
                                       int m0, int mr) {
  const int tid = threadIdx.x;
  __syncthreads();
  const bool direct = n_live == 1;
  const bool vec_o = p.V % 4 == 0;  // out and scratch come from the allocator
  // (out's rows in 16-byte pieces of float32, 8-byte ones of bfloat16)
  const long long row_floats = (long long)p.H * p.V;
  const long long out_at = ((long long)b * p.M + m0) * row_floats + (long long)h * p.V + v0;
  const long long chunk_floats = (long long)p.B * p.M * row_floats;
  float* part = direct ? nullptr : p.scratch + chunk * chunk_floats + out_at;
  const float scale = direct ? p.inv_norm : 1.f;
  for (int idx = tid; idx < kRows * (kMaxV / 4); idx += kThreads) {
    const int m = idx / (kMaxV / 4), at = (idx % (kMaxV / 4)) * 4;
    if (m >= mr || at >= vw) continue;
    float4 sum = *reinterpret_cast<const float4*>(&red[0][m][at]);
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float4 r = *reinterpret_cast<const float4*>(&red[w][m][at]);
      sum.x += r.x; sum.y += r.y; sum.z += r.z; sum.w += r.w;
    }
    sum.x *= scale; sum.y *= scale; sum.z *= scale; sum.w *= scale;
    if (direct)
      store4(p.out + out_at + m * row_floats, at, vw, vec_o, sum);
    else
      store4(part + m * row_floats, at, vw, vec_o, sum);
  }
  if (direct) return;

  // the last of the row's live chunks to arrive sums them in chunk order
  // (the block's stores are ordered before thread 0's fence by the barrier,
  // and the fence before its count; the last block's loads bypass L1)
  __syncthreads();
  if (tid == 0) {
    int* counter = p.counters + (((long long)b * p.H + h) * row_tiles + rt) * p.n_vc + vc;
    __threadfence();
    const int arrived = atomicAdd(counter, 1);
    __threadfence();
    *s_last = arrived == n_live - 1;
    if (*s_last) atomicExch(counter, 0);  // ready for the next launch
  }
  __syncthreads();
  if (!*s_last) return;
  for (int idx = tid; idx < kRows * (kMaxV / 4); idx += kThreads) {
    const int m = idx / (kMaxV / 4), at = (idx % (kMaxV / 4)) * 4;
    if (m >= mr || at >= vw) continue;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < n_live; ++c) {
      const float* src = p.scratch + c * chunk_floats + out_at + m * row_floats;
      float4 r;
      if (vec_o) {
        r = __ldcg(reinterpret_cast<const float4*>(src + at));
      } else {
        r.x = __ldcg(src + at);
        r.y = at + 1 < vw ? __ldcg(src + at + 1) : 0.f;
        r.z = at + 2 < vw ? __ldcg(src + at + 2) : 0.f;
        r.w = at + 3 < vw ? __ldcg(src + at + 3) : 0.f;
      }
      sum.x += r.x; sum.y += r.y; sum.z += r.z; sum.w += r.w;
    }
    sum.x *= p.inv_norm; sum.y *= p.inv_norm; sum.z *= p.inv_norm; sum.w *= p.inv_norm;
    store4(p.out + out_at + m * row_floats, at, vw, vec_o, sum);
  }
}

// float32. DI pieces of 4 elements per lane and K row: D is padded with
// zeros to 32 * DI. WIDE (DI = 8): D above 256, walked in chunks of 32 * DI
// with q read from device memory.
template <int DI, bool WIDE = false>
__global__ void __launch_bounds__(kThreads, 4) delta_kernel(Params<float> p) {
  constexpr int DP = 32 * DI;
  __shared__ __align__(16) float qs[WIDE ? 1 : kRows][DP];
  __shared__ __align__(16) float red[kWarps][kRows][kMaxV];
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 3, l8 = lane & 7;
  const int chunk = blockIdx.x;
  // grid y: head, then row tile, then V chunk
  const int row_tiles = gridDim.y / (p.H * p.n_vc);
  const int h = blockIdx.y % p.H, rt = blockIdx.y / p.H % row_tiles;
  const int vc = blockIdx.y / (p.H * row_tiles);
  const int v0 = vc * kMaxV, vw = min(kMaxV, p.V - v0);  // the block's V columns
  const int b = blockIdx.z;
  const int length = min(p.lengths[b], p.N);
  const int n_live = max(1, (length + kChunk - 1) / kChunk);
  if (chunk >= n_live) return;
  const int nt = p.num_targets ? p.num_targets[b] : 0;
  const int m0 = rt * kRows;
  const int mr = min(kRows, p.M - m0);  // live query rows of this block

  // lane l8 of a group masks query row m0 + l8
  const bool my_live = l8 < mr;
  const int mrow = min(max(length - p.M + m0 + l8, 0), p.N - 1);

  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh + v0;
  const int cbase = chunk * kChunk + warp * (kChunk / kWarps);
  const bool vec_k = p.vec_k != 0, vec_v = p.vec_v != 0;
  // the warp's four key columns from c0 on: lane group grp reads K row
  // c0 + grp, the whole warp each of the four V rows; zeros past the length
  float4 kr[DI], vr[4];
  // K's columns d0 .. d0 + DP of row c0 + grp
  auto load_k = [&](int c0, int d0) {
    const int col = c0 + grp;
    const float* kp = kb + (long long)col * p.k_sn;
#pragma unroll
    for (int i = 0; i < DI; ++i) {
      const int at = d0 + (i * 8 + l8) * 4;
      kr[i] = (col < length && at < p.D) ? load4(kp, at, p.D, vec_k)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto load_v = [&](int c0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int at = lane * 4;
      vr[j] = (c0 + j < length && at < vw)
                  ? load4(vb + (long long)(c0 + j) * p.v_sn, at, vw, vec_v)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  // the first columns are on their way while q goes to shared memory
  if (!WIDE) load_k(cbase, 0);
  load_v(cbase);

  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  if (!WIDE)
    for (int idx = tid; idx < kRows * DP; idx += kThreads) {
      const int r = idx / DP, d = idx % DP;
      qs[WIDE ? 0 : r][d] = (r < mr && d < p.D) ? qb[(m0 + r) * p.q_sn + d] : 0.f;
    }
  __syncthreads();

  float4 acc[kRows];
#pragma unroll
  for (int m = 0; m < kRows; ++m) acc[m] = make_float4(0.f, 0.f, 0.f, 0.f);

#pragma unroll 2
  for (int it = 0; it < kIters; ++it) {
    const int c0 = cbase + it * 4;
    if (c0 >= length) break;  // the same for the whole warp
    const int col = c0 + grp;
    const bool in = col < length;

    float s[kRows];
#pragma unroll
    for (int m = 0; m < kRows; ++m) s[m] = 0.f;
    if constexpr (WIDE) {
      // D's chunks in turn: K's and q's from device memory
      for (int d0 = 0; d0 < p.D; d0 += DP) {
        load_k(c0, d0);
#pragma unroll
        for (int m = 0; m < kRows; ++m) {
          if (m < mr) {
            const float* qm = qb + (long long)(m0 + m) * p.q_sn;
#pragma unroll
            for (int i = 0; i < DI; ++i) {
              const int at = d0 + (i * 8 + l8) * 4;
              const float4 qq = at < p.D ? load4(qm, at, p.D, p.vec_q != 0) : make_float4(0.f, 0.f, 0.f, 0.f);
              s[m] = fmaf(qq.x, kr[i].x, s[m]);
              s[m] = fmaf(qq.y, kr[i].y, s[m]);
              s[m] = fmaf(qq.z, kr[i].z, s[m]);
              s[m] = fmaf(qq.w, kr[i].w, s[m]);
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        if (m < mr) {
#pragma unroll
          for (int i = 0; i < DI; ++i) {
            const float4 qq = *reinterpret_cast<const float4*>(&qs[WIDE ? 0 : m][(i * 8 + l8) * 4]);
            s[m] = fmaf(qq.x, kr[i].x, s[m]);
            s[m] = fmaf(qq.y, kr[i].y, s[m]);
            s[m] = fmaf(qq.z, kr[i].z, s[m]);
            s[m] = fmaf(qq.w, kr[i].w, s[m]);
          }
        }
      }
      // the next columns' K, while this one's P is formed
      if (it + 1 < kIters) load_k(c0 + 4, 0);
    }
    // sum over the group's 8 lanes, halving the rows a lane keeps at each
    // step: lane l8 ends with row l8's dot product
    float w4[4], w2[2];
    const bool b2 = (l8 & 4) != 0, b1 = (l8 & 2) != 0, b0 = (l8 & 1) != 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float send = b2 ? s[i] : s[i + 4], keep = b2 ? s[i + 4] : s[i];
      w4[i] = keep + __shfl_xor_sync(kFull, send, 4);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float send = b1 ? w4[i] : w4[i + 2], keep = b1 ? w4[i + 2] : w4[i];
      w2[i] = keep + __shfl_xor_sync(kFull, send, 2);
    }
    const float send = b0 ? w2[0] : w2[1], keep = b0 ? w2[1] : w2[0];
    const float x = (keep + __shfl_xor_sync(kFull, send, 1)) * p.alpha;
    const bool ok = my_live && in &&
                    hstu::valid_elem(mrow, col, length, nt, /*causal=*/true, p.max_attn_len,
                                     p.contextual_seq_len, p.min_full_attn_seq_len,
                                     /*guard=*/false);
    float pv = ok ? x / (1.f + expf(-x)) : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        if (m < mr) {
          const float pm = __shfl_sync(kFull, pv, j * 8 + m);
          acc[m].x = fmaf(pm, vr[j].x, acc[m].x);
          acc[m].y = fmaf(pm, vr[j].y, acc[m].y);
          acc[m].z = fmaf(pm, vr[j].z, acc[m].z);
          acc[m].w = fmaf(pm, vr[j].w, acc[m].w);
        }
      }
    }
    if (it + 1 < kIters) load_v(c0 + 4);
  }

#pragma unroll
  for (int m = 0; m < kRows; ++m)
    *reinterpret_cast<float4*>(&red[warp][m][lane * 4]) = acc[m];
  finish(p, red, &s_last, chunk, n_live, b, h, rt, row_tiles, vc, v0, vw, m0, mr);
}

// bfloat16. DI pieces of 8 elements per lane and K row: D is padded with
// zeros to 64 * DI. WIDE (DI = 4): D above 256, walked in chunks of 256
// with q read from device memory. `p.vec_*`: rows readable in 16-byte
// pieces of 8 elements.
template <int DI, bool WIDE = false>
__global__ void __launch_bounds__(kThreads, 4) delta_bf16_kernel(Params<__nv_bfloat16> p) {
  using bf16 = __nv_bfloat16;
  // alpha folded into q, rounded, as the TPU kernel forms alpha q
  const float q_scale = p.alpha != 1.f ? round_bf16(p.alpha) : 1.f;
  constexpr int DP = 64 * DI;
  // q's rows, float32, in the order the lanes read them: element d at
  // ((d / 64 * 2 + d % 8 / 4) * 8 + d % 64 / 8) * 4 + d % 4, so that the 8
  // lanes of a group read 128 consecutive bytes with each float4
  __shared__ __align__(16) float qs[WIDE ? 1 : kRows][DP];
  __shared__ __align__(16) float red[kWarps][kRows][kMaxV];
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 3, l8 = lane & 7;     // K: lane group grp reads row c0 + grp
  const int half = lane >> 4, l16 = lane & 15;  // V: half-warp `half` reads rows c0 + half and c0 + 2 + half
  const int chunk = blockIdx.x;
  const int row_tiles = gridDim.y / (p.H * p.n_vc);
  const int h = blockIdx.y % p.H, rt = blockIdx.y / p.H % row_tiles;
  const int vc = blockIdx.y / (p.H * row_tiles);
  const int v0 = vc * kMaxV, vw = min(kMaxV, p.V - v0);
  const int b = blockIdx.z;
  const int length = min(p.lengths[b], p.N);
  const int n_live = max(1, (length + kChunk - 1) / kChunk);
  if (chunk >= n_live) return;
  const int nt = p.num_targets ? p.num_targets[b] : 0;
  const int m0 = rt * kRows;
  const int mr = min(kRows, p.M - m0);
  const bool my_live = l8 < mr;
  const int mrow = min(max(length - p.M + m0 + l8, 0), p.N - 1);

  const bf16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + h * p.v_sh + v0;
  const int cbase = chunk * kChunk + warp * (kChunk / kWarps);
  const bool vec_k = p.vec_k != 0, vec_v = p.vec_v != 0;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  // the warp's four key columns from c0 on: K row c0 + grp, 8 elements a
  // lane and piece; V rows c0 + half and c0 + 2 + half, columns 8 l16 .. + 8
  uint4 kr[DI], vr[2];
  auto load_k = [&](int c0, int d0) {
    const int col = c0 + grp;
    const bf16* kp = kb + (long long)col * p.k_sn;
#pragma unroll
    for (int i = 0; i < DI; ++i) {
      const int at = d0 + (i * 8 + l8) * 8;
      kr[i] = (col < length && at < p.D) ? load8(kp, at, p.D, vec_k) : zero;
    }
  };
  auto load_v = [&](int c0) {
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int row = c0 + 2 * jj + half, at = l16 * 8;
      vr[jj] = (row < length && at < vw) ? load8(vb + (long long)row * p.v_sn, at, vw, vec_v) : zero;
    }
  };
  if (!WIDE) load_k(cbase, 0);
  load_v(cbase);

  const bf16* qb = p.q + b * p.q_sb + h * p.q_sh;
  // bfloat16(alpha q) where alpha != 1
  auto scaled = [&](float x) { return q_scale != 1.f ? round_bf16(x * q_scale) : x; };
  if (!WIDE)
    for (int idx = tid; idx < kRows * DP / 8; idx += kThreads) {  // 8 elements of a row a thread
      const int r = idx / (DP / 8), d = idx % (DP / 8) * 8;
      float f[8];
      unpack8(r < mr && d < p.D ? load8(qb + (long long)(m0 + r) * p.q_sn, d, p.D, p.vec_q != 0) : zero, f);
      float* dst = &qs[WIDE ? 0 : r][((d / 64 * 2) * 8 + d % 64 / 8) * 4];
      *reinterpret_cast<float4*>(dst) = make_float4(scaled(f[0]), scaled(f[1]), scaled(f[2]), scaled(f[3]));
      *reinterpret_cast<float4*>(dst + 32) = make_float4(scaled(f[4]), scaled(f[5]), scaled(f[6]), scaled(f[7]));
    }
  __syncthreads();

  float acc[kRows][8];
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[m][e] = 0.f;

#pragma unroll 2
  for (int it = 0; it < kIters; ++it) {
    const int c0 = cbase + it * 4;
    if (c0 >= length) break;  // the same for the whole warp
    const int col = c0 + grp;
    const bool in = col < length;

    float s[kRows];
#pragma unroll
    for (int m = 0; m < kRows; ++m) s[m] = 0.f;
    if constexpr (WIDE) {
      for (int d0 = 0; d0 < p.D; d0 += DP) {
        load_k(c0, d0);
#pragma unroll
        for (int i = 0; i < DI; ++i) {
          float kf[8];
          unpack8(kr[i], kf);
          const int at = d0 + (i * 8 + l8) * 8;
#pragma unroll
          for (int m = 0; m < kRows; ++m) {
            if (m < mr) {
              float qf[8];
              unpack8(at < p.D ? load8(qb + (long long)(m0 + m) * p.q_sn, at, p.D, p.vec_q != 0) : zero, qf);
#pragma unroll
              for (int e = 0; e < 8; ++e) s[m] = fmaf(scaled(qf[e]), kf[e], s[m]);
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < DI; ++i) {
        float kf[8];
        unpack8(kr[i], kf);
#pragma unroll
        for (int m = 0; m < kRows; ++m) {
          if (m < mr) {
            const float4 qa = *reinterpret_cast<const float4*>(&qs[WIDE ? 0 : m][((i * 2) * 8 + l8) * 4]);
            const float4 qz = *reinterpret_cast<const float4*>(&qs[WIDE ? 0 : m][((i * 2 + 1) * 8 + l8) * 4]);
            s[m] = fmaf(qa.x, kf[0], s[m]);
            s[m] = fmaf(qa.y, kf[1], s[m]);
            s[m] = fmaf(qa.z, kf[2], s[m]);
            s[m] = fmaf(qa.w, kf[3], s[m]);
            s[m] = fmaf(qz.x, kf[4], s[m]);
            s[m] = fmaf(qz.y, kf[5], s[m]);
            s[m] = fmaf(qz.z, kf[6], s[m]);
            s[m] = fmaf(qz.w, kf[7], s[m]);
          }
        }
      }
      // the next columns' K, while this one's P is formed
      if (it + 1 < kIters) load_k(c0 + 4, 0);
    }
    // the float32 kernel's butterfly: lane l8 ends with row l8's dot product
    float w4[4], w2[2];
    const bool b2 = (l8 & 4) != 0, b1 = (l8 & 2) != 0, b0 = (l8 & 1) != 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float send = b2 ? s[i] : s[i + 4], keep = b2 ? s[i + 4] : s[i];
      w4[i] = keep + __shfl_xor_sync(kFull, send, 4);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float send = b1 ? w4[i] : w4[i + 2], keep = b1 ? w4[i + 2] : w4[i];
      w2[i] = keep + __shfl_xor_sync(kFull, send, 2);
    }
    const float send = b0 ? w2[0] : w2[1], keep = b0 ? w2[1] : w2[0];
    const float x = keep + __shfl_xor_sync(kFull, send, 1);
    const bool ok = my_live && in &&
                    hstu::valid_elem(mrow, col, length, nt, /*causal=*/true, p.max_attn_len,
                                     p.contextual_seq_len, p.min_full_attn_seq_len,
                                     /*guard=*/false);
    // P V takes P in bfloat16
    const float pv = round_bf16(ok ? x / (1.f + expf(-x)) : 0.f);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      float vf[8];
      unpack8(vr[jj], vf);
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        if (m < mr) {
          const float pm = __shfl_sync(kFull, pv, (2 * jj + half) * 8 + m);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[m][e] = fmaf(pm, vf[e], acc[m][e]);
        }
      }
    }
    if (it + 1 < kIters) load_v(c0 + 4);
  }

  // the two halves' sums (key rows c0 + half, c0 + 2 + half of every step)
  // added, then the block's sum over its warps
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[m][e] += __shfl_xor_sync(kFull, acc[m][e], 16);
  if (half == 0)
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      *reinterpret_cast<float4*>(&red[warp][m][l16 * 8]) = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      *reinterpret_cast<float4*>(&red[warp][m][l16 * 8 + 4]) =
          make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
    }
  finish(p, red, &s_last, chunk, n_live, b, h, rt, row_tiles, vc, v0, vw, m0, mr);
}

template <int DI, bool WIDE = false>
cudaError_t launch_di(const Params<float>& p, int chunks, int row_tiles, cudaStream_t stream) {
  const long long gy = (long long)p.H * row_tiles * p.n_vc;
  if (gy > 65535 || p.B > 65535) return cudaErrorInvalidValue;
  dim3 grid(chunks, (unsigned)gy, p.B);
  delta_kernel<DI, WIDE><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int DI, bool WIDE = false>
cudaError_t launch_di(const Params<__nv_bfloat16>& p, int chunks, int row_tiles, cudaStream_t stream) {
  const long long gy = (long long)p.H * row_tiles * p.n_vc;
  if (gy > 65535 || p.B > 65535) return cudaErrorInvalidValue;
  dim3 grid(chunks, (unsigned)gy, p.B);
  delta_bf16_kernel<DI, WIDE><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// Any D and V (the Python wrapper sizes `scratch` and `counters`, one counter
// per (batch row, head, row tile, V chunk), and decides `vec_k` / `vec_v`).
template <typename E>
int launch(const E* q, const E* k, const E* v, E* out, float* scratch, int* counters, const int* lengths,
           const int* num_targets, int B, int M, int N, int H, int D, int V, long long q_sb, long long q_sn,
           long long q_sh, long long k_sb, long long k_sn, long long k_sh, long long v_sb, long long v_sn,
           long long v_sh, float alpha, float inv_norm, int max_attn_len, int contextual_seq_len,
           int min_full_attn_seq_len, int vec_k, int vec_v, void* stream) {
  if (B == 0 || M == 0 || H == 0 || N == 0) return 0;
  if (D < 1 || V < 1) return (int)cudaErrorInvalidValue;
  const int chunks = (N + kChunk - 1) / kChunk;
  const int row_tiles = (M + kRows - 1) / kRows;
  if (chunks > 1 && (scratch == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  // q's rows in 16-byte pieces (of 4 float32 elements, of 8 bfloat16 ones)
  constexpr int q_elems = std::is_same<E, float>::value ? 4 : 8;
  const int vec_q = reinterpret_cast<uintptr_t>(q) % 16 == 0 && q_sb % q_elems == 0 && q_sn % q_elems == 0 &&
                    q_sh % q_elems == 0 && D % q_elems == 0;
  Params<E> p{q, k, v, out, scratch, counters, lengths, num_targets, B, M, N, H, D, V, (V + kMaxV - 1) / kMaxV,
              q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, alpha, inv_norm,
              max_attn_len, contextual_seq_len, min_full_attn_seq_len, vec_k, vec_v, vec_q};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<E, float>::value) {
    if (D <= 32) return (int)launch_di<1>(p, chunks, row_tiles, s);
    if (D <= 64) return (int)launch_di<2>(p, chunks, row_tiles, s);
    if (D <= 128) return (int)launch_di<4>(p, chunks, row_tiles, s);
    if (D <= 256) return (int)launch_di<8>(p, chunks, row_tiles, s);
    return (int)launch_di<8, true>(p, chunks, row_tiles, s);
  } else {
    if (D <= 64) return (int)launch_di<1>(p, chunks, row_tiles, s);
    if (D <= 128) return (int)launch_di<2>(p, chunks, row_tiles, s);
    if (D <= 256) return (int)launch_di<4>(p, chunks, row_tiles, s);
    return (int)launch_di<4, true>(p, chunks, row_tiles, s);
  }
}

}  // namespace hstu_delta

// Launches on `stream`; returns the launch's cudaGetLastError().
extern "C" int delta_hstu_mha_fwd(
    const float* q, const float* k, const float* v, float* out, float* scratch,
    int* counters, const int* lengths, const int* num_targets,
    int B, int M, int N, int H, int D, int V,
    long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh,
    float alpha, float inv_norm, int max_attn_len, int contextual_seq_len,
    int min_full_attn_seq_len, int vec_k, int vec_v, void* stream) {
  return hstu_delta::launch<float>(q, k, v, out, scratch, counters, lengths, num_targets, B, M, N, H, D, V,
                                   q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, alpha, inv_norm,
                                   max_attn_len, contextual_seq_len, min_full_attn_seq_len, vec_k, vec_v, stream);
}

// The bfloat16 kernel: q, k, v and out bfloat16, scratch float32; vec_k,
// vec_v: rows readable in 16-byte pieces of 8 elements.
extern "C" int delta_hstu_mha_fwd_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v, __nv_bfloat16* out,
    float* scratch, int* counters, const int* lengths, const int* num_targets,
    int B, int M, int N, int H, int D, int V,
    long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh,
    float alpha, float inv_norm, int max_attn_len, int contextual_seq_len,
    int min_full_attn_seq_len, int vec_k, int vec_v, void* stream) {
  return hstu_delta::launch<__nv_bfloat16>(q, k, v, out, scratch, counters, lengths, num_targets, B, M, N, H, D,
                                           V, q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, alpha,
                                           inv_norm, max_attn_len, contextual_seq_len, min_full_attn_seq_len,
                                           vec_k, vec_v, stream);
}
