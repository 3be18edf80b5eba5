// K5: M-FALCON cached-decode attention forward for Hopper (sm_90a), float32.
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
#include "hstu_attention.cuh"

namespace hstu_delta {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = 4;
constexpr int kChunk = 64;     // key columns per block: 16 per warp
constexpr int kIters = kChunk / kWarps / 4;  // a warp's steps of 4 columns
constexpr int kRows = 8;       // query rows per block
constexpr int kMaxV = 128;     // one float4 per lane
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* out;      // contiguous [B, M, H, V]
  float* scratch;  // contiguous [chunks, B, M, H, V]; unused with one chunk
  int* counters;   // [B, H, row tiles], zero between launches
  const int* lengths;      // int32 [B]
  const int* num_targets;  // int32 [B] or null (no targets)
  int B, M, N, H, D, V;
  long long q_sb, q_sn, q_sh;
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  float alpha, inv_norm;
  int max_attn_len, contextual_seq_len, min_full_attn_seq_len;
  int vec_k, vec_v;  // pointer, strides and width are multiples of 4 floats
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

// DI float4 per lane and K row: D is padded with zeros to 32 * DI.
template <int DI>
__global__ void __launch_bounds__(kThreads, 4) delta_kernel(Params p) {
  constexpr int DP = 32 * DI;
  __shared__ __align__(16) float qs[kRows][DP];
  __shared__ __align__(16) float red[kWarps][kRows][kMaxV];
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 3, l8 = lane & 7;
  const int chunk = blockIdx.x;
  const int h = blockIdx.y % p.H, rt = blockIdx.y / p.H;
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
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;
  const int cbase = chunk * kChunk + warp * (kChunk / kWarps);
  const bool vec_k = p.vec_k != 0, vec_v = p.vec_v != 0;
  // the warp's four key columns from c0 on: lane group grp reads K row
  // c0 + grp, the whole warp each of the four V rows; zeros past the length
  float4 kr[DI], vr[4];
  auto load_k = [&](int c0) {
    const int col = c0 + grp;
    const float* kp = kb + (long long)col * p.k_sn;
#pragma unroll
    for (int i = 0; i < DI; ++i) {
      const int at = (i * 8 + l8) * 4;
      kr[i] = (col < length && at < p.D) ? load4(kp, at, p.D, vec_k)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto load_v = [&](int c0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int at = lane * 4;
      vr[j] = (c0 + j < length && at < p.V)
                  ? load4(vb + (long long)(c0 + j) * p.v_sn, at, p.V, vec_v)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  // the first columns are on their way while q goes to shared memory
  load_k(cbase);
  load_v(cbase);

  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  for (int idx = tid; idx < kRows * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP;
    qs[r][d] = (r < mr && d < p.D) ? qb[(m0 + r) * p.q_sn + d] : 0.f;
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
    for (int m = 0; m < kRows; ++m) {
      s[m] = 0.f;
      if (m < mr) {
#pragma unroll
        for (int i = 0; i < DI; ++i) {
          const float4 qq = *reinterpret_cast<const float4*>(&qs[m][(i * 8 + l8) * 4]);
          s[m] = fmaf(qq.x, kr[i].x, s[m]);
          s[m] = fmaf(qq.y, kr[i].y, s[m]);
          s[m] = fmaf(qq.z, kr[i].z, s[m]);
          s[m] = fmaf(qq.w, kr[i].w, s[m]);
        }
      }
    }
    // the next columns' K, while this one's P is formed
    if (it + 1 < kIters) load_k(c0 + 4);
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
    const float pv = ok ? x / (1.f + expf(-x)) : 0.f;
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

  // the block's sum over its 4 warps, in warp order
#pragma unroll
  for (int m = 0; m < kRows; ++m)
    *reinterpret_cast<float4*>(&red[warp][m][lane * 4]) = acc[m];
  __syncthreads();
  const bool direct = n_live == 1;
  const bool vec_o = p.V % 4 == 0;  // out and scratch come from the allocator
  const long long row_floats = (long long)p.H * p.V;
  const long long out_at = ((long long)b * p.M + m0) * row_floats + (long long)h * p.V;
  const long long chunk_floats = (long long)p.B * p.M * row_floats;
  float* dst = direct ? p.out + out_at : p.scratch + chunk * chunk_floats + out_at;
  const float scale = direct ? p.inv_norm : 1.f;
  for (int idx = tid; idx < kRows * (kMaxV / 4); idx += kThreads) {
    const int m = idx / (kMaxV / 4), at = (idx % (kMaxV / 4)) * 4;
    if (m >= mr || at >= p.V) continue;
    float4 sum = *reinterpret_cast<const float4*>(&red[0][m][at]);
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float4 r = *reinterpret_cast<const float4*>(&red[w][m][at]);
      sum.x += r.x; sum.y += r.y; sum.z += r.z; sum.w += r.w;
    }
    sum.x *= scale; sum.y *= scale; sum.z *= scale; sum.w *= scale;
    store4(dst + m * row_floats, at, p.V, vec_o, sum);
  }
  if (direct) return;

  // the last of the row's live chunks to arrive sums them in chunk order
  // (the block's stores are ordered before thread 0's fence by the barrier,
  // and the fence before its count; the last block's loads bypass L1)
  __syncthreads();
  if (tid == 0) {
    const int row_tiles = gridDim.y / p.H;
    int* counter = p.counters + ((long long)b * p.H + h) * row_tiles + rt;
    __threadfence();
    const int arrived = atomicAdd(counter, 1);
    __threadfence();
    s_last = arrived == n_live - 1;
    if (s_last) atomicExch(counter, 0);  // ready for the next launch
  }
  __syncthreads();
  if (!s_last) return;
  for (int idx = tid; idx < kRows * (kMaxV / 4); idx += kThreads) {
    const int m = idx / (kMaxV / 4), at = (idx % (kMaxV / 4)) * 4;
    if (m >= mr || at >= p.V) continue;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < n_live; ++c) {
      const float* src = p.scratch + c * chunk_floats + out_at + m * row_floats;
      float4 r;
      if (vec_o) {
        r = __ldcg(reinterpret_cast<const float4*>(src + at));
      } else {
        r.x = __ldcg(src + at);
        r.y = at + 1 < p.V ? __ldcg(src + at + 1) : 0.f;
        r.z = at + 2 < p.V ? __ldcg(src + at + 2) : 0.f;
        r.w = at + 3 < p.V ? __ldcg(src + at + 3) : 0.f;
      }
      sum.x += r.x; sum.y += r.y; sum.z += r.z; sum.w += r.w;
    }
    sum.x *= p.inv_norm; sum.y *= p.inv_norm; sum.z *= p.inv_norm; sum.w *= p.inv_norm;
    store4(p.out + out_at + m * row_floats, at, p.V, vec_o, sum);
  }
}

template <int DI>
cudaError_t launch_di(const Params& p, int chunks, int row_tiles, cudaStream_t stream) {
  dim3 grid(chunks, p.H * row_tiles, p.B);
  delta_kernel<DI><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace hstu_delta

// Launches on `stream`; returns the launch's cudaGetLastError(). D is at most
// 256 and V at most 128 (the Python wrapper checks both, sizes `scratch` and
// `counters`, and decides `vec_k` / `vec_v`).
extern "C" int delta_hstu_mha_fwd(
    const float* q, const float* k, const float* v, float* out, float* scratch,
    int* counters, const int* lengths, const int* num_targets,
    int B, int M, int N, int H, int D, int V,
    long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh,
    float alpha, float inv_norm, int max_attn_len, int contextual_seq_len,
    int min_full_attn_seq_len, int vec_k, int vec_v, void* stream) {
  using namespace hstu_delta;
  if (B == 0 || M == 0 || H == 0 || N == 0) return 0;
  if (D < 1 || D > 256 || V < 1 || V > kMaxV) return (int)cudaErrorInvalidValue;
  const int chunks = (N + kChunk - 1) / kChunk;
  const int row_tiles = (M + kRows - 1) / kRows;
  if (chunks > 1 && (scratch == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, out, scratch, counters, lengths, num_targets, B, M, N, H, D, V,
           q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, alpha, inv_norm,
           max_attn_len, contextual_seq_len, min_full_attn_seq_len, vec_k, vec_v};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return (int)launch_di<1>(p, chunks, row_tiles, s);
  if (D <= 64) return (int)launch_di<2>(p, chunks, row_tiles, s);
  if (D <= 128) return (int)launch_di<4>(p, chunks, row_tiles, s);
  return (int)launch_di<8>(p, chunks, row_tiles, s);
}
