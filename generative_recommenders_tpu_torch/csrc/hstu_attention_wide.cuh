// HSTU attention at any head width for Hopper (sm_90a): the bodies that the
// kernels K1, K1-bias, K2, K3, K4, K6, K7 and K7-det take where their own
// tilings end, float32 and bfloat16. The Pallas TPU kernels of
// generative_recommenders_tpu/ops/pallas/hstu_attention.py and
// hstu_attention_relbias.py lane-pad any width and, past their VMEM gates,
// drop to 3-D-grid kernels that take any width; these bodies are the port's
// counterpart. The entry points dispatch here by shape:
// * the forward (K1, K1-bias, K6): V above 128 or D above 256;
// * the dense backward (K2, K3, K4): V above 128 or D above 256;
// * the relative-bias backward (K7, K7-det): D or V above 64.
// Every width is cut into chunks of kC = 128 columns, the last one padded
// with zeros:
// * S = alpha Q K^T and dP = dO V^T are summed over their chunks in
//   registers before the bias, silu and the mask (they do not split);
// * O, dQ, dK and dV split by column: each block owns one output chunk (a
//   dimension of the grid), and recomputes S and dP for it.
// Q (or K) and dO (or V) stay resident in shared memory where they are one
// chunk wide; wider ones are loaded chunk by chunk per tile. The products
// are `mma.sync.m16n8k8` TF32 (tf32_mma.cuh): 3xTF32 in float32, as K7's
// float32 body, and one exact TF32 product on bfloat16 values, at the
// bfloat16 rounding points of the narrow bodies (alpha q and dO / norm
// rounded on load, P and dS rounded before their products). Tables and timestamps of the relative
// bias are read through the L1 cache, never staged: a table of any length
// fits. The relative-bias backward is two passes, as K7-det:
// * `dq_kernel` with the bias: one block per (64-row query tile, head, batch
//   row, dQ chunk), dQ in registers over a walk of the key tiles, written
//   whole (no atomics);
// * `dkv_kernel` with the bias: one block per (64-column key tile, head,
//   batch row, dK or dV chunk), dK / dV in registers over a walk of the
//   query tiles; the blocks of chunk 0 also sum the table gradients, per
//   step: `dpos_w` by diagonals of the step's dS, `dts_w` per warp by
//   shuffles into the warp's copy of the reachable buckets. K7 adds both to
//   the zeroed tables with atomics; K7-det writes them to the block's row
//   of `partial`, which the relative-bias kernel sums in block order.
// The dense fused backward K2 is the same pair without the bias.
// Bound: the kernels' own (the same functions). These are simple bodies:
// loads wait, and S and dP are recomputed per output chunk; a wide
// instance is right first and slow (PERF.md has its times).
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "hstu_attention.cuh"
#include "tf32_mma.cuh"

namespace hstu_wide {

using namespace hstu_tf32;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxShared = 232448;
constexpr int kThreads = 128;     // the forward: 4 warps
constexpr int kBwdThreads = 256;  // the dq and dkv passes: 8 warps
constexpr int kC = 128;        // columns of a chunk of D or V
constexpr int kP = kC + 8;     // pitch of a chunk tile
// A float32 time gap |dt| <= FLT_MAX has floor(ln(|dt|) / 0.301) <= 294, so
// the buckets a float32 run reaches are 0 .. min(NB, 294) and NB itself (an
// infinite gap): `dts_w`'s sums need at most 296 slots whatever NB is.
constexpr int kTsSlots = 296;

enum Bias : int { kNoBias = 0, kRelBias = 1, kDenseBias = 2 };

// E: the type of q, k, v, dO, out, dk and dv (float, or __nv_bfloat16).
template <typename E>
struct Params {
  const E* q;
  const E* k;
  const E* v;
  const E* dout;
  void* out;  // the forward: E, contiguous [B, N, H, V]
  void* dq;   // the dq pass: float or E (`dq_kernel`'s DQ), contiguous [B, N, H, D]
  E* dk;      // contiguous [B, N, H, D]
  E* dv;      // contiguous [B, N, H, V]
  const int* lengths;      // int32 [B]
  const int* num_targets;  // int32 [B] or null
  int B, N, H, D, V;
  long long q_sb, q_sn, q_sh;
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  long long do_sb, do_sn, do_sh;
  float alpha, inv_norm;
  int causal, max_attn_len, contextual_seq_len, min_full_attn_seq_len;
  int vec_q, vec_k, vec_v, vec_do;  // rows readable in 16-byte pieces
  // the relative bias: float32 [B, N] timestamps, [2 Nm - 1] and [NB + 1]
  // tables; their gradients (zeroed, K7) or the blocks' rows (K7-det)
  const float* ts = nullptr;
  const float* pos_w = nullptr;
  const float* ts_w = nullptr;
  int Nm = 0, NB = 0;
  float* dpos = nullptr;
  float* dts = nullptr;
  float* partial = nullptr;  // float32 [key tiles x H x B, (2 Nm - 1) + (NB + 1)]
  // K1-bias: [B or 1, N, N], float32 or bfloat16, batch stride 0 for one
  const void* bias = nullptr;
  long long bias_sb = 0, bias_sn = 0;
  int bias_bf16 = 0;
};

__host__ __device__ constexpr int chunks(int w) { return (w + kC - 1) / kC; }

// The forward: Q [64][kP], K [32][kP], V [32][kC + 4]
constexpr int kFwdRows = 64, kFwdCols = 32;
constexpr int fwd_smem_bytes() { return 4 * (kFwdRows * kP + kFwdCols * kP + kFwdCols * (kC + 4)); }
// The dq pass: Q and dO [64][kP], K and V [32][kP], dS [64][32 + 8], the
// warps' live flags
constexpr int kDqRows = 64, kDqCols = 32;
constexpr int dq_smem_bytes() {
  return 4 * (2 * kDqRows * kP + 2 * kDqCols * kP + kDqRows * (kDqCols + 8) + kBwdThreads / 32);
}
// The dkv pass: Q and dO [32][kP], K and V [64][kP], P and dS [32][64 + 8];
// with the bias the float32 dS [32][72], the step's diagonal sums and eight
// warps' copies of `dts_w`'s sums
constexpr int kDkvRows = 32, kDkvCols = 64, kDiags = kDkvRows + kDkvCols - 1;
constexpr int dkv_smem_bytes(bool relbias) {
  return 4 * (2 * kDkvRows * kP + 2 * kDkvCols * kP + 2 * kDkvRows * (kDkvCols + 8) +
              (relbias ? kDkvRows * (kDkvCols + 8) + kDiags + 1 + kBwdThreads / 32 * kTsSlots : 0));
}
static_assert(dkv_smem_bytes(true) <= kMaxShared && dq_smem_bytes() <= kMaxShared &&
                  fwd_smem_bytes() <= kMaxShared,
              "the tiles fit a block's shared memory");

// Chunk c (columns c kC .. + kC) of one head's rows [r0, r0 + ROWS) into a
// [ROWS][P] tile: float32 asynchronously, bfloat16 converted (scaled and
// rounded where scale != 1); zeros at rows >= lim and columns >= w.
template <int P, int ROWS, int THREADS, typename E>
__device__ __forceinline__ void load_chunk(float* dst, const E* src, long long sn, int r0, int lim,
                                           int w, int c, bool vec, float scale) {
  if constexpr (std::is_same<E, float>::value)
    load_tile<kC, P, ROWS, THREADS>(dst, src + c * kC, sn, r0, lim, w - c * kC, vec);
  else
    load_tile<kC, P, ROWS, THREADS>(dst, src + c * kC, sn, r0, lim, w - c * kC, vec, scale);
}

template <typename E>
__device__ __forceinline__ bool live(const Params<E>& p, int row, int col, int length, int nt) {
  return hstu::valid_elem(row, col, length, nt, p.causal != 0, p.max_attn_len, p.contextual_seq_len,
                          p.min_full_attn_seq_len, /*guard=*/true);
}

// The relative bias of (row, col) from the tables in device memory; the
// bucket through `bucket`. tq: the row's next timestamp, tk: the column's.
template <typename E>
__device__ __forceinline__ float rel_bias(const Params<E>& p, int row, int col, float tq, float tk,
                                          int& bucket) {
  bucket = hstu::ts_bucket(tq, tk, p.NB);
  return __ldg(p.pos_w + hstu::pos_index(row, col, p.Nm)) + __ldg(p.ts_w + bucket);
}

// K1-bias: the dense bias of (row, col) as float32
template <typename E>
__device__ __forceinline__ float dense_bias(const Params<E>& p, int b, int row, int col) {
  const long long at = b * p.bias_sb + (long long)row * p.bias_sn + col;
  if (p.bias_bf16) return __bfloat162float(static_cast<const __nv_bfloat16*>(p.bias)[at]);
  return static_cast<const float*>(p.bias)[at];
}

// Row r's next timestamp (the last position's at the last row), and column
// c's; 0 past N
__device__ __forceinline__ float ts_row(const float* tsb, int row, int n) {
  return row < n ? __ldg(tsb + min(row + 1, n - 1)) : 0.f;
}
__device__ __forceinline__ float ts_col(const float* tsb, int col, int n) {
  return col < n ? __ldg(tsb + col) : 0.f;
}

// P's k-step as an A fragment, split: the C fragment of S with k in pairs
__device__ __forceinline__ FragA frag_a_c(const float (&s)[4]) {
  FragA f;
  split(s[0], f.big[0], f.small[0]);
  split(s[2], f.big[1], f.small[1]);
  split(s[1], f.big[2], f.small[2]);
  split(s[3], f.big[3], f.small[3]);
  return f;
}

// A pair of output values at columns col, col + 1 of a row of width w
template <typename T>
__device__ __forceinline__ void store2(T* dst, int col, int w, float x0, float x1) {
  if (col + 1 < w && w % 2 == 0) {
    if constexpr (std::is_same<T, float>::value)
      *reinterpret_cast<float2*>(dst + col) = make_float2(x0, x1);
    else
      *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(x0, x1);
  } else {
    if (col < w) dst[col] = T(x0);
    if (col + 1 < w) dst[col + 1] = T(x1);
  }
}

// ------------------------------------------------------------------ forward
// One block of 4 warps per (64-row query tile, head, batch row, V chunk):
// each warp owns 16 query rows. Per 32-column key tile S is summed over D's
// chunks, then P = silu(alpha S + bias) * mask stays in registers as the A
// fragment of P V (`frag_a_c`) for the block's V chunk.
template <int BIAS, typename E>
__global__ void __launch_bounds__(kThreads) fwd_kernel(Params<E> p) {
  constexpr bool kBf16 = !std::is_same<E, float>::value;
  constexpr int kRows = kFwdRows, BK = kFwdCols, NT = BK / 8, NO = kC / 8, PV = kC + 4;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;             // [64][kP]
  float* Ks = Qs + kRows * kP;  // [32][kP]
  float* Vs = Ks + BK * kP;     // [32][PV]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_dc = chunks(p.D), n_vc = chunks(p.V);
  const int n_qt = (p.N + kRows - 1) / kRows;
  // the block's index counts the V chunk first and the query tile last, from
  // the row's end: the longest walks start first
  int blk = (int)blockIdx.x;
  const int vc = blk % n_vc;
  blk /= n_vc;
  const int h = blk % p.H;
  blk /= p.H;
  const int b = blk % p.B;
  const int q0 = (n_qt - 1 - blk / p.B) * kRows;
  const int length = min(p.lengths[b], p.N);
  const int nt = p.num_targets ? p.num_targets[b] : 0;
  int kv_limit = length;
  if (p.causal && q0 >= p.contextual_seq_len) kv_limit = min(kv_limit, q0 + kRows);
  if (q0 >= length) kv_limit = 0;
  const int n_kt = (kv_limit + BK - 1) / BK;
  // bfloat16: alpha rides Q, rounded; S then takes none
  const float q_scale = kBf16 && p.alpha != 1.f ? round_bf16(p.alpha) : 1.f;
  const float s_alpha = kBf16 ? 1.f : p.alpha;
  const int row_lo = q0 + warp * 16 + g;
  const E* qb = p.q + b * p.q_sb + h * p.q_sh;
  const E* kb = p.k + b * p.k_sb + h * p.k_sh;
  const E* vb = p.v + b * p.v_sb + h * p.v_sh;
  const float* tsb = BIAS == kRelBias ? p.ts + (long long)b * p.N : nullptr;
  float tq[2] = {0.f, 0.f};
  if (BIAS == kRelBias) {
    tq[0] = ts_row(tsb, row_lo, p.N);
    tq[1] = ts_row(tsb, row_lo + 8, p.N);
  }

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  // one chunk of D: Q stays for the whole walk
  if (n_dc == 1 && n_kt > 0) load_chunk<kP, kRows, kThreads>(Qs, qb, p.q_sn, q0, length, p.D, 0, p.vec_q != 0, q_scale);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int c0 = kt * BK;
    // element e = 4 j + c is row row_lo + 8 (c / 2), column c0 + 8 j + 2 t + c % 2
    uint32_t ok_bits = 0;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok = live(p, row_lo + 8 * (c >> 1), c0 + 8 * j + 2 * t + (c & 1), length, nt);
        ok_bits |= (ok ? 1u : 0u) << (4 * j + c);
      }
    const bool dead = __all_sync(kFull, ok_bits == 0);
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
    for (int dc = 0; dc < n_dc; ++dc) {
      __syncthreads();  // every warp is done with the tiles
      if (n_dc > 1) load_chunk<kP, kRows, kThreads>(Qs, qb, p.q_sn, q0, length, p.D, dc, p.vec_q != 0, q_scale);
      load_chunk<kP, BK, kThreads>(Ks, kb, p.k_sn, c0, length, p.D, dc, p.vec_k != 0, 1.f);
      if (dc == 0) load_chunk<PV, BK, kThreads>(Vs, vb, p.v_sn, c0, length, p.V, vc, p.vec_v != 0, 1.f);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      if (!dead) {
#pragma unroll 4
        for (int ks = 0; ks < kC / 8; ++ks) {
          const FragA a = load_a(Qs, kP, warp * 16, ks * 8);
#pragma unroll
          for (int j = 0; j < NT; ++j) mma<kBf16>(s[j], a, load_b_nk(Ks, kP, j * 8, ks * 8));
        }
      }
    }
    if (dead) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int e = 4 * j + c;
        float x = 0.f;
        if ((ok_bits >> e) & 1u) {
          const int row = row_lo + 8 * (c >> 1), col = c0 + 8 * j + 2 * t + (c & 1);
          float bias = 0.f;
          if constexpr (BIAS == kRelBias) {
            int bucket;
            bias = rel_bias(p, row, col, tq[c >> 1], ts_col(tsb, col, p.N), bucket);
          } else if constexpr (BIAS == kDenseBias) {
            bias = dense_bias(p, b, row, col);
          }
          x = BIAS == kNoBias ? s[j][c] * s_alpha : fmaf(s[j][c], s_alpha, bias);
          x = __fdividef(x, 1.f + __expf(-x));
          if constexpr (kBf16) x = round_bf16(x);  // P V takes P in bfloat16
        } else {
          x = 0.f;
        }
        s[j][c] = x;
      }
    FragA pa[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) pa[j] = frag_a_c(s[j]);
    // O += P V: the tile's share in fresh accumulators, added in float32
#pragma unroll
    for (int n0 = 0; n0 < NO; n0 += 4) {
      float part[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[n][c] = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int n = 0; n < 4; ++n) mma<kBf16>(part[n], pa[j], load_b_kn<true>(Vs, PV, j * 8, (n0 + n) * 8));
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[n0 + n][c] += part[n][c];
    }
  }

  // every element of the chunk's columns in the tile's rows below N: zeros
  // where the row is dead
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_lo + 8 * i;
    if (row >= p.N) continue;
    E* o = static_cast<E*>(p.out) + (((long long)b * p.N + row) * p.H + h) * p.V;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      store2(o, vc * kC + 8 * n + 2 * t, p.V, acc[n][2 * i] * p.inv_norm, acc[n][2 * i + 1] * p.inv_norm);
  }
}

// ------------------------------------------------------------------ dq pass
// One block of 8 warps per (64-row query tile, head, batch row, dQ chunk):
// warp w owns query rows (w / 2) 16 .. + 16 and, of each 32-column key tile,
// columns (w % 2) 16 .. + 16 of S and dP, and of the block's dQ chunk
// columns (w % 2) 64 .. + 64. Per key tile S is summed over D's chunks and
// dP over V's, dS goes to shared memory, and dQ += dS K for the block's
// chunk of K. DQ: the type dq is written in (float for a float32 buffer that
// a second kernel rounds to bfloat16; else E).
template <bool RELBIAS, typename E, typename DQ>
__global__ void __launch_bounds__(kBwdThreads) dq_kernel(Params<E> p) {
  constexpr bool kBf16 = !std::is_same<E, float>::value;
  constexpr int BQ = kDqRows, BK = kDqCols, NA = BK / 16, NQ = kC / 16, PS = BK + 8, T = kBwdThreads;
  const float s_alpha = kBf16 ? 1.f : p.alpha, dp_scale = kBf16 ? 1.f : p.inv_norm;
  const float q_scale = kBf16 && p.alpha != 1.f ? round_bf16(p.alpha) : 1.f;
  const float do_scale = kBf16 ? round_bf16(p.inv_norm) : 1.f;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // [64][kP]
  float* dOs = Qs + BQ * kP;   // [64][kP]
  float* Ks = dOs + BQ * kP;   // [32][kP]
  float* Vs = Ks + BK * kP;    // [32][kP]
  float* dSs = Vs + BK * kP;   // [64][PS]
  int* part_live = reinterpret_cast<int*>(dSs + BQ * PS);  // [8]: the warps' parts of S that hold a live element

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp >> 1, wc = warp & 1;
  const int n_dc = chunks(p.D), n_vc = chunks(p.V);
  const int n_qt = (p.N + BQ - 1) / BQ;
  int blk = (int)blockIdx.x;
  const int oc = blk % n_dc;
  blk /= n_dc;
  const int h = blk % p.H;
  blk /= p.H;
  const int b = blk % p.B;
  const int row0 = (n_qt - 1 - blk / p.B) * BQ;
  const int length = min(p.lengths[b], p.N);
  const int nt = p.num_targets ? p.num_targets[b] : 0;
  const int r_first = row0 + wr * 16;

  float acc[NQ][4];
#pragma unroll
  for (int j = 0; j < NQ; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  if (row0 < length) {
    const E* qb = p.q + b * p.q_sb + h * p.q_sh;
    const E* kb = p.k + b * p.k_sb + h * p.k_sh;
    const E* vb = p.v + b * p.v_sb + h * p.v_sh;
    const E* ob = p.dout + b * p.do_sb + h * p.do_sh;
    const int kv_end = p.causal && row0 >= p.contextual_seq_len ? min(length, row0 + BQ) : length;
    const float* tsb = RELBIAS ? p.ts + (long long)b * p.N : nullptr;
    float tq[2] = {0.f, 0.f};
    if (RELBIAS) {
      tq[0] = ts_row(tsb, r_first + g, p.N);
      tq[1] = ts_row(tsb, r_first + g + 8, p.N);
    }
    if (n_dc == 1) load_chunk<kP, BQ, T>(Qs, qb, p.q_sn, row0, length, p.D, 0, p.vec_q != 0, q_scale);
    if (n_vc == 1) load_chunk<kP, BQ, T>(dOs, ob, p.do_sn, row0, length, p.V, 0, p.vec_do != 0, do_scale);
    const int steps = max(n_dc, n_vc);
    for (int col0 = 0; col0 < kv_end; col0 += BK) {
      // element e = 4 j + c is row r_first + g + 8 (c / 2), column
      // col0 + wc 16 + 8 j + 2 t + c % 2
      uint32_t ok_bits = 0;
#pragma unroll
      for (int j = 0; j < NA; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool ok =
              live(p, r_first + g + 8 * (c >> 1), col0 + wc * 16 + 8 * j + 2 * t + (c & 1), length, nt);
          ok_bits |= (ok ? 1u : 0u) << (4 * j + c);
        }
      const bool dead = __all_sync(kFull, ok_bits == 0);
      float s[NA][4], dp[NA][4];
#pragma unroll
      for (int j = 0; j < NA; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
      for (int c = 0; c < steps; ++c) {
        __syncthreads();  // every warp is done with the tiles, dS and the flags
        if (c < n_dc) {
          if (n_dc > 1) load_chunk<kP, BQ, T>(Qs, qb, p.q_sn, row0, length, p.D, c, p.vec_q != 0, q_scale);
          load_chunk<kP, BK, T>(Ks, kb, p.k_sn, col0, length, p.D, c, p.vec_k != 0, 1.f);
        }
        if (c < n_vc) {
          if (n_vc > 1) load_chunk<kP, BQ, T>(dOs, ob, p.do_sn, row0, length, p.V, c, p.vec_do != 0, do_scale);
          load_chunk<kP, BK, T>(Vs, vb, p.v_sn, col0, length, p.V, c, p.vec_v != 0, 1.f);
        }
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        if (!dead) {
          if (c < n_dc) {
#pragma unroll 4
            for (int ks = 0; ks < kC / 8; ++ks) {
              const FragA a = load_a(Qs, kP, wr * 16, ks * 8);
#pragma unroll
              for (int j = 0; j < NA; ++j) mma<kBf16>(s[j], a, load_b_nk(Ks, kP, wc * 16 + j * 8, ks * 8));
            }
          }
          if (c < n_vc) {
#pragma unroll 4
            for (int ks = 0; ks < kC / 8; ++ks) {
              const FragA a = load_a(dOs, kP, wr * 16, ks * 8);
#pragma unroll
              for (int j = 0; j < NA; ++j) mma<kBf16>(dp[j], a, load_b_nk(Vs, kP, wc * 16 + j * 8, ks * 8));
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        float ds[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ds[c] = 0.f;
          if ((ok_bits >> (4 * j + c)) & 1u) {
            float x = s[j][c] * s_alpha;
            if constexpr (RELBIAS) {
              const int row = r_first + g + 8 * (c >> 1), col = col0 + wc * 16 + 8 * j + 2 * t + (c & 1);
              int bucket;
              x = fmaf(s[j][c], s_alpha, rel_bias(p, row, col, tq[c >> 1], ts_col(tsb, col, p.N), bucket));
            }
            const float sig = __fdividef(1.f, 1.f + __expf(-x));
            ds[c] = dp[j][c] * dp_scale * sig * (1.f + x * (1.f - sig));
          }
          if constexpr (kBf16) ds[c] = round_bf16(ds[c]);  // dQ = dS K takes dS in bfloat16
        }
        const int at = (wr * 16 + g) * PS + wc * 16 + j * 8 + 2 * t;
        *reinterpret_cast<float2*>(dSs + at) = make_float2(ds[0], ds[1]);
        *reinterpret_cast<float2*>(dSs + at + 8 * PS) = make_float2(ds[2], ds[3]);
      }
      if (lane == 0) part_live[warp] = !dead;
      __syncthreads();  // dS and the flags are whole, and every warp is past its reads of K
      if (n_dc > 1 && oc != n_dc - 1) {  // K's chunk of the block's dQ columns
        load_chunk<kP, BK, T>(Ks, kb, p.k_sn, col0, length, p.D, oc, p.vec_k != 0, 1.f);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
      }
      if (part_live[2 * wr] || part_live[2 * wr + 1]) {  // a live element in the warp's rows
        const int col_steps = (min(BK, length - col0) + 7) / 8;
#pragma unroll
        for (int n0 = 0; n0 < NQ; n0 += 4) {
          float part[4][4];
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int c = 0; c < 4; ++c) part[n][c] = 0.f;
          for (int ks = 0; ks < col_steps; ++ks) {
            const FragA a = load_a(dSs, PS, wr * 16, ks * 8);
#pragma unroll
            for (int n = 0; n < 4; ++n)
              mma<kBf16>(part[n], a, load_b_kn<true>(Ks, kP, ks * 8, wc * 64 + (n0 + n) * 8));
          }
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[n0 + n][c] += part[n][c];
        }
      }
    }
  }

  // every element of the chunk's columns in the tile's rows: zeros at rows
  // past the length
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_first + g + 8 * i;
    if (row >= p.N) continue;
    const float scale = row < length ? p.alpha : 0.f;
    DQ* dst = static_cast<DQ*>(p.dq) + (((long long)b * p.N + row) * p.H + h) * p.D;
#pragma unroll
    for (int j = 0; j < NQ; ++j)
      store2(dst, oc * kC + wc * 64 + 8 * j + 2 * t, p.D, scale * acc[j][2 * i], scale * acc[j][2 * i + 1]);
  }
}

// ----------------------------------------------------------------- dkv pass
// One block of 8 warps per (64-column key tile, head, batch row, output
// chunk): chunks 0 .. n_vc - 1 are dV's, the rest dK's. Per 32-row query
// step warp w computes rows (w / 4) 16 .. + 16 by columns (w % 4) 16 .. + 16
// of S (summed over D's chunks) and dP (over V's) and writes P and dS to
// shared memory; then it sums dV += P^T dO or dK += dS^T Q for key rows
// (w / 2) 16 .. + 16 and columns (w % 2) 64 .. + 64 of the block's chunk.
// RELBIAS: the bias added to S, and the blocks of chunk 0 sum the table
// gradients; DET: those sums to the block's row of `partial` in a fixed order.
template <bool RELBIAS, bool DET, typename E>
__global__ void __launch_bounds__(kBwdThreads) dkv_kernel(Params<E> p) {
  constexpr bool kBf16 = !std::is_same<E, float>::value;
  constexpr int BQ = kDkvRows, BK = kDkvCols, NA = 2, NO = kC / 16, PS = BK + 8, T = kBwdThreads;
  constexpr int NW = T / 32;
  const float s_alpha = kBf16 ? 1.f : p.alpha, dp_scale = kBf16 ? 1.f : p.inv_norm;
  const float q_scale = kBf16 && p.alpha != 1.f ? round_bf16(p.alpha) : 1.f;
  const float do_scale = kBf16 ? round_bf16(p.inv_norm) : 1.f;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;             // [32][kP]
  float* dOs = Qs + BQ * kP;    // [32][kP]
  float* Ks = dOs + BQ * kP;    // [64][kP]
  float* Vs = Ks + BK * kP;     // [64][kP]
  float* Ps = Vs + BK * kP;     // [32][PS]
  float* dSs = Ps + BQ * PS;    // [32][PS]
  float* Ts = dSs + BQ * PS;    // RELBIAS: dS in float32 [32][PS]
  float* diag = Ts + BQ * PS;   // RELBIAS: the step's diagonal sums [kDiags + 1]
  float* dts_s = diag + kDiags + 1;  // RELBIAS: `dts_w`'s sums, one copy per warp [8][kTsSlots]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp >> 2, wc = warp & 3;  // S and dP: query rows wr 16 .., key columns wc 16 ..
  const int am = warp >> 1, an = (warp & 1) * 64;  // dV / dK: key rows am 16 .., columns an ..
  const int n_dc = chunks(p.D), n_vc = chunks(p.V);
  int blk = (int)blockIdx.x;
  const int oc = blk % (n_vc + n_dc);
  blk /= n_vc + n_dc;
  const int h = blk % p.H;
  blk /= p.H;
  const int b = blk % p.B;
  const int kt = blk / p.B;
  const int col0 = kt * BK;
  const int length = min(p.lengths[b], p.N);
  const int nt = p.num_targets ? p.num_targets[b] : 0;
  const bool is_dv = oc < n_vc;
  const int och = is_dv ? oc : oc - n_vc;  // the chunk of dV or dK
  const bool tables = RELBIAS && oc == 0;
  const int n_pos = 2 * p.Nm - 1, n_ts = p.NB + 1;
  const int n_slots = min(n_ts, kTsSlots);
  float* prow = DET && tables ? p.partial + ((long long)kt * p.H * p.B + (long long)h * p.B + b) * (n_pos + n_ts)
                              : nullptr;

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  if (col0 < length) {
    const E* qb = p.q + b * p.q_sb + h * p.q_sh;
    const E* kb = p.k + b * p.k_sb + h * p.k_sh;
    const E* vb = p.v + b * p.v_sb + h * p.v_sh;
    const E* ob = p.dout + b * p.do_sb + h * p.do_sh;
    const float* tsb = RELBIAS ? p.ts + (long long)b * p.N : nullptr;
    if (tables) {
      for (int idx = threadIdx.x; idx < NW * kTsSlots; idx += T) dts_s[idx] = 0.f;
      if (DET)
        for (int idx = threadIdx.x; idx < n_pos; idx += T) prow[idx] = 0.f;
    }
    if (n_dc == 1) load_chunk<kP, BK, T>(Ks, kb, p.k_sn, col0, length, p.D, 0, p.vec_k != 0, 1.f);
    if (n_vc == 1) load_chunk<kP, BK, T>(Vs, vb, p.v_sn, col0, length, p.V, 0, p.vec_v != 0, 1.f);
    // the key-side timestamps of the thread's four columns
    float tk[NA][2];
#pragma unroll
    for (int j = 0; j < NA; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) tk[j][c] = RELBIAS ? ts_col(tsb, col0 + wc * 16 + 8 * j + 2 * t + c, p.N) : 0.f;
    // causal: the walk takes the query tiles of the contextual rows (which
    // see every column below the target boundary), then those from the key
    // tile's own on
    const bool causal = p.causal != 0;
    const int ctx_end = causal ? (p.contextual_seq_len + BQ - 1) / BQ * BQ : 0;
    auto skip_to_diagonal = [&](int r) { return causal && r >= ctx_end && r < col0 ? col0 : r; };
    const int steps = max(n_dc, n_vc);
    float* my_dts = dts_s + warp * kTsSlots;
    for (int r0 = skip_to_diagonal(0); r0 < length; r0 = skip_to_diagonal(r0 + BQ)) {
      // element e = 4 j + c is row r0 + wr 16 + g + 8 (c / 2), column
      // col0 + wc 16 + 8 j + 2 t + c % 2
      uint32_t ok_bits = 0;
      float bias[RELBIAS ? 4 * NA : 1];
      int slot[RELBIAS ? 4 * NA : 1];
#pragma unroll
      for (int j = 0; j < NA; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int e = 4 * j + c;
          const int row = r0 + wr * 16 + g + 8 * (c >> 1), col = col0 + wc * 16 + 8 * j + 2 * t + (c & 1);
          const bool ok = live(p, row, col, length, nt);
          ok_bits |= (ok ? 1u : 0u) << e;
          if constexpr (RELBIAS) {
            int bucket = 0;
            bias[e] = ok ? rel_bias(p, row, col, ts_row(tsb, row, p.N), tk[j][c & 1], bucket) : 0.f;
            slot[e] = min(bucket, n_slots - 1);
          }
        }
      const bool dead = __all_sync(kFull, ok_bits == 0);
      float s[NA][4], dp[NA][4];
#pragma unroll
      for (int j = 0; j < NA; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
      for (int c = 0; c < steps; ++c) {
        __syncthreads();  // every warp is done with the tiles, P, dS and the sums
        if (c < n_dc) {
          load_chunk<kP, BQ, T>(Qs, qb, p.q_sn, r0, length, p.D, c, p.vec_q != 0, q_scale);
          if (n_dc > 1) load_chunk<kP, BK, T>(Ks, kb, p.k_sn, col0, length, p.D, c, p.vec_k != 0, 1.f);
        }
        if (c < n_vc) {
          load_chunk<kP, BQ, T>(dOs, ob, p.do_sn, r0, length, p.V, c, p.vec_do != 0, do_scale);
          if (n_vc > 1) load_chunk<kP, BK, T>(Vs, vb, p.v_sn, col0, length, p.V, c, p.vec_v != 0, 1.f);
        }
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        if (!dead) {
          if (c < n_dc) {
#pragma unroll 4
            for (int ks = 0; ks < kC / 8; ++ks) {
              const FragA a = load_a(Qs, kP, wr * 16, ks * 8);
#pragma unroll
              for (int j = 0; j < NA; ++j) mma<kBf16>(s[j], a, load_b_nk(Ks, kP, wc * 16 + j * 8, ks * 8));
            }
          }
          if (c < n_vc) {
#pragma unroll 4
            for (int ks = 0; ks < kC / 8; ++ks) {
              const FragA a = load_a(dOs, kP, wr * 16, ks * 8);
#pragma unroll
              for (int j = 0; j < NA; ++j) mma<kBf16>(dp[j], a, load_b_nk(Vs, kP, wc * 16 + j * 8, ks * 8));
            }
          }
        }
      }
      float dsf[RELBIAS ? 4 * NA : 1];
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        float pv[4], ds[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int e = 4 * j + c;
          pv[c] = ds[c] = 0.f;
          if ((ok_bits >> e) & 1u) {
            const float x = RELBIAS ? fmaf(s[j][c], s_alpha, bias[RELBIAS ? e : 0]) : s[j][c] * s_alpha;
            const float sig = __fdividef(1.f, 1.f + __expf(-x));
            pv[c] = x * sig;
            ds[c] = dp[j][c] * dp_scale * sig * (1.f + x * (1.f - sig));
          }
          if constexpr (RELBIAS) dsf[e] = ds[c];
          if constexpr (kBf16) {  // the products take P and dS in bfloat16
            pv[c] = round_bf16(pv[c]);
            ds[c] = round_bf16(ds[c]);
          }
        }
        const int at = (wr * 16 + g) * PS + wc * 16 + j * 8 + 2 * t;
        *reinterpret_cast<float2*>(Ps + at) = make_float2(pv[0], pv[1]);
        *reinterpret_cast<float2*>(Ps + at + 8 * PS) = make_float2(pv[2], pv[3]);
        *reinterpret_cast<float2*>(dSs + at) = make_float2(ds[0], ds[1]);
        *reinterpret_cast<float2*>(dSs + at + 8 * PS) = make_float2(ds[2], ds[3]);
        if constexpr (RELBIAS) {
          if (tables) {
            *reinterpret_cast<float2*>(Ts + at) = make_float2(dsf[4 * j], dsf[4 * j + 1]);
            *reinterpret_cast<float2*>(Ts + at + 8 * PS) = make_float2(dsf[4 * j + 2], dsf[4 * j + 3]);
          }
        }
      }
      if constexpr (RELBIAS) {
        if (tables) {
          // dts_w: per element slot the warp takes its distinct buckets in
          // turn, sums each by shuffles, and one lane adds the sum to the
          // warp's own copy (no atomics)
#pragma unroll
          for (int e = 0; e < 4 * NA; ++e) {
            const bool ok = (ok_bits >> e) & 1u;
            const int key = slot[e];
            unsigned rest = __ballot_sync(kFull, ok);
            while (rest != 0) {
              const int first = __ffs(rest) - 1;
              const int bucket = __shfl_sync(kFull, key, first);
              const bool mine = ok && key == bucket;
              float sum = mine ? dsf[e] : 0.f;
#pragma unroll
              for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
              if (lane == first) my_dts[bucket] += sum;
              __syncwarp();
              rest &= ~__ballot_sync(kFull, mine);
            }
          }
        }
      }
      __syncthreads();  // P, dS and the float32 dS are whole

      // the output chunk's operand: dO's chunk for dV, Q's for dK
      const int have = is_dv ? n_vc - 1 : n_dc - 1;  // the chunk left in the tile
      if (och != have) {
        if (is_dv)
          load_chunk<kP, BQ, T>(dOs, ob, p.do_sn, r0, length, p.V, och, p.vec_do != 0, do_scale);
        else
          load_chunk<kP, BQ, T>(Qs, qb, p.q_sn, r0, length, p.D, och, p.vec_q != 0, q_scale);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
      }
      {  // dV += P^T dO or dK += dS^T Q for the warp's 16 key rows and 64 columns
        const float* A = is_dv ? Ps : dSs;
        const float* Bm = is_dv ? dOs : Qs;
        const int row_steps = (min(BQ, length - r0) + 7) / 8;
#pragma unroll
        for (int n0 = 0; n0 < NO; n0 += 4) {
          float part[4][4];
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int c = 0; c < 4; ++c) part[n][c] = 0.f;
          for (int ks = 0; ks < row_steps; ++ks) {
            const FragA a = load_a_t(A, PS, am * 16, ks * 8);
#pragma unroll
            for (int n = 0; n < 4; ++n) mma<kBf16>(part[n], a, load_b_kn(Bm, kP, ks * 8, an + (n0 + n) * 8));
          }
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[n0 + n][c] += part[n][c];
        }
      }
      if (tables) {
        // dpos_w: diagonal d holds the elements with col - row = d - (BQ - 1)
        const int d = threadIdx.x;
        const int last = r0 + BQ - 1;
        float sum = 0.f;
        if (d < kDiags)
          for (int r = 0; r < BQ; ++r) {
            const int cc = r + d - (BQ - 1);
            if (cc >= 0 && cc < BK) sum += Ts[r * PS + cc];
          }
        if constexpr (DET) {
          // each run of diagonals that meet on one entry (one diagonal, or
          // those clipped where N > Nm) summed in order by one thread, into
          // the block's row
          if (d < kDiags) diag[d] = sum;
          __syncthreads();
          if (d < kDiags) {
            const int idx = hstu::pos_index(last, col0 + d, p.Nm);
            if (d == 0 || hstu::pos_index(last, col0 + d - 1, p.Nm) != idx) {
              float run = 0.f;
              for (int e = d; e < kDiags && hstu::pos_index(last, col0 + e, p.Nm) == idx; ++e) run += diag[e];
              prow[idx] += run;
            }
          }
        } else {
          if (d < kDiags && sum != 0.f) atomicAdd(p.dpos + hstu::pos_index(last, col0 + d, p.Nm), sum);
        }
      }
    }
    if (tables) {
      __syncthreads();  // every warp's copy of dts_w's sums is whole
      for (int idx = threadIdx.x; idx < (DET ? n_ts : n_slots); idx += T) {
        // DET: every entry of the row; else the slots, each to its bucket
        // (slot n_slots - 1 holds bucket NB)
        const int s = DET ? (idx < n_slots - 1 ? idx : (idx == p.NB ? n_slots - 1 : -1)) : idx;
        float sum = 0.f;
        if (s >= 0)
          for (int w = 0; w < NW; ++w) sum += dts_s[w * kTsSlots + s];
        if constexpr (DET) {
          prow[n_pos + idx] = sum;
        } else {
          if (sum != 0.f) atomicAdd(p.dts + (idx == n_slots - 1 ? p.NB : idx), sum);
        }
      }
    }
  } else if (DET && tables) {  // a dead key tile's row of `partial` holds zeros
    for (int idx = threadIdx.x; idx < n_pos + n_ts; idx += T) prow[idx] = 0.f;
  }

  // every element of the chunk's columns in the tile's key rows: zeros where
  // the tile is dead
  E* out = is_dv ? p.dv : p.dk;
  const int width = is_dv ? p.V : p.D;
  const float scale = is_dv ? dp_scale : s_alpha;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int col = col0 + am * 16 + g + 8 * i;
    if (col >= p.N) continue;
    E* dst = out + (((long long)b * p.N + col) * p.H + h) * width;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      store2(dst, och * kC + an + 8 * n + 2 * t, width, scale * acc[n][2 * i], scale * acc[n][2 * i + 1]);
  }
}

// ------------------------------------------------------------------ launches
// Each returns the launch's cudaGetLastError(); a grid past CUDA's limit of
// 2^31 - 1 blocks is refused.
template <int BIAS, typename E>
cudaError_t launch_fwd(const Params<E>& p, cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes();
  auto kernel = fwd_kernel<BIAS, E>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((p.N + kFwdRows - 1) / kFwdRows) * p.H * p.B * chunks(p.V);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool RELBIAS, typename E, typename DQ>
cudaError_t launch_dq(const Params<E>& p, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes();
  auto kernel = dq_kernel<RELBIAS, E, DQ>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((p.N + kDqRows - 1) / kDqRows) * p.H * p.B * chunks(p.D);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kBwdThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The rows of K7-det's `partial` that `dkv_kernel<true, true>` writes: one
// per (key tile, head, batch row)
inline long long dkv_table_rows(int B, int N, int H) {
  return (long long)((N + kDkvCols - 1) / kDkvCols) * H * B;
}

template <bool RELBIAS, bool DET, typename E>
cudaError_t launch_dkv(const Params<E>& p, cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes(RELBIAS);
  auto kernel = dkv_kernel<RELBIAS, DET, E>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = dkv_table_rows(p.B, p.N, p.H) * (chunks(p.D) + chunks(p.V));
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kBwdThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The wide parameters from a narrow body's: the pointers, shapes, strides,
// mask scalars and `vec_*` flags (the bias fields are set by the caller).
template <typename E, typename P>
Params<E> from(const P& p) {
  Params<E> w{};
  w.q = static_cast<const E*>(p.q);
  w.k = static_cast<const E*>(p.k);
  w.v = static_cast<const E*>(p.v);
  w.lengths = p.lengths;
  w.num_targets = p.num_targets;
  w.B = p.B;
  w.N = p.N;
  w.H = p.H;
  w.D = p.D;
  w.V = p.V;
  w.q_sb = p.q_sb;
  w.q_sn = p.q_sn;
  w.q_sh = p.q_sh;
  w.k_sb = p.k_sb;
  w.k_sn = p.k_sn;
  w.k_sh = p.k_sh;
  w.v_sb = p.v_sb;
  w.v_sn = p.v_sn;
  w.v_sh = p.v_sh;
  w.alpha = p.alpha;
  w.inv_norm = p.inv_norm;
  w.causal = p.causal;
  w.max_attn_len = p.max_attn_len;
  w.contextual_seq_len = p.contextual_seq_len;
  w.min_full_attn_seq_len = p.min_full_attn_seq_len;
  w.vec_q = p.vec_q;
  w.vec_k = p.vec_k;
  w.vec_v = p.vec_v;
  return w;
}

}  // namespace hstu_wide
