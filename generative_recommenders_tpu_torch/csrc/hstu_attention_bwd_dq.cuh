// HSTU attention backward for Hopper (sm_90a) on the tensor cores, float32
// in and out: the body of K3 (hstu_mha_bwd_dq.cu), dQ alone, which with K4
// (hstu_mha_bwd_dkv.cu) makes the deterministic split backward. Replaces the
// Pallas TPU kernel `_bwd_dq_kernel` of
// generative_recommenders_tpu/ops/pallas/hstu_attention.py. With RELBIAS it
// is also the dq pass of K7-det (hstu_mha_relbias_bwd.cu), the fixed-order
// backward of `_bwd_kernel_relbias` (hstu_attention_relbias.py), which keeps
// dq in VMEM over a sequential grid: S gains the relative bias, per (row,
// column) `pos_w[pos_index] + ts_w[ts_bucket]` of hstu_attention.cuh, with
// both tables and the batch row's timestamps in shared memory as K6 holds
// them; in float32 and on bfloat16 q, k, v and dO (T = __nv_bfloat16, K7's
// bfloat16 rounding points: dO enters as bfloat16(dO / norm), dS is rounded
// to bfloat16 before dQ = dS K, whose float32 sum is written as bfloat16;
// products one exact TF32 `mma` each).
//
// Per head, with S recomputed from Q and K (the forward saves only q, k, v):
//
//   S = alpha Q K^T (+ bias)   sig = sigmoid(S)   dOn = dO / norm
//   dS = (dOn V^T) * sig (1 + S (1 - sig)) * mask   dQ = alpha dS K
//
// with the mask `valid_elem` of hstu_attention.cuh, length guard on, so rows
// at or past a row's length get exact zero gradients.
//
// Bound on the H100: per live mask element and head K3 does 2 D + V
// multiply-adds against 4 (D + V) bytes of q, k, v and dO per live row and
// head and 4 D bytes of dq per row. At the ranker's widths (D = V = 128) and
// the tensor cores' 3xTF32 rate (a third of dense TF32, 165 TFLOP/s) the
// operations bound it at N = 1036 (chip_smoke.py prints both). The design is
// that of K2 and K4 (hstu_attention_bwd_dkv.cuh) read the other way:
// * Tensor cores with float32 accuracy: the three S-sized products (S, dP and
//   dQ) run as `mma.sync.m16n8k8` TF32 with the 3xTF32 split of tf32_mma.cuh.
//   Each tile pair's share of dQ goes into fresh accumulators that are added
//   to the walk's sum in float32 (the tensor cores' accumulator truncates).
// * One block of 16 warps per (query tile, head, batch row) keeps its Q and
//   dO tiles in shared memory and its dQ rows in registers, and walks the
//   live key tiles. Per key tile each warp computes a 16-row part of S and
//   dP = dO V^T and writes dS to shared memory; then each warp sums
//   dQ += dS K for its 16 query rows and a range of output columns.
// * Loads in flight: the next key tile's K and V arrive by `cp.async` into
//   the second of two stages while this tile's products run, in 16-byte
//   pieces where the rows allow it and in 4-byte ones where they do not (the
//   wrapper decides: on the STU path q, k and v are strided views of one
//   projection); 1 / norm is applied to dP on use.
// * Dead work is skipped. A causal walk stops at the key tile that holds the
//   query tile's last row once every row of the tile is past the contextual
//   rows (which see every column below the target boundary); the tile that
//   holds contextual rows walks every key tile below the length. A warp whose
//   part of S holds no live element skips its products and sigmoids; dQ
//   skips the warp's rows if no live element of the step reaches them and,
//   on a causal walk, the key columns past them. Blocks are numbered so that
//   the long walks (a row's last query tiles) start first.
// * No atomics, and the walk in a fixed order: the same bits on every run, as
//   the deterministic backward needs. Every element of dq is written, zeros
//   at dead rows and at rows in [length, N).
// Head widths are padded with zero columns to W = 32, 64, 128 or 256 (V to at
// most 128). `Tiling` sets per width the query rows of a block and the key
// columns of a step, so that Q, dO, two stages of K and V and dS fit a
// block's shared memory (at width 256 a step takes 32 key columns, else 64:
// at width 128 64 columns were faster on the H100 than 32, and than 32 rows
// by 64 columns or 128 rows by 32); heads are not grouped (with RELBIAS
// the bias is rebuilt per head: the simple first form of K7-det's dq pass).
// The element type T of q, k, v, dO and dq is a parameter of the body: float,
// and __nv_bfloat16 for K7-det's bfloat16 dq pass.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "hstu_attention.cuh"
#include "tf32_mma.cuh"

namespace hstu_bwd_dq {

using namespace hstu_tf32;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxShared = 232448;
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;

template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  const T* dout;
  T* dq;                   // contiguous [B, N, H, D]
  const int* lengths;      // int32 [B]
  const int* num_targets;  // int32 [B] or null (no targets)
  int B, N, H, D, V;
  long long q_sb, q_sn, q_sh;
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  long long do_sb, do_sn, do_sh;
  float alpha, inv_norm;
  int causal, max_attn_len, contextual_seq_len, min_full_attn_seq_len;
  int vec_q, vec_k, vec_v, vec_do;  // rows readable in 16-byte pieces
  // the relative bias (RELBIAS) only
  const float* ts = nullptr;     // float32 [B, N] timestamps, contiguous
  const float* pos_w = nullptr;  // float32 [2 Nm - 1]
  const float* ts_w = nullptr;   // float32 [NB + 1]
  int Nm = 0, NB = 0;
};

// Per padded width W: query rows per block (BQ), key columns per step (BK),
// 8-column tiles of dQ summed side by side into fresh accumulators (NG).
template <int W> struct Tiling;
template <> struct Tiling<32> { static constexpr int BQ = 64, BK = 64, NG = 1; };
template <> struct Tiling<64> { static constexpr int BQ = 64, BK = 64, NG = 2; };
template <> struct Tiling<128> { static constexpr int BQ = 64, BK = 64, NG = 4; };
template <> struct Tiling<256> { static constexpr int BQ = 64, BK = 32, NG = 4; };

// Q [BQ][W + 8] and dO [BQ][WV + 8], resident; two stages of K [BK][W + 8]
// and V [BK][WV + 8]; dS [BQ][BK + 8]; the step's live flags of the 16-row
// groups of the query tile; with the relative bias `tables` more floats (both
// tables and the batch row's timestamps).
template <int W>
__host__ __device__ constexpr int smem_bytes(int tables = 0) {
  constexpr int WV = W < 128 ? W : 128, BQ = Tiling<W>::BQ, BK = Tiling<W>::BK;
  return 4 * ((BQ + 2 * BK) * (W + 8 + WV + 8) + BQ * (BK + 8) + BQ / 16 + tables);
}

// T: the element type; W: the padded head width; RELBIAS: K7-det's dq pass,
// the relative bias added to S.
template <typename T, int W, bool RELBIAS>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(Params<T> p) {
  constexpr bool kBf16 = !std::is_same<T, float>::value;
  // float32: alpha and 1 / norm applied to S and dP on use; bfloat16: folded
  // into the Q and dO tiles, rounded, as the TPU kernels round alpha q and
  // dO / norm
  const float s_alpha = kBf16 ? 1.f : p.alpha, dp_scale = kBf16 ? 1.f : p.inv_norm;
  const float q_scale = kBf16 && p.alpha != 1.f ? round_bf16(p.alpha) : 1.f;
  const float do_scale = kBf16 ? round_bf16(p.inv_norm) : 1.f;
  using Tl = Tiling<W>;
  constexpr int BQ = Tl::BQ, BK = Tl::BK, NG = Tl::NG;
  constexpr int WV = W < 128 ? W : 128;
  constexpr int PK = W + 8;   // pitch of the Q and K tiles
  constexpr int PV = WV + 8;  // of the dO and V tiles
  constexpr int PS = BK + 8;  // of dS
  constexpr int STAGE = BK * (PK + PV);
  // S and dP: a warp owns 16 query rows and NA 8-column tiles of the key tile
  constexpr int RG = BQ / 16, CA = kWarps / RG, NA = BK / 8 / CA;
  // dQ: a warp owns S's 16 query rows and NQ 8-column tiles, in groups of NG
  constexpr int NQ = W / 8 / CA;
  static_assert(RG * CA == kWarps && NA >= 1 && NA * CA * 8 == BK, "S's columns split evenly over the warps");
  static_assert(NQ >= 1 && NQ * CA * 8 == W && NQ % NG == 0, "dQ's columns split evenly over the warps");
  static_assert(smem_bytes<W>() <= kMaxShared, "the tiles fit a block's shared memory");

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                // [BQ][PK]
  float* dOs = Qs + BQ * PK;       // [BQ][PV]
  float* stages = dOs + BQ * PV;   // 2 x { K [BK][PK], V [BK][PV] }
  float* dSs = stages + 2 * STAGE;  // [BQ][PS]
  int* row_live = reinterpret_cast<int*>(dSs + BQ * PS);  // [RG]
  float* pos_s = reinterpret_cast<float*>(row_live + RG);  // RELBIAS: pos_w [2 Nm - 1]
  float* ts_s = pos_s + 2 * p.Nm - 1;                       // RELBIAS: ts_w [NB + 1]
  float* tk_s = ts_s + p.NB + 1;                            // RELBIAS: the row's timestamps [N]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp / CA, wc = warp % CA;  // query rows wr 16 .. + 16
  // Blocks start in the order of their index. A query tile's walk is the
  // longer the later the tile is in its row, so the index counts the query
  // tile last and from the end: every row's last tile starts before any
  // row's second to last, and the short walks fill the end of the launch.
  const int n_qt = (p.N + BQ - 1) / BQ;
  const int row0 = (n_qt - 1 - (int)blockIdx.x / (p.H * p.B)) * BQ;
  const int h = (int)blockIdx.x % p.H;
  const int b = (int)blockIdx.x / p.H % p.B;
  const int length = min(p.lengths[b], p.N);
  const int nt = p.num_targets ? p.num_targets[b] : 0;

  float acc[NQ][4];
#pragma unroll
  for (int j = 0; j < NQ; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  if (row0 < length) {
    const T* qb = p.q + b * p.q_sb + h * p.q_sh;
    const T* kb = p.k + b * p.k_sb + h * p.k_sh;
    const T* vb = p.v + b * p.v_sb + h * p.v_sh;
    const T* ob = p.dout + b * p.do_sb + h * p.do_sh;
    const bool causal = p.causal != 0;
    const int ctx = p.contextual_seq_len;
    // causal: a row past the contextual rows sees no column past itself
    const int kv_end = causal && row0 >= ctx ? min(length, row0 + BQ) : length;
    // no contextual rows, targets or window: the mask is col <= row
    const bool plain_causal = causal && ctx == 0 && nt == 0 && p.max_attn_len == 0;
    const int r_first = row0 + wr * 16;
    // the step's K and V tiles: key columns c0 .. + BK into stage `st`
    auto load_step = [&](int c0, int st) {
      float* K = stages + st * STAGE;
      load_tile<W, PK, BK, kThreads>(K, kb, p.k_sn, c0, length, p.D, p.vec_k != 0);
      load_tile<WV, PV, BK, kThreads>(K + BK * PK, vb, p.v_sn, c0, length, p.V, p.vec_v != 0);
    };
    if constexpr (kBf16) {  // alpha q and dO / norm, rounded to bfloat16
      load_tile<W, PK, BQ, kThreads>(Qs, qb, p.q_sn, row0, length, p.D, p.vec_q != 0, q_scale);
      load_tile<WV, PV, BQ, kThreads>(dOs, ob, p.do_sn, row0, length, p.V, p.vec_do != 0, do_scale);
    } else {
      load_tile<W, PK, BQ, kThreads>(Qs, qb, p.q_sn, row0, length, p.D, p.vec_q != 0);
      load_tile<WV, PV, BQ, kThreads>(dOs, ob, p.do_sn, row0, length, p.V, p.vec_do != 0);
    }
    load_step(0, 0);
    cp_async_commit();
    // a flag holds step + 1 where the step has a live element in the row group
    if (threadIdx.x < RG) row_live[threadIdx.x] = 0;
    // RELBIAS: the tables and the key-side timestamps, in place after the
    // first step's barrier; the thread's two rows read the next position's
    // timestamp (the last position's at the last row), whether or not it lies
    // past the row's length
    float tq[2] = {0.f, 0.f};
    if constexpr (RELBIAS) {
      const float* tsb = p.ts + (long long)b * p.N;
      for (int idx = threadIdx.x; idx < 2 * p.Nm - 1; idx += kThreads) pos_s[idx] = p.pos_w[idx];
      for (int idx = threadIdx.x; idx <= p.NB; idx += kThreads) ts_s[idx] = p.ts_w[idx];
      for (int idx = threadIdx.x; idx < kv_end; idx += kThreads) tk_s[idx] = tsb[idx];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r_first + g + 8 * i;
        if (row < p.N) tq[i] = tsb[min(row + 1, p.N - 1)];
      }
    }

    for (int step = 0, col0 = 0; col0 < kv_end; ++step, col0 += BK) {
      const float* Ks = stages + (step & 1) * STAGE;
      const float* Vs = Ks + BK * PK;
      const int live = step + 1;
      cp_async_wait_all();
      // this step's K and V are in place, and every warp is done with the
      // previous step's tiles, dS and flags
      __syncthreads();
      if (col0 + BK < kv_end) load_step(col0 + BK, (step + 1) & 1);  // into the other stage
      cp_async_commit();

      {  // S and dP: the warp's 16 x 8 NA part; dS to shared memory.
        // Element e = 4 j + c is row wr 16 + g + 8 (c / 2), column
        // wc 8 NA + 8 j + 2 t + c % 2 of the tile pair
        unsigned ok_bits = 0;
#pragma unroll
        for (int j = 0; j < NA; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int row = r_first + g + 8 * (c >> 1);
            const int col = col0 + (wc * NA + j) * 8 + 2 * t + (c & 1);
            const bool ok =
                row < length && col < length &&
                (plain_causal ? col <= row
                              : hstu::valid_elem(row, col, length, nt, causal, p.max_attn_len, ctx,
                                                 p.min_full_attn_seq_len, /*guard=*/true));
            ok_bits |= (ok ? 1u : 0u) << (4 * j + c);
          }
        // the warp's part holds no live element (above the diagonal, past the
        // length, outside a window): no products, no sigmoid, zeros to dS
        const bool dead = __all_sync(kFull, ok_bits == 0);
        float s[NA][4], dp[NA][4];
#pragma unroll
        for (int j = 0; j < NA; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
        if (!dead) {
#pragma unroll
          for (int ks = 0; ks < W / 8; ++ks) {
            const FragA a = load_a(Qs, PK, wr * 16, ks * 8);
#pragma unroll
            for (int j = 0; j < NA; ++j) mma<kBf16>(s[j], a, load_b_nk(Ks, PK, (wc * NA + j) * 8, ks * 8));
          }
#pragma unroll
          for (int ks = 0; ks < WV / 8; ++ks) {
            const FragA a = load_a(dOs, PV, wr * 16, ks * 8);
#pragma unroll
            for (int j = 0; j < NA; ++j) mma<kBf16>(dp[j], a, load_b_nk(Vs, PV, (wc * NA + j) * 8, ks * 8));
          }
          if (lane == 0) row_live[wr] = live;
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
                const int row = r_first + g + 8 * (c >> 1);
                const int col = col0 + (wc * NA + j) * 8 + 2 * t + (c & 1);
                x = fmaf(s[j][c], s_alpha,
                         pos_s[hstu::pos_index(row, col, p.Nm)] +
                             ts_s[hstu::ts_bucket(tq[c >> 1], tk_s[col], p.NB)]);
              }
              const float sig = __fdividef(1.f, 1.f + __expf(-x));
              ds[c] = dp[j][c] * dp_scale * sig * (1.f + x * (1.f - sig));
            }
            if constexpr (kBf16) ds[c] = round_bf16(ds[c]);  // dQ = dS K takes dS in bfloat16
          }
          const int at = (wr * 16 + g) * PS + (wc * NA + j) * 8 + 2 * t;
          *reinterpret_cast<float2*>(dSs + at) = make_float2(ds[0], ds[1]);
          *reinterpret_cast<float2*>(dSs + at + 8 * PS) = make_float2(ds[2], ds[3]);
        }
      }
      __syncthreads();  // dS and the flags are whole

      // dQ += dS K for the warp's query rows, if a live element of the step
      // reaches them, and its NQ 8-column tiles. On a causal walk rows past
      // the contextual ones see no column past the warp's last row
      if (row_live[wr] == live) {
        const int col_steps = (min(BK, length - col0) + 7) / 8;
        const int my_col_steps =
            causal && r_first >= ctx ? min(col_steps, (r_first + 15 - col0) / 8 + 1) : col_steps;
#pragma unroll
        for (int n0 = 0; n0 < NQ; n0 += NG) {
          const int d0 = (wc * NQ + n0) * 8;
          if (d0 >= p.D) continue;  // pad columns alone
          // the tile pair's share in registers of its own, added to the
          // walk's sum by a float32 add
          float part[NG][4];
#pragma unroll
          for (int n = 0; n < NG; ++n)
#pragma unroll
            for (int c = 0; c < 4; ++c) part[n][c] = 0.f;
          for (int ks = 0; ks < my_col_steps; ++ks) {
            const FragA a = load_a(dSs, PS, wr * 16, ks * 8);
#pragma unroll
            for (int n = 0; n < NG; ++n) mma<kBf16>(part[n], a, load_b_kn<true>(Ks, PK, ks * 8, d0 + n * 8));
          }
#pragma unroll
          for (int n = 0; n < NG; ++n)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[n0 + n][c] += part[n][c];
        }
      }
    }
  }

  // every element of the block's rows of dq is written: zeros at rows past
  // the length and where the tile is dead
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + wr * 16 + g + 8 * i;
    if (row >= p.N) continue;
    const bool in = row < length;
    T* dst = p.dq + (((long long)b * p.N + row) * p.H + h) * p.D;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int d = (wc * NQ + j) * 8 + 2 * t;
      const float x0 = in ? p.alpha * acc[j][2 * i] : 0.f;
      const float x1 = in ? p.alpha * acc[j][2 * i + 1] : 0.f;
      if (d + 1 < p.D && p.D % 2 == 0) {
        if constexpr (kBf16)
          *reinterpret_cast<__nv_bfloat162*>(dst + d) = __floats2bfloat162_rn(x0, x1);
        else
          *reinterpret_cast<float2*>(dst + d) = make_float2(x0, x1);
      } else {
        if (d < p.D) dst[d] = T(x0);
        if (d + 1 < p.D) dst[d + 1] = T(x1);
      }
    }
  }
}

template <typename T, int W, bool RELBIAS>
cudaError_t launch_w(const Params<T>& p, cudaStream_t stream) {
  const int smem = smem_bytes<W>(RELBIAS ? 2 * p.Nm - 1 + p.NB + 1 + p.N : 0);
  if (smem > kMaxShared) return cudaErrorInvalidValue;
  auto kernel = dq_kernel<T, W, RELBIAS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)((p.N + Tiling<W>::BQ - 1) / Tiling<W>::BQ) * p.H * (long long)p.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Launches on `stream`; returns the launch's cudaGetLastError(). D is at most
// 256 and V at most 128 (the Python wrapper checks both, and decides the
// `vec_*` flags); both are padded to the next of 32, 64, 128 (256 for D).
// RELBIAS (K7-det's dq pass) takes K7's widths, D and V at most 64, and needs
// both tables and the row's timestamps to fit the block's shared memory
// beside the tiles.
template <typename T, bool RELBIAS = false>
int launch(const Params<T>& p, void* stream) {
  if (p.B == 0 || p.N == 0 || p.H == 0) return 0;
  if (p.D < 1 || p.D > 256 || p.V < 1 || p.V > 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = p.D > p.V ? p.D : p.V;
  if constexpr (RELBIAS) {
    if (w > 64 || p.Nm < 1 || p.NB < 0) return (int)cudaErrorInvalidValue;
    return (int)(w <= 32 ? launch_w<T, 32, true>(p, s) : launch_w<T, 64, true>(p, s));
  } else {
    if (w <= 32) return (int)launch_w<T, 32, false>(p, s);
    if (w <= 64) return (int)launch_w<T, 64, false>(p, s);
    if (w <= 128) return (int)launch_w<T, 128, false>(p, s);
    return (int)launch_w<T, 256, false>(p, s);
  }
}

}  // namespace hstu_bwd_dq
