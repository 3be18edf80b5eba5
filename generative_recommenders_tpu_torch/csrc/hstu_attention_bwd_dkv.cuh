// HSTU attention backward for Hopper (sm_90a) on the tensor cores, float32
// in and out: the shared body of the fused kernel K2 (hstu_mha_bwd_fused.cu:
// dq, dk and dv) and of K4 (hstu_mha_bwd_dkv.cu: dk and dv; with K3 the
// deterministic split backward). Replaces the Pallas TPU kernels
// `_bwd_fused_kernel_rkv` and `_bwd_dkv_kernel` of
// generative_recommenders_tpu/ops/pallas/hstu_attention.py. K2 also on
// bfloat16 (E = __nv_bfloat16; K4's bfloat16 instance is not built), with
// the TPU kernel's rounding points (`_bwd_fused_kernel_rkv`): Q enters as
// bfloat16(alpha q) where alpha != 1 and dO as bfloat16(dO / norm), so S,
// dP and dS take no alpha and no 1 / norm; P is rounded to bfloat16 before
// dV = P^T dO and dS before dK = dS^T (alpha Q) and dQ = dS K; dq takes one
// alpha as it is added to its float32 buffer, which a second kernel writes
// as bfloat16; dk and dv are written as bfloat16. The bfloat16 tiles are
// converted to float32 on their way into shared memory (synchronously), and
// the products are one exact TF32 `mma` each (tf32_mma.cuh).
//
// Per head, with S recomputed from Q and K (the forward saves only q, k, v):
//
//   S = alpha Q K^T   sig = sigmoid(S)   P = S sig mask
//   dV = P^T dO / norm     dS = (dO V^T / norm) * sig (1 + S (1 - sig)) * mask
//   dK = alpha dS^T Q      dQ = alpha dS K   (K2 only)
//
// with the mask `valid_elem` of hstu_attention.cuh, length guard on, so rows
// and columns at or past a row's length get exact zero gradients.
//
// Bound on the H100: per live mask element and head K2 does 3 D + 2 V
// multiply-adds, K4 2 D + 2 V, against 4 (D + V) bytes of q, k, v and dO per
// live row and head. At the ranker's widths (D = V = 128) and the tensor
// cores' 3xTF32 rate (a third of dense TF32, 165 TFLOP/s) the bytes bound K2
// at the training length (N = 268) and the operations bound K4 at N = 1036
// (chip_smoke.py prints both). The design is K7's (hstu_mha_relbias_bwd.cu)
// without the bias:
// * Tensor cores with float32 accuracy: the four (K4) or five (K2) S-sized
//   products run as `mma.sync.m16n8k8` TF32 with the 3xTF32 split of
//   tf32_mma.cuh. Each tile pair's share of dK and dV goes into fresh
//   accumulators that are added to the walk's sum in float32 (the tensor
//   cores' accumulator truncates).
// * One block of 16 warps per (key tile, head, batch row) keeps its K and V
//   tiles in shared memory and its dK and dV rows in registers, and walks the
//   live query tiles. Per query tile each warp computes a 16-row part of S and
//   dP = dO V^T and writes P and dS to shared memory; then each warp sums
//   dV += P^T dO or dK += dS^T Q for 16 key rows and a range of output
//   columns; in K2 each warp then forms its part of the tile's dQ share dS K.
// * Loads in flight: the next query tile's Q and dO arrive by `cp.async` into
//   the second of two stages while this tile's products run, in 16-byte
//   pieces where the rows allow it and in 4-byte ones where they do not (the
//   wrapper decides: on the STU path q, k and v are strided views of one
//   projection); 1 / norm is applied to dP and dV on use.
// * Dead work is skipped. A warp whose part of S holds no live element skips
//   its products and sigmoids. dV / dK skip key rows that no live element of
//   the tile reaches and, on a causal walk, the query rows below them; dQ
//   skips query rows that no live element reaches and, on a causal walk, the
//   key columns past them. A causal walk visits the query tiles of the
//   contextual rows (which see every column below the target boundary), then
//   those from the key tile's own on. Blocks are numbered so that the long
//   walks (a row's first key tiles) start first.
// * K2 adds dQ into the zeroed buffer with atomics, four floats of a row at
//   once where D is a multiple of 4 (a lane pair trades halves of its two rows
//   first): with 64-column key tiles a dq row gets at most N / 64 shares.
//   dK and dV use no atomics and sum the walk in a fixed order: K4, and K2's
//   dk and dv, give the same bits on every run; K2's dq may vary in its last
//   bits.
// Head widths are padded with zero columns to W = 32, 64, 128 or 256 (V to at
// most 128). `Tiling` sets per width the query rows of a step, so that K and
// V, two stages of Q and dO, P and dS fit a block's shared memory; heads are
// not grouped.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "hstu_attention.cuh"
#include "tf32_mma.cuh"

namespace hstu_bwd_dkv {

using namespace hstu_tf32;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxShared = 232448;
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;

// E: float, or __nv_bfloat16; typed pointers (untyped ones cast in the
// kernel cost K7 120 more bytes of spills).
template <typename E>
struct Params {
  const E* q;
  const E* k;
  const E* v;
  const E* dout;
  float* dq;  // K2: contiguous [B, N, H, D], a zeroed float32 accumulation buffer; K4: null
  E* dk;      // contiguous [B, N, H, D]
  E* dv;      // contiguous [B, N, H, V]
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
};

// Per padded width W: query rows per step (BQ), key columns per block (BK),
// 8-column output tiles of dV / dK summed side by side (NG).
template <int W> struct Tiling;
template <> struct Tiling<32> { static constexpr int BQ = 64, BK = 64, NG = 2; };
template <> struct Tiling<64> { static constexpr int BQ = 64, BK = 64, NG = 4; };
template <> struct Tiling<128> { static constexpr int BQ = 32, BK = 64, NG = 4; };
template <> struct Tiling<256> { static constexpr int BQ = 32, BK = 64, NG = 4; };

// K [BK][W + 8] and V [BK][WV + 8], resident; two stages of Q [BQ][W + 8] and
// dO [BQ][WV + 8]; P and dS [BQ][BK + 8]; the step's live flags of the 16-row
// groups of the query tile and the 8-column groups of the key tile.
template <int W>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int WV = W < 128 ? W : 128, BQ = Tiling<W>::BQ, BK = Tiling<W>::BK;
  return 4 * ((BK + 2 * BQ) * (W + 8 + WV + 8) + 2 * BQ * (BK + 8) + BQ / 16 + BK / 8);
}

// W: the padded head width; FUSED: K2 (dQ too); E: the type of q, k, v, dO,
// dk and dv (float, or __nv_bfloat16).
template <int W, bool FUSED, typename E>
__global__ void __launch_bounds__(kThreads, 1) dkv_kernel(Params<E> p) {
  using T = Tiling<W>;
  constexpr bool kBf16 = !std::is_same<E, float>::value;
  // float32: alpha and 1 / norm applied to S, dP and dV on use; bfloat16:
  // folded into the Q and dO tiles, rounded, as the TPU kernel rounds alpha q
  // and dO / norm (each scalar itself in bfloat16, a weakly typed Python
  // float)
  const float s_alpha = kBf16 ? 1.f : p.alpha, dp_scale = kBf16 ? 1.f : p.inv_norm;
  const float q_scale = kBf16 && p.alpha != 1.f ? round_bf16(p.alpha) : 1.f;
  const float do_scale = kBf16 ? round_bf16(p.inv_norm) : 1.f;
  constexpr int BQ = T::BQ, BK = T::BK, NG = T::NG;
  constexpr int WV = W < 128 ? W : 128;
  constexpr int PK = W + 8;   // pitch of the Q and K tiles
  constexpr int PV = WV + 8;  // of the dO and V tiles
  constexpr int PS = BK + 8;  // of P and dS
  constexpr int STAGE = BQ * (PK + PV);
  // S and dP: a warp owns 16 query rows and NA 8-column tiles of the key tile
  constexpr int CA = kWarps / (BQ / 16), NA = BK / 8 / CA;
  // dV and dK side by side, one [BK][WV + W] output: a warp owns 16 key rows
  // and GB groups of NG 8-column tiles
  constexpr int CB = kWarps / (BK / 16), NVT = WV / 8, GB = (NVT + W / 8) / NG / CB;
  // dQ: a warp owns S's 16 query rows and NQ 8-column tiles
  constexpr int NQ = W / 8 / CA;
  static_assert(NA >= 1 && NA * CA * 8 == BK, "S's columns split evenly over the warps");
  static_assert(GB >= 1 && GB * NG * CB == NVT + W / 8 && NVT % NG == 0,
                "dV's and dK's columns split evenly over the warps");
  static_assert(NQ >= 1 && NQ * CA * 8 == W, "dQ's columns split evenly over the warps");
  static_assert(smem_bytes<W>() <= kMaxShared, "the tiles fit a block's shared memory");

  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                // [BK][PK]
  float* Vs = Ks + BK * PK;        // [BK][PV]
  float* stages = Vs + BK * PV;    // 2 x { Q [BQ][PK], dO [BQ][PV] }
  float* Ps = stages + 2 * STAGE;  // [BQ][PS]
  float* dSs = Ps + BQ * PS;       // [BQ][PS]
  int* row_live = reinterpret_cast<int*>(dSs + BQ * PS);  // [BQ / 16]
  int* col_live = row_live + BQ / 16;                      // [BK / 8]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp / CA, wc = warp % CA;  // S, dP, dQ: query rows wr 16 .. + 16
  const int am = warp / CB, ac = warp % CB;  // dV, dK: key rows am 16 .. + 16
  // Blocks start in the order of their index. A key tile's walk is the
  // longer the nearer the tile is to the row's start, so the index counts the
  // key tile last: every row's first tile starts before any row's second,
  // and the short walks fill the end of the launch.
  const int col0 = (int)blockIdx.x / (p.H * p.B) * BK;
  const int h = (int)blockIdx.x % p.H;
  const int b = (int)blockIdx.x / p.H % p.B;
  const int length = min(p.lengths[b], p.N);
  const int nt = p.num_targets ? p.num_targets[b] : 0;

  float acc[GB * NG][4];
#pragma unroll
  for (int j = 0; j < GB * NG; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  if (col0 < length) {
    const E* qb = p.q + b * p.q_sb + h * p.q_sh;
    const E* kb = p.k + b * p.k_sb + h * p.k_sh;
    const E* vb = p.v + b * p.v_sb + h * p.v_sh;
    const E* ob = p.dout + b * p.do_sb + h * p.do_sh;
    const bool causal = p.causal != 0;
    const int ctx = p.contextual_seq_len;
    // causal: a row past the contextual rows sees no column past itself, so
    // the walk takes the query tiles of the contextual rows (which see every
    // column below the target boundary), then those from the key tile's own on
    const int ctx_end = causal ? (ctx + BQ - 1) / BQ * BQ : 0;
    auto skip_to_diagonal = [&](int r) { return causal && r >= ctx_end && r < col0 ? col0 : r; };
    // no contextual rows, targets or window: the mask is col <= row
    const bool plain_causal = causal && ctx == 0 && nt == 0 && p.max_attn_len == 0;
    const int col_steps = (min(BK, length - col0) + 7) / 8;
    // the step's Q and dO tiles: query rows r0 .. + BQ into stage `st`
    auto load_step = [&](int r0, int st) {
      float* Q = stages + st * STAGE;
      if constexpr (kBf16) {  // alpha q and dO / norm, rounded to bfloat16
        load_tile<W, PK, BQ, kThreads>(Q, qb, p.q_sn, r0, length, p.D, p.vec_q != 0, q_scale);
        load_tile<WV, PV, BQ, kThreads>(Q + BQ * PK, ob, p.do_sn, r0, length, p.V, p.vec_do != 0,
                                        do_scale);
      } else {
        load_tile<W, PK, BQ, kThreads>(Q, qb, p.q_sn, r0, length, p.D, p.vec_q != 0);
        load_tile<WV, PV, BQ, kThreads>(Q + BQ * PK, ob, p.do_sn, r0, length, p.V, p.vec_do != 0);
      }
    };
    load_tile<W, PK, BK, kThreads>(Ks, kb, p.k_sn, col0, length, p.D, p.vec_k != 0);
    load_tile<WV, PV, BK, kThreads>(Vs, vb, p.v_sn, col0, length, p.V, p.vec_v != 0);
    int row0 = skip_to_diagonal(0);
    load_step(row0, 0);
    cp_async_commit();
    // both flag arrays; a flag holds step + 1 where the step has a live element there
    if (threadIdx.x < BQ / 16 + BK / 8) row_live[threadIdx.x] = 0;

    for (int step = 0; row0 < length; ++step) {
      const int next = skip_to_diagonal(row0 + BQ);
      const float* Qs = stages + (step & 1) * STAGE;
      const float* dOs = Qs + BQ * PK;
      const int live = step + 1;
      cp_async_wait_all();
      // this step's Q and dO are in place, and every warp is done with the
      // previous step's tiles and flags
      __syncthreads();
      if (next < length) load_step(next, (step + 1) & 1);  // into the other stage
      cp_async_commit();

      {  // S and dP: the warp's 16 x 8 NA part; P and dS to shared memory.
        // Element e = 4 j + c is row wr 16 + g + 8 (c / 2), column
        // wc 8 NA + 8 j + 2 t + c % 2 of the tile pair
        unsigned ok_bits = 0;
#pragma unroll
        for (int j = 0; j < NA; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int row = row0 + wr * 16 + g + 8 * (c >> 1);
            const int col = col0 + wc * NA * 8 + j * 8 + 2 * t + (c & 1);
            const bool ok =
                row < length && col < length &&
                (plain_causal ? col <= row
                              : hstu::valid_elem(row, col, length, nt, causal, p.max_attn_len, ctx,
                                                 p.min_full_attn_seq_len, /*guard=*/true));
            ok_bits |= (ok ? 1u : 0u) << (4 * j + c);
          }
        // the warp's part holds no live element (above the diagonal, past the
        // length, outside a window): no products, no sigmoid, zeros to P and dS
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
          float pv[4], ds[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            pv[c] = ds[c] = 0.f;
            if ((ok_bits >> (4 * j + c)) & 1u) {
              const float x = s[j][c] * s_alpha;
              const float sig = __fdividef(1.f, 1.f + __expf(-x));
              pv[c] = x * sig;
              ds[c] = dp[j][c] * dp_scale * sig * (1.f + x * (1.f - sig));
            }
            if constexpr (kBf16) {  // the products take P and dS in bfloat16
              pv[c] = round_bf16(pv[c]);
              ds[c] = round_bf16(ds[c]);
            }
          }
          const int at = (wr * 16 + g) * PS + (wc * NA + j) * 8 + 2 * t;
          *reinterpret_cast<float2*>(Ps + at) = make_float2(pv[0], pv[1]);
          *reinterpret_cast<float2*>(Ps + at + 8 * PS) = make_float2(pv[2], pv[3]);
          *reinterpret_cast<float2*>(dSs + at) = make_float2(ds[0], ds[1]);
          *reinterpret_cast<float2*>(dSs + at + 8 * PS) = make_float2(ds[2], ds[3]);
          const bool any = __any_sync(kFull, ((ok_bits >> (4 * j)) & 0xfu) != 0);
          if (any && lane == 0) col_live[wc * NA + j] = live;
        }
      }
      __syncthreads();  // P, dS and the flags are whole

      // dV += P^T dO and dK += dS^T Q for the warp's key rows, if a live
      // element of the tile pair reaches them. On a causal walk the query rows
      // below the warp's first key row see none of them (contextual rows
      // excepted): the steps of the contextual rows, then those from `first` on
      if (col_live[2 * am] == live || col_live[2 * am + 1] == live) {
        const int row_steps = (min(BQ, length - row0) + 7) / 8;
        int ctx_steps = row_steps, first = 0;
        if (causal) {
          ctx_steps = row0 < ctx ? (min(ctx - row0, BQ) + 7) / 8 : 0;
          first = max(col0 + am * 16 - row0, 0) / 8;
        }
        auto next_step = [&](int ks) { return ks >= ctx_steps && ks < first ? first : ks; };
#pragma unroll
        for (int gi = 0; gi < GB; ++gi) {
          const int tile = (ac * GB + gi) * NG;  // the group's first 8-column tile of [dV | dK]
          const bool is_dv = tile < NVT;
          const int n0 = 8 * (is_dv ? tile : tile - NVT);
          if (n0 >= (is_dv ? p.V : p.D)) continue;  // pad columns alone
          const float* A = is_dv ? Ps : dSs;
          const float* Bm = is_dv ? dOs : Qs;
          const int pitch = is_dv ? PV : PK;
          // the tile pair's share in registers of its own, added to the
          // walk's sum by a float32 add
          float part[NG][4];
#pragma unroll
          for (int n = 0; n < NG; ++n)
#pragma unroll
            for (int c = 0; c < 4; ++c) part[n][c] = 0.f;
          for (int ks = next_step(0); ks < row_steps; ks = next_step(ks + 1)) {
            const FragA a = load_a_t(A, PS, am * 16, ks * 8);
#pragma unroll
            for (int n = 0; n < NG; ++n) mma<kBf16>(part[n], a, load_b_kn(Bm, pitch, ks * 8, n0 + n * 8));
          }
#pragma unroll
          for (int n = 0; n < NG; ++n)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[gi * NG + n][c] += part[n][c];
        }
      }

      // K2: dQ = dS K for the warp's query rows, if a live element reaches
      // them, and its NQ 8-column tiles. On a causal walk rows past the
      // contextual ones see no column past the warp's last row
      if (FUSED && row_live[wr] == live) {
        const int r_first = row0 + wr * 16;
        const int my_col_steps =
            causal && r_first >= ctx ? min(col_steps, (r_first + 15 - col0) / 8 + 1) : col_steps;
        float dq[NQ][4];
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) dq[j][c] = 0.f;
        for (int ks = 0; ks < my_col_steps; ++ks) {
          const FragA a = load_a(dSs, PS, wr * 16, ks * 8);
#pragma unroll
          for (int j = 0; j < NQ; ++j)
            mma<kBf16>(dq[j], a, load_b_kn<true>(Ks, PK, ks * 8, (wc * NQ + j) * 8));
        }
        // dead rows keep the buffer's zeros. Where D is a multiple of 4 a
        // lane pair trades halves, so that each lane adds four floats of one
        // row at once: the even lane row g, the odd lane row g + 8
        const bool odd = (t & 1) != 0;
        float* dqh = p.dq + ((long long)b * p.N * p.H + h) * p.D;
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const float r0 = __shfl_xor_sync(kFull, odd ? dq[j][0] : dq[j][2], 1);
          const float r1 = __shfl_xor_sync(kFull, odd ? dq[j][1] : dq[j][3], 1);
          if (p.D % 4 == 0) {
            const int row = r_first + g + (odd ? 8 : 0);
            const int d = (wc * NQ + j) * 8 + 2 * (t & ~1);
            if (row < length && d < p.D) {
              const float4 x = odd ? make_float4(r0, r1, dq[j][2], dq[j][3])
                                   : make_float4(dq[j][0], dq[j][1], r0, r1);
              atomicAdd(reinterpret_cast<float4*>(dqh + (long long)row * p.H * p.D + d),
                        make_float4(p.alpha * x.x, p.alpha * x.y, p.alpha * x.z, p.alpha * x.w));
            }
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int row = r_first + g + 8 * (c / 2);
              const int d = (wc * NQ + j) * 8 + 2 * t + c % 2;
              if (row < length && d < p.D)
                atomicAdd(dqh + (long long)row * p.H * p.D + d, p.alpha * dq[j][c]);
            }
          }
        }
      }
      row0 = next;
    }
  }

  // every element of the block's rows of dk and dv is written: zeros where
  // the tile is dead
#pragma unroll
  for (int gi = 0; gi < GB; ++gi) {
    const int tile = (ac * GB + gi) * NG;
    const bool is_dv = tile < NVT;
    const int n0 = 8 * (is_dv ? tile : tile - NVT);
    E* out = is_dv ? p.dv : p.dk;
    const int width = is_dv ? p.V : p.D;
    const float scale = is_dv ? dp_scale : s_alpha;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int col = col0 + am * 16 + g + 8 * i;
      if (col >= p.N) continue;
      E* dst = out + (((long long)b * p.N + col) * p.H + h) * width;
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        const int d = n0 + n * 8 + 2 * t;
        const float x0 = scale * acc[gi * NG + n][2 * i], x1 = scale * acc[gi * NG + n][2 * i + 1];
        if (d + 1 < width && width % 2 == 0) {
          if constexpr (kBf16)
            *reinterpret_cast<__nv_bfloat162*>(dst + d) = __floats2bfloat162_rn(x0, x1);
          else
            *reinterpret_cast<float2*>(dst + d) = make_float2(x0, x1);
        } else {
          if (d < width) dst[d] = E(x0);
          if (d + 1 < width) dst[d + 1] = E(x1);
        }
      }
    }
  }
}

template <int W, bool FUSED, typename E>
cudaError_t launch_w(const Params<E>& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes<W>();
  auto kernel = dkv_kernel<W, FUSED, E>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)((p.N + Tiling<W>::BK - 1) / Tiling<W>::BK) * p.H * (long long)p.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Launches on `stream`; returns the launch's cudaGetLastError(). D is at most
// 256 and V at most 128 (the Python wrapper checks both, and decides the
// `vec_*` flags); both are padded to the next of 32, 64, 128 (256 for D).
template <bool FUSED, typename E>
int launch(const Params<E>& p, void* stream) {
  if (p.B == 0 || p.N == 0 || p.H == 0) return 0;
  if (p.D < 1 || p.D > 256 || p.V < 1 || p.V > 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = p.D > p.V ? p.D : p.V;
  if (w <= 32) return (int)launch_w<32, FUSED, E>(p, s);
  if (w <= 64) return (int)launch_w<64, FUSED, E>(p, s);
  if (w <= 128) return (int)launch_w<128, FUSED, E>(p, s);
  return (int)launch_w<256, FUSED, E>(p, s);
}

}  // namespace hstu_bwd_dkv
