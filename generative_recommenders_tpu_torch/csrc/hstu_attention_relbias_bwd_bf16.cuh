// The bfloat16 body of K7 and K7-det (`hstu_mha_relbias_bwd_bf16`,
// `hstu_mha_relbias_bwd_det_bf16`) on Hopper's bfloat16 tensor cores, for D
// and V up to 128, the tables staged (kNarrow) or read (kRead); wider heads
// keep the wide bodies of hstu_attention_wide.cuh. Replaces
// `_bwd_kernel_relbias` of
// generative_recommenders_tpu/ops/pallas/hstu_attention_relbias.py on
// bfloat16, at its rounding points:
//
//   Q = bf16(alpha q) (where alpha != 1)   dO = bf16(do bf16(1 / norm))
//   S = Q K^T + bias   sig = sigmoid(S)    P = bf16(S sig mask)
//   dS = (dO V^T) sig (1 + S (1 - sig)) mask, in float32
//   dV = P^T dO   dK = bf16(dS)^T Q   dQ = alpha bf16(dS) K
//   dts_w, dpos_w: the float32 dS summed over the heads, by bucket and by
//   diagonal
//
// every product from bfloat16 operands into float32 sums; dk and dv written
// as bfloat16, the table gradients float32. Included near the end of
// hstu_mha_relbias_bwd.cu (which holds the entry points), whose `Params`,
// `det_slot` and tiling constants it shares; the float32 body there is
// float32 only.
//
// Bound on the H100: 2 (2 D + 2 V) bytes per live row and head for q, k, v
// and dO, 2 (2 D + V) per element of dq, dk and dv and both tables read and
// written once, or 2 (3 D + 2 V) multiply-adds per live element and head at
// the card's bfloat16 rate (989 TFLOP/s). At ml-3b's layer 0 (D = V = 32)
// that is 320 operations a live element against 16 bytes a live row: the
// bytes bound it, and the time goes to the work per element (PERF.md). The
// design is the float32 body's (a block per 64-column key tile, batch row and
// group of heads keeps K and V of its group resident and walks the live
// 64-row query tiles; mask, bias and bucket once per (row, column) for the
// group; dS summed over the group's heads in registers before the table
// sums) on bfloat16:
// * Raw tiles streamed. `hstu_bf16::prescale` forms bfloat16(alpha q) and
//   bfloat16(dO / norm) once per call, into buffers the wrapper allocates;
//   the walk streams the Q and dO tiles of the next (query tile, head) step
//   by 16-byte `cp.async` into the second of two stages while this step's
//   products run (element by element where rows cannot be read in pieces of
//   8). K and V stay bfloat16 at a pitch of width + 8, so a block could hold
//   all 8 of ml-3b's heads (80 KB) and pay the work per (row, column) once
//   for them; 4 heads a block (`TilingBf16`) were faster, 8 spill their
//   accumulators and halve the grid (PERF.md). Heads of 65 to 128 take two
//   heads a block at width 128 (K and V of both and two stages in 172 KB, so
//   the copies stay double-buffered; one head a block took 6% longer, the
//   per-element work paid for one head alone), and S and dP are computed
//   once per tile pair, where the wide bodies computed them three times.
// * The five products are `mma.sync.m16n8k16` on `ldmatrix` fragments: S and
//   dP from the tiles as stored; dV += P^T dO and dK += dS^T Q with P and dS
//   as bfloat16 tiles, read by `ldmatrix.trans`, as are dO and Q; dQ = dS K
//   with K by `ldmatrix.trans` (one 8-column tile a warp at width 32, its B
//   fragments of two k-steps in one load). P and dS round to bfloat16
//   where the TPU kernel rounds them; the head sum of dS stays float32.
// * Kept from the float32 body: the per-warp copies of dts_w and the 64 x 64
//   diagonal tile of dpos_w; dead 16 x 16 parts and dead 16-row and
//   16-column steps skipped; the long walks started first; K7's dq as
//   float32 atomics into a zeroed buffer (the entry point writes it as
//   bfloat16), K7-det's dQ stored to its tile pair's slot of `dq_partial` and
//   summed by `det_sums_kernel`; LONG (the tables read through L1, each
//   step's window of dpos_w flushed at its end).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16_mma.cuh"
#include "hstu_attention.cuh"
#include "hstu_attention_wide.cuh"

namespace hstu_relbias_bwd {

// Heads a block of the bfloat16 body loops inside, per padded width; chosen
// by timing the alternatives (ops/cuda/variants.py, PERF.md)
template <int W> struct TilingBf16;
template <> struct TilingBf16<32> { static constexpr int HG = 4; };
template <> struct TilingBf16<64> { static constexpr int HG = 2; };
template <> struct TilingBf16<128> { static constexpr int HG = 2; };

int head_group_bf16(int D, int V) {
  const int w = D > V ? D : V;
  return w <= 32 ? TilingBf16<32>::HG : w <= 64 ? TilingBf16<64>::HG : TilingBf16<128>::HG;
}

// Bytes: K and V of HG heads and two (Q, dO) stages, bfloat16 at a pitch of
// w + 8; P and dS bfloat16 [64][72]; dS summed over the heads, float32
// [64][72]; both tables, dpos_w's sums and one copy of dts_w's sums per warp,
// float32 (LONG: the copies alone, of the reachable buckets).
__host__ __device__ constexpr long long smem_bytes_bf16(int w, int hg, long long n_pos, long long n_ts) {
  return 2LL * (2 * hg + 4) * kT * (w + kPad) + 2LL * 2 * kT * kSP + 4LL * kT * kSP +
         4 * (2 * n_pos + (1 + kWarps) * n_ts);
}
__host__ __device__ constexpr long long smem_bytes_bf16_long(int w, int hg, int n_ts) {
  return smem_bytes_bf16(w, hg, 0, 0) + 4LL * kWarps * (n_ts < hstu_wide::kTsSlots ? n_ts : hstu_wide::kTsSlots);
}

// W: the padded head width (32, 64 or 128); HG: heads per block; DET: K7-det's
// pass; LONG: the tables read. `p` after the pre-scaling pass: q is
// bfloat16(alpha q) and dout bfloat16(dO / norm).
template <int W, int HG, bool DET, bool LONG>
__global__ void __launch_bounds__(kThreads, 1) relbias_bwd_bf16_kernel(Params<__nv_bfloat16> p) {
  using bf16 = __nv_bfloat16;
  constexpr int P = W + kPad;  // pitch of the Q, K, V and dO tiles, in elements
  constexpr int KS = W / 16;   // k-steps of S and dP over a head's width
  constexpr int NA = W / 16;   // 8-column tiles per warp of dK or dV
  constexpr int NQ = W / 32;   // and of dQ
  static_assert(NA % 2 == 0 && (NQ == 1 || NQ % 2 == 0), "fragments are loaded two 8-column tiles at a time");
  extern __shared__ __align__(16) float relbias_bf16_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(relbias_bf16_smem);  // [HG][64][P]
  bf16* Vs = Ks + HG * kT * P;                              // [HG][64][P]
  bf16* stages = Vs + HG * kT * P;                          // 2 x { Q [64][P], dO [64][P] }
  bf16* Ps = stages + 4 * kT * P;                           // [64][72]
  bf16* dSs = Ps + kT * kSP;                                // [64][72]
  float* Ts = reinterpret_cast<float*>(dSs + kT * kSP);     // [64][72]: dS summed over the heads
  const int n_pos = 2 * p.Nm - 1, n_ts = p.NB + 1;
  // LONG: the buckets a float32 time gap reaches, the last slot bucket NB
  const int n_slots = LONG ? min(n_ts, hstu_wide::kTsSlots) : n_ts;
  float* pos_s = Ts + kT * kSP;  // pos_w [2 Nm - 1]
  float* ts_s = pos_s + n_pos;   // ts_w [NB + 1]
  float* dpos_s = ts_s + n_ts;   // dpos_w's sums [2 Nm - 1]
  // dts_w's sums, one copy per warp (LONG: right after the tiles)
  float* dts_s = LONG ? Ts + kT * kSP : dpos_s + n_pos;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp >> 2, wc = warp & 3;  // S, dP, dQ: query rows wr 16 .. + 16
  // warps 0..7 sum dV, warps 8..15 dK: key rows am 16 .. + 16 of the tile,
  // output columns an .. + W / 2
  const bool dv_warp = warp < kWarps / 2;
  const int am = (warp & 7) >> 1, an = (warp & 1) * (W / 2);
  // the index counts the key tile last: every row's first tile (the longest
  // walk) starts before any row's second
  const int block = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int groups = (p.H + HG - 1) / HG;
  const int col0 = block / (groups * p.B) * kT;
  const int h0 = block % groups * HG;
  const int nh = min(HG, p.H - h0);  // heads of this group
  const int b = block / groups % p.B;
  const int length = min(p.lengths[b], p.N);
  const int nt = p.num_targets ? p.num_targets[b] : 0;
  // DET: the block's row of `partial`
  float* prow = DET ? p.partial + (long long)block * (n_pos + n_ts) : nullptr;

  float acc[HG][NA][4];
#pragma unroll
  for (int hh = 0; hh < HG; ++hh)
#pragma unroll
    for (int j = 0; j < NA; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[hh][j][c] = 0.f;

  if (col0 < length) {
    const bf16* qb = p.q + b * p.q_sb + h0 * p.q_sh;
    const bf16* kb = p.k + b * p.k_sb + h0 * p.k_sh;
    const bf16* vb = p.v + b * p.v_sb + h0 * p.v_sh;
    const bf16* ob = p.dout + b * p.do_sb + h0 * p.do_sh;
    const float* tsb = p.ts + (long long)b * p.N;
    for (int hh = 0; hh < nh; ++hh) {
      hstu_bf16::load_rows<W, P, kT, kThreads>(Ks + hh * kT * P, kb + hh * p.k_sh, p.k_sn, col0, length, p.D,
                                               p.vec_k != 0);
      hstu_bf16::load_rows<W, P, kT, kThreads>(Vs + hh * kT * P, vb + hh * p.v_sh, p.v_sn, col0, length, p.V,
                                               p.vec_v != 0);
    }
    if constexpr (LONG) {
      if (DET)  // the steps add to the row's dpos_w entries
        for (int idx = threadIdx.x; idx < n_pos; idx += kThreads) prow[idx] = 0.f;
    } else {
      for (int idx = threadIdx.x; idx < n_pos; idx += kThreads) {
        pos_s[idx] = p.pos_w[idx];
        dpos_s[idx] = 0.f;
      }
      for (int idx = threadIdx.x; idx < n_ts; idx += kThreads) ts_s[idx] = p.ts_w[idx];
    }
    for (int idx = threadIdx.x; idx < kWarps * n_slots; idx += kThreads) dts_s[idx] = 0.f;
    float* my_dts = dts_s + warp * n_slots;
    const int cols = min(kT, length - col0);
    const int col_steps = (cols + 15) / 16;  // 16-column steps of the key tile
    // causal without contextual rows: earlier query tiles see none of this
    // key tile, and the walk starts at its own tile
    const bool lower_only = p.causal != 0 && p.contextual_seq_len == 0;
    const int row_first = lower_only ? col0 : 0;
    // DET: the batch row's dQ slots
    const int tiles = (p.N + kT - 1) / kT;
    float* dq_slots = DET ? p.dq_partial + (long long)b * det_pairs(tiles, lower_only) * kT * p.H * p.D : nullptr;
    // no targets and no window either (the research models): the mask is
    // col <= row below the length
    const bool plain_causal = lower_only && nt == 0 && p.max_attn_len == 0;
    // the step's Q and dO tiles: query rows r0 .. + 64 of head hh into stage `st`
    auto load_step = [&](int r0, int hh, int st) {
      bf16* Q = stages + st * 2 * kT * P;
      hstu_bf16::load_rows<W, P, kT, kThreads>(Q, qb + hh * p.q_sh, p.q_sn, r0, length, p.D, p.vec_q != 0);
      hstu_bf16::load_rows<W, P, kT, kThreads>(Q + kT * P, ob + hh * p.do_sh, p.do_sn, r0, length, p.V,
                                               p.vec_do != 0);
    };
    load_step(row_first, 0, 0);
    cp_async_commit();
    __syncthreads();  // the tables are in place

    // the key-side timestamps of the thread's four columns
    float tk[4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = col0 + wc * 16 + j * 8 + 2 * t + c;
        tk[j * 2 + c] = col < p.N ? tsb[col] : 0.f;
      }

    int step = 0;
    for (int row0 = row_first; row0 < length; row0 += kT) {
      const int row_steps = (min(kT, length - row0) + 15) / 16;
      // on the diagonal tile pair: the first query rows that see the warp's
      // key rows, and the last key columns that the warp's query rows see
      const int row_step_first = lower_only ? max(col0 + am * 16 - row0, 0) / 16 : 0;
      const int my_col_steps = lower_only ? min(col_steps, (row0 + wr * 16 + 15 - col0) / 16 + 1) : col_steps;
      // mask, bias and bucket of the thread's 8 elements of the 64 x 64 tile
      // pair, once for every head: element e = 4 j + c is row
      // wr 16 + g + 8 (c / 2), column wc 16 + 8 j + 2 t + c % 2
      float bias[8], dssum[8];
      unsigned buckets[4];  // two 16-bit bucket indices each
      unsigned ok_bits = 0;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + wr * 16 + g + 8 * i;
        // row r reads the next position's timestamp (the last position's at
        // the last row), whether or not it lies past the row's length
        const float tq = row < p.N ? tsb[min(row + 1, p.N - 1)] : 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * i + c;
            const int col = col0 + wc * 16 + j * 8 + 2 * t + c;
            const bool ok =
                row < length && col < length &&
                (plain_causal ? col <= row
                              : hstu::valid_elem(row, col, length, nt, p.causal != 0, p.max_attn_len,
                                                 p.contextual_seq_len, p.min_full_attn_seq_len, /*guard=*/true));
            int bucket = hstu::ts_bucket(tq, tk[j * 2 + c], p.NB);
            if constexpr (LONG) {
              bias[e] = __ldg(p.pos_w + hstu::pos_index(row, col, p.Nm)) + __ldg(p.ts_w + bucket);
              bucket = min(bucket, n_slots - 1);  // its slot
            } else {
              bias[e] = pos_s[hstu::pos_index(row, col, p.Nm)] + ts_s[bucket];
            }
            dssum[e] = 0.f;
            ok_bits |= (ok ? 1u : 0u) << e;
            if (e % 2 == 0) buckets[e / 2] = (unsigned)bucket;
            else buckets[e / 2] |= (unsigned)bucket << 16;
          }
      }
      // the warp's 16 x 16 part of S holds no live element: no products, no
      // sigmoid, zeros to P and dS
      const bool dead = __all_sync(kFull, ok_bits == 0);

#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        if (hh < nh) {
          const bf16* Qs = stages + (step & 1) * 2 * kT * P;
          const bf16* dOs = Qs + kT * P;
          const bf16* Kh = Ks + hh * kT * P;
          const bf16* Vh = Vs + hh * kT * P;
          cp_async_wait_all();
          // this step's Q and dO are in place, and every warp is done with
          // the previous step's tiles
          __syncthreads();
          {  // the next step's Q and dO, into the other stage
            int nrow = row0, nhh = hh + 1;
            if (nhh >= nh) {
              nhh = 0;
              nrow = row0 + kT;
            }
            if (nrow < length) load_step(nrow, nhh, (step + 1) & 1);
            cp_async_commit();
          }

          // S = Q K^T and dP = dO V^T: the warp's 16 x 16 part
          float s[2][4], dp[2][4];
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
          if (!dead) {
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
              uint32_t a[4], kf[4];
              hstu_bf16::ldsm(a, hstu_bf16::a_at(Qs, P, wr * 16, ks * 16));
              hstu_bf16::ldsm(kf, hstu_bf16::b_nk_at(Kh, P, wc * 16, ks * 16));
              hstu_bf16::mma(s[0], a, kf[0], kf[1]);
              hstu_bf16::mma(s[1], a, kf[2], kf[3]);
            }
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
              uint32_t a[4], vf[4];
              hstu_bf16::ldsm(a, hstu_bf16::a_at(dOs, P, wr * 16, ks * 16));
              hstu_bf16::ldsm(vf, hstu_bf16::b_nk_at(Vh, P, wc * 16, ks * 16));
              hstu_bf16::mma(dp[0], a, vf[0], vf[1]);
              hstu_bf16::mma(dp[1], a, vf[2], vf[3]);
            }
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float pv[4], ds[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int e = 4 * j + c;
              pv[c] = ds[c] = 0.f;
              if ((ok_bits >> e) & 1u) {
                const float x = s[j][c] + bias[e];
                const float sig = __fdividef(1.f, 1.f + __expf(-x));
                pv[c] = x * sig;
                ds[c] = dp[j][c] * sig * (1.f + x * (1.f - sig));
                dssum[e] += ds[c];
              }
            }
            // the products take P and dS in bfloat16
            const int at = (wr * 16 + g) * kSP + wc * 16 + j * 8 + 2 * t;
            *reinterpret_cast<uint32_t*>(Ps + at) = hstu_bf16::pack(pv[0], pv[1]);
            *reinterpret_cast<uint32_t*>(Ps + at + 8 * kSP) = hstu_bf16::pack(pv[2], pv[3]);
            *reinterpret_cast<uint32_t*>(dSs + at) = hstu_bf16::pack(ds[0], ds[1]);
            *reinterpret_cast<uint32_t*>(dSs + at + 8 * kSP) = hstu_bf16::pack(ds[2], ds[3]);
          }
          __syncthreads();  // P and dS are whole

          {  // dV += P^T dO or dK += dS^T Q, over the live 16-row steps
            const bf16* A = dv_warp ? Ps : dSs;
            const bf16* Bm = dv_warp ? dOs : Qs;
#pragma unroll
            for (int ks = 0; ks < kT / 16; ++ks) {
              if (ks < row_step_first || ks >= row_steps) continue;
              uint32_t a[4];
              hstu_bf16::ldsm_t(a, hstu_bf16::a_t_at(A, kSP, am * 16, ks * 16));
#pragma unroll
              for (int j = 0; j < NA; j += 2) {
                uint32_t bf[4];
                hstu_bf16::ldsm_t(bf, hstu_bf16::b_kn_at(Bm, P, ks * 16, an + j * 8));
                hstu_bf16::mma(acc[hh][j], a, bf[0], bf[1]);
                hstu_bf16::mma(acc[hh][j + 1], a, bf[2], bf[3]);
              }
            }
          }
          {
            // dQ = dS K: the warp's query rows wr 16 .. + 16 and output
            // columns wc W / 4 .. + W / 4, over the live 16-column steps (an
            // odd count rounded up: dS is 0 past them)
            float dq[NQ][4];
#pragma unroll
            for (int j = 0; j < NQ; ++j)
#pragma unroll
              for (int c = 0; c < 4; ++c) dq[j][c] = 0.f;
            if constexpr (NQ == 1) {
#pragma unroll
              for (int ks = 0; ks < kT / 16; ks += 2) {
                if (ks >= my_col_steps) continue;
                uint32_t a[4], kf[4];
                hstu_bf16::ldsm_t(kf, hstu_bf16::b_kn_pair_at(Kh, P, ks * 16, wc * 8));
                hstu_bf16::ldsm(a, hstu_bf16::a_at(dSs, kSP, wr * 16, ks * 16));
                hstu_bf16::mma(dq[0], a, kf[0], kf[1]);
                hstu_bf16::ldsm(a, hstu_bf16::a_at(dSs, kSP, wr * 16, ks * 16 + 16));
                hstu_bf16::mma(dq[0], a, kf[2], kf[3]);
              }
            } else {
#pragma unroll
              for (int ks = 0; ks < kT / 16; ++ks) {
                if (ks >= my_col_steps) continue;
                uint32_t a[4], kf[4];
                hstu_bf16::ldsm(a, hstu_bf16::a_at(dSs, kSP, wr * 16, ks * 16));
#pragma unroll
                for (int j = 0; j < NQ; j += 2) {
                  hstu_bf16::ldsm_t(kf, hstu_bf16::b_kn_at(Kh, P, ks * 16, wc * (W / 4) + j * 8));
                  hstu_bf16::mma(dq[j], a, kf[0], kf[1]);
                  hstu_bf16::mma(dq[j + 1], a, kf[2], kf[3]);
                }
              }
            }
            // dead rows keep the buffer's zeros (K7-det: are not written).
            // Where D is a multiple of 4 a lane pair trades halves, so that
            // each lane adds four floats of one row at once: the even lane row
            // g, the odd lane row g + 8. K7 adds to dq's rows with atomics;
            // K7-det stores the tile pair's rows to its slot
            const bool odd = (t & 1) != 0;
            float* dqh = p.dq + ((long long)b * p.N * p.H + h0 + hh) * p.D;
            // K7-det: the slot's row of query row `row`, less row0
            const long long slot_row = DET ? det_slot(row0 / kT, col0 / kT, tiles, lower_only) * kT - row0 : 0;
            auto dq_at = [&](int row, int d) {
              if constexpr (DET)
                return dq_slots + ((slot_row + row) * p.H + h0 + hh) * p.D + d;
              else
                return dqh + (long long)row * p.H * p.D + d;
            };
#pragma unroll
            for (int j = 0; j < NQ; ++j) {
              const float r0 = __shfl_xor_sync(kFull, odd ? dq[j][0] : dq[j][2], 1);
              const float r1 = __shfl_xor_sync(kFull, odd ? dq[j][1] : dq[j][3], 1);
              if (p.D % 4 == 0) {
                const int row = row0 + wr * 16 + g + (odd ? 8 : 0);
                const int d = wc * (W / 4) + j * 8 + 2 * (t & ~1);
                if (row < length && d < p.D) {
                  const float4 x = odd ? make_float4(r0, r1, dq[j][2], dq[j][3])
                                       : make_float4(dq[j][0], dq[j][1], r0, r1);
                  float4* at = reinterpret_cast<float4*>(dq_at(row, d));
                  const float4 ax = make_float4(p.alpha * x.x, p.alpha * x.y, p.alpha * x.z, p.alpha * x.w);
                  if constexpr (DET)
                    *at = ax;
                  else
                    atomicAdd(at, ax);
                }
              } else {
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                  const int row = row0 + wr * 16 + g + 8 * (c / 2);
                  const int d = wc * (W / 4) + j * 8 + 2 * t + c % 2;
                  if (row < length && d < p.D) {
                    float* at = dq_at(row, d);
                    if constexpr (DET)
                      *at = p.alpha * dq[j][c];
                    else
                      atomicAdd(at, p.alpha * dq[j][c]);
                  }
                }
              }
            }
          }
          ++step;
        }
      }

      // The tile pair's dS, summed over the group's heads, into the block's
      // table sums: dts_w by the warp's distinct buckets in turn, summed by
      // shuffles into the warp's own copy; dpos_w through a 64 x 64 tile,
      // each diagonal summed by four threads.
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool ok = (ok_bits >> e) & 1u;
        const int key = (int)((buckets[e / 2] >> (16 * (e % 2))) & 0xffffu);
        unsigned rest = __ballot_sync(kFull, ok);
        while (rest != 0) {
          const int first = __ffs(rest) - 1;
          const int bucket = __shfl_sync(kFull, key, first);
          const bool mine = ok && key == bucket;
          float sum = mine ? dssum[e] : 0.f;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
          if (lane == first) my_dts[bucket] += sum;
          __syncwarp();
          rest &= ~__ballot_sync(kFull, mine);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int at = (wr * 16 + g) * kSP + wc * 16 + j * 8 + 2 * t;
        *reinterpret_cast<float2*>(Ts + at) = make_float2(dssum[4 * j], dssum[4 * j + 1]);
        *reinterpret_cast<float2*>(Ts + at + 8 * kSP) = make_float2(dssum[4 * j + 2], dssum[4 * j + 3]);
      }
      __syncthreads();  // the next write of Ts follows the next step's barrier
      // DET: each diagonal's sum, in the P and dS tiles (every warp is past
      // its products)
      float* diag = reinterpret_cast<float*>(Ps);
      {
        // diagonal dd holds the elements with col - row = dd - 63
        const int dd = threadIdx.x >> 2, part = threadIdx.x & 3;
        float sum = 0.f;
        for (int r = part; r < kT; r += 4) {
          const int c = r + dd - (kT - 1);
          if (c >= 0 && c < kT) sum += Ts[r * kSP + c];
        }
        sum += __shfl_xor_sync(kFull, sum, 1);
        sum += __shfl_xor_sync(kFull, sum, 2);
        if constexpr (DET) {
          if (part == 0) diag[dd] = sum;
        } else {
          // diagonals clipped to one entry (N > Nm) meet here: an atomic
          // (LONG: the step's window of dpos_w, straight to device memory)
          if (part == 0 && sum != 0.f)
            atomicAdd((LONG ? p.dpos : dpos_s) + hstu::pos_index(row0 + kT - 1, col0 + dd, p.Nm), sum);
        }
      }
      if constexpr (DET) {
        // each run of diagonals that meet on one entry (one diagonal, or
        // those clipped where N > Nm) summed in order by one thread
        __syncthreads();
        const int dd = threadIdx.x, last = row0 + kT - 1;
        const int idx = hstu::pos_index(last, col0 + dd, p.Nm);
        if (dd < 2 * kT - 1 && (dd == 0 || hstu::pos_index(last, col0 + dd - 1, p.Nm) != idx)) {
          float sum = 0.f;
          for (int e = dd; e < 2 * kT - 1 && hstu::pos_index(last, col0 + e, p.Nm) == idx; ++e) sum += diag[e];
          (LONG ? prow : dpos_s)[idx] += sum;
        }
      }
    }

    __syncthreads();
    // LONG: slot s of dts_w's copies holds bucket s, the last one bucket NB
    auto slot_of = [&](int idx) { return idx < n_slots - 1 ? idx : (idx == p.NB ? n_slots - 1 : -1); };
    if constexpr (DET) {  // the block's row of `partial`: every entry, zeros where untouched
      if constexpr (!LONG)
        for (int idx = threadIdx.x; idx < n_pos; idx += kThreads) prow[idx] = dpos_s[idx];
      for (int idx = threadIdx.x; idx < n_ts; idx += kThreads) {
        const int s = LONG ? slot_of(idx) : idx;
        float sum = 0.f;
        if (s >= 0)
          for (int w = 0; w < kWarps; ++w) sum += dts_s[w * n_slots + s];
        prow[n_pos + idx] = sum;
      }
    } else {
      if constexpr (!LONG) {
        // the block's live elements span the diagonals [lo, hi]
        const int lo = hstu::pos_index(length - 1, col0, p.Nm);
        const int hi = hstu::pos_index(0, col0 + cols - 1, p.Nm);
        for (int idx = lo + threadIdx.x; idx <= hi; idx += kThreads) {
          const float sum = dpos_s[idx];
          if (sum != 0.f) atomicAdd(p.dpos + idx, sum);
        }
      }
      for (int idx = threadIdx.x; idx < n_slots; idx += kThreads) {
        float sum = 0.f;
        for (int w = 0; w < kWarps; ++w) sum += dts_s[w * n_slots + idx];
        if (sum != 0.f) atomicAdd(p.dts + (LONG && idx == n_slots - 1 ? p.NB : idx), sum);
      }
    }
  } else if constexpr (DET) {  // a dead key tile's row of `partial` holds zeros
    const int n = 2 * p.Nm - 1 + p.NB + 1;
    for (int idx = threadIdx.x; idx < n; idx += kThreads) p.partial[(long long)block * n + idx] = 0.f;
  }

  // every element of dk and dv is written: zeros where the tile is dead
  bf16* out = dv_warp ? p.dv : p.dk;
  const int width = dv_warp ? p.V : p.D;
#pragma unroll
  for (int hh = 0; hh < HG; ++hh) {
    if (hh >= nh) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int col = col0 + am * 16 + g + 8 * i;
      if (col >= p.N) continue;
      bf16* dst = out + (((long long)b * p.N + col) * p.H + h0 + hh) * width;
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        const int d = an + j * 8 + 2 * t;
        const float x0 = acc[hh][j][2 * i], x1 = acc[hh][j][2 * i + 1];
        if (d + 1 < width && width % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dst + d) = __floats2bfloat162_rn(x0, x1);
        } else {
          if (d < width) dst[d] = __float2bfloat16_rn(x0);
          if (d + 1 < width) dst[d + 1] = __float2bfloat16_rn(x1);
        }
      }
    }
  }
}

template <int W, int HG, bool DET, bool LONG>
cudaError_t launch_bf16_w(const Params<__nv_bfloat16>& p, cudaStream_t stream) {
  const long long smem =
      LONG ? smem_bytes_bf16_long(W, HG, p.NB + 1) : smem_bytes_bf16(W, HG, 2LL * p.Nm - 1, p.NB + 1LL);
  if (smem > hstu_wide::kMaxShared) return cudaErrorInvalidValue;
  auto kernel = relbias_bwd_bf16_kernel<W, HG, DET, LONG>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.N + kT - 1) / kT, (p.H + HG - 1) / HG, p.B);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  kernel<<<grid, kThreads, (size_t)smem, stream>>>(p);
  return cudaGetLastError();
}

// The pre-scaling pass into the wrapper's p.qs and p.dos, then this body on
// `route` (kNarrow: the tables staged; kRead: read, LONG) at width 32, 64 or
// 128.
template <bool DET>
int launch_bf16(const Params<__nv_bfloat16>& p, int route, cudaStream_t s) {
  if (p.D > 128 || p.V > 128 || (route != hstu::kNarrow && route != hstu::kRead)) return (int)cudaErrorInvalidValue;
  Params<__nv_bfloat16> r = p;
  const cudaError_t err = hstu_bf16::prescale(r, s);
  if (err != cudaSuccess) return (int)err;
  const bool read = route == hstu::kRead;
  if (p.D <= 32 && p.V <= 32) {
    constexpr int HG = TilingBf16<32>::HG;
    return (int)(read ? launch_bf16_w<32, HG, DET, true>(r, s) : launch_bf16_w<32, HG, DET, false>(r, s));
  }
  if (p.D <= 64 && p.V <= 64) {
    constexpr int HG = TilingBf16<64>::HG;
    return (int)(read ? launch_bf16_w<64, HG, DET, true>(r, s) : launch_bf16_w<64, HG, DET, false>(r, s));
  }
  constexpr int HG = TilingBf16<128>::HG;
  return (int)(read ? launch_bf16_w<128, HG, DET, true>(r, s) : launch_bf16_w<128, HG, DET, false>(r, s));
}

}  // namespace hstu_relbias_bwd
