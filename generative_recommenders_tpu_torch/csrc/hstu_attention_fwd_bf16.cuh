// The bfloat16 forward body of K1, K1-bias and K6 (`hstu_mha_fwd_bf16`,
// `hstu_mha_fwd_bias_bf16`, `hstu_mha_relbias_fwd_bf16`) on Hopper's
// bfloat16 tensor cores, on the narrow route and K6's tables-read route
// (the wide bodies of hstu_attention_wide.cuh keep wider heads). The
// function and the rounding points are those of the TPU kernels on
// bfloat16 (`_fwd_kernel_rkv` / `_fwd_kernel`, `_fwd_kernel_relbias`):
//
//   S = bf16(alpha Q) K^T (+ bias) in float32   P = bf16(silu(S) mask)
//   O = bf16((P V) / norm), P V summed in float32
//
// with the mask and K6's bias as the float32 body computes them
// (hstu_attention_fwd.cuh). The design:
// * Tiles stay bfloat16 in shared memory. K and V arrive raw by 16-byte
//   `cp.async` into the second of two stages while this step's products
//   run; Q is staged once per block as bfloat16(alpha q). Rows that cannot
//   be read in pieces of 8 elements (D = 25, a view at an odd offset) are
//   read element by element (bf16_mma.cuh).
// * Both products on the bfloat16 tensor cores, `mma.sync.m16n8k16` on
//   `ldmatrix` fragments (V by `ldmatrix.trans`): half the instructions of
//   the TF32 `m16n8k8` of the float32 body's bfloat16 instances, at twice
//   the rate, on tiles half as wide. P goes from S's accumulators into
//   bfloat16 pairs in registers as the A operand of P V, rounded where the
//   TPU kernel rounds it (`p.astype(v.dtype)`).
// * A grid that fills the card at jagged lengths. A walk over the keys longer
//   than the plan's chunk (`Params::chunk` key columns) is cut across blocks:
//   HSTU's output is a plain sum over the keys (no softmax maximum or
//   normaliser), so the chunks' partial P V sums simply add. Each chunk of
//   such a walk writes its float32 sums to its slice of the wrapper's
//   scratch, [chunks, B, N, H, V], and `fwd_sums_kernel` adds them in chunk
//   order and writes O: the same bits on every run. A walk of one chunk
//   writes O itself. Blocks start in the order of their index, which counts
//   the query tile last, from the row's end (the longest walks first).
// Bound on the H100: 2 (2 D + V) bytes per live row and head and 2 V per
// output element at 3.35 TB/s, or 2 (D + V) multiply-adds per live element
// and head at 989 TFLOP/s; the scratch adds 8 V bytes per element of a walk
// cut in chunks, per chunk.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16_mma.cuh"
#include "hstu_attention.cuh"
#include "hstu_attention_fwd.cuh"

namespace hstu_fwd {

// Per padded width W of the bfloat16 body: warps per block (each owns 16
// query rows), heads per block, key columns per tile, blocks an SM; each
// chosen by timing the alternatives (ops/cuda/variants.py, PERF.md).
template <int W> struct TilingBf16;
template <> struct TilingBf16<32> { static constexpr int NW = 4, HG = 2, BK = 32, MINB = 4; };
template <> struct TilingBf16<64> { static constexpr int NW = 4, HG = 1, BK = 64, MINB = 3; };
template <> struct TilingBf16<128> { static constexpr int NW = 4, HG = 1, BK = 64, MINB = 2; };
template <> struct TilingBf16<256> { static constexpr int NW = 4, HG = 1, BK = 32, MINB = 2; };

// Bytes of shared memory: Q of HG heads and two stages of a K tile and a V
// tile, bfloat16 at a pitch of their widths + 8; for K6 the tables and the
// row's timestamps up to the last key tile, float32.
template <int W>
__host__ __device__ constexpr int smem_bytes_bf16(int tables, int ts_row) {
  constexpr int WV = W < 128 ? W : 128;
  using T = TilingBf16<W>;
  return 2 * (T::HG * 16 * T::NW * (W + 8) + 2 * T::BK * (W + 8 + WV + 8)) + 4 * (tables + ts_row);
}

// The end of a query tile's walk over the keys (rows [q0, q0 + rows)): the
// length, and for causal attention the tile's last row once the tile is past
// the contextual rows (a contextual row sees every column below the target
// boundary); 0 where every row of the tile is dead.
__device__ __forceinline__ int walk_end(int q0, int rows, int length, bool causal, int ctx) {
  if (q0 >= length) return 0;
  return causal && q0 >= ctx ? min(length, q0 + rows) : length;
}

// W: the padded head width; BIAS: the bias added to S (`Bias`).
template <int W, int BIAS>
__global__ void __launch_bounds__(32 * TilingBf16<W>::NW, TilingBf16<W>::MINB) fwd_bf16_kernel(Params p) {
  using T = TilingBf16<W>;
  using bf16 = __nv_bfloat16;
  constexpr bool GT = BIAS == kRelBiasGlobal;  // the tables read from device memory
  constexpr bool RELBIAS = BIAS == kRelBias || GT, DENSE = BIAS == kDenseBias, BIASED = RELBIAS || DENSE;
  constexpr int HG = T::HG, BK = T::BK;
  constexpr int kRows = 16 * T::NW, kThreads = 32 * T::NW;
  constexpr int WV = W < 128 ? W : 128;
  constexpr int PQ = W + 8;   // pitch of the Q and K tiles, in elements
  constexpr int PV = WV + 8;  // of the V tile
  constexpr int KS = W / 16;  // k-steps of S
  constexpr int NT = BK / 8;  // 8-column tiles of S; NT / 2 k-steps of P V
  constexpr int NO = WV / 8;  // 8-column tiles of O
  constexpr int STAGE = BK * (PQ + PV);
  static_assert(NT % 2 == 0 && NO % 2 == 0, "fragments are loaded two 8-column tiles at a time");

  extern __shared__ __align__(16) float fwd_bf16_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(fwd_bf16_smem);  // [HG][kRows][PQ]
  bf16* stages = Qs + HG * kRows * PQ;                // 2 x { K [BK][PQ], V [BK][PV] }
  float* pos_s = reinterpret_cast<float*>(stages + 2 * STAGE);  // RELBIAS: pos_w [2 Nm - 1]
  float* ts_s = pos_s + 2 * p.Nm - 1;                           // RELBIAS: ts_w [NB + 1]
  float* tk_s = ts_s + p.NB + 1;                                // RELBIAS: the row's timestamps

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // the block's index counts the head group first, then the batch row, the
  // chunk and the query tile, from the row's end
  const int groups = (p.H + HG - 1) / HG;
  const int n_qt = (p.N + kRows - 1) / kRows;
  const int n_ch = (p.N + p.chunk - 1) / p.chunk;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / ((unsigned)groups * p.B * n_ch))) * kRows;
  const int ch = (int)(blockIdx.x / ((unsigned)groups * p.B)) % n_ch;
  const int b = (int)(blockIdx.x / (unsigned)groups) % p.B;
  const int h0 = (int)(blockIdx.x % (unsigned)groups) * HG;
  const int nh = min(HG, p.H - h0);  // heads of this group
  const int length = min(p.lengths[b], p.N);
  const int nt = p.num_targets ? p.num_targets[b] : 0;
  const bool causal = p.causal != 0;
  const int n_kt = (walk_end(q0, kRows, length, causal, p.contextual_seq_len) + BK - 1) / BK;
  const int ck = p.chunk / BK;                 // key tiles a chunk
  const int chunks = (n_kt + ck - 1) / ck;     // of this tile's walk; 0 where every row is dead
  if (ch > 0 && ch >= chunks) return;          // past the walk (chunk 0 writes a dead tile's zeros)
  const int kt_begin = ch * ck, kt_end = min(n_kt, kt_begin + ck);
  // no targets, no window, no contextual rows: the mask is col <= row
  const bool plain_causal = causal && p.contextual_seq_len == 0 && nt == 0 && p.max_attn_len == 0;
  const int row_lo = q0 + warp * 16 + g;  // the thread's rows: row_lo, row_lo + 8
  // alpha rides the Q tile, rounded to bfloat16 as the TPU kernel rounds
  // alpha q (the scalar itself in bfloat16, as JAX's weakly typed Python
  // float); S takes no alpha
  const float q_scale = p.alpha != 1.f ? round_bf16(p.alpha) : 1.f;
  // `valid_elem` (length guard on) cut into what depends on the row alone,
  // once per block, and what depends on the column
  const int ctx = p.contextual_seq_len, mal = p.max_attn_len;
  const int max_ids = length - (ctx > 0 ? ctx - 1 : 0) - nt;
  auto fold = [&](int x) { return min(ctx > 0 ? max(x - ctx + 1, 0) : x, max_ids); };
  int rr[2];
  bool row_live[2], row_full[2], row_ctx[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_lo + 8 * i;
    rr[i] = fold(row);
    row_live[i] = row < length;
    row_full[i] = p.min_full_attn_seq_len > 0 && rr[i] >= max_ids - p.min_full_attn_seq_len;
    row_ctx[i] = ctx > 0 && rr[i] == 0;
  }

  float acc[HG][NO][4];
#pragma unroll
  for (int hh = 0; hh < HG; ++hh)
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[hh][j][c] = 0.f;

  if (kt_end > kt_begin) {
    const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h0 * p.q_sh;
    const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + h0 * p.k_sh;
    const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + h0 * p.v_sh;
    const float* tsb = RELBIAS ? p.ts + (long long)b * p.N : nullptr;
    // the step's K and V tiles: step (kt, hh) into stage `st`
    auto load_step = [&](int kt, int hh, int st) {
      bf16* K = stages + st * STAGE;
      hstu_bf16::load_rows<W, PQ, BK, kThreads>(K, kb + hh * p.k_sh, p.k_sn, kt * BK, length, p.D,
                                                p.vec_k != 0);
      hstu_bf16::load_rows<WV, PV, BK, kThreads>(K + BK * PQ, vb + hh * p.v_sh, p.v_sn, kt * BK, length,
                                                 p.V, p.vec_v != 0);
    };
    for (int hh = 0; hh < nh; ++hh) {  // Q of the group's heads, alpha q rounded to bfloat16
      bf16* Q = Qs + hh * kRows * PQ;
      if (q_scale != 1.f)
        hstu_bf16::load_rows_scaled<W, PQ, kRows, kThreads>(Q, qb + hh * p.q_sh, p.q_sn, q0, length, p.D,
                                                            p.vec_q != 0, q_scale);
      else
        hstu_bf16::load_rows<W, PQ, kRows, kThreads>(Q, qb + hh * p.q_sh, p.q_sn, q0, length, p.D,
                                                     p.vec_q != 0);
    }
    load_step(kt_begin, 0, 0);
    cp_async_commit();
    if (RELBIAS && !GT) {  // visible after the barrier before the first key tile's bias
      for (int idx = threadIdx.x; idx < 2 * p.Nm - 1; idx += kThreads) pos_s[idx] = p.pos_w[idx];
      for (int idx = threadIdx.x; idx <= p.NB; idx += kThreads) ts_s[idx] = p.ts_w[idx];
      for (int idx = kt_begin * BK + threadIdx.x; idx < kt_end * BK; idx += kThreads)
        tk_s[idx] = idx < p.N ? tsb[idx] : 0.f;
    }
    // RELBIAS: the timestamps the thread's two rows read, the next
    // position's (the last position's at the last row)
    float tq[2] = {0.f, 0.f};
    if (RELBIAS) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row_lo + 8 * i;
        if (row < p.N) tq[i] = tsb[min(row + 1, p.N - 1)];
      }
    }

    int step = 0;
    for (int kt = kt_begin; kt < kt_end; ++kt) {
      const int c0 = kt * BK;
      // mask and bias of the thread's elements of the warp's 16 x BK part of
      // the tile, once for every head: element e = 4 j + c is row
      // row_lo + 8 (c / 2), column c0 + 8 j + 2 t + c % 2
      float bias[BIASED ? NT * 4 : 1];
      if (RELBIAS && kt == kt_begin) __syncthreads();  // the tables and timestamps are in place
      // the warp's 16 x BK part lies wholly inside the mask (the common case)
      const int r_first = q0 + warp * 16, c_last = c0 + BK - 1;
      const bool interior =
          causal && r_first + 15 < length && c_last < length &&
          (plain_causal ? c_last < r_first
                        : fold(c_last) < fold(r_first) &&
                              (mal == 0 || fold(c0) >= fold(r_first + 15) - mal));
      uint32_t ok_bits = ~0u;  // BK <= 64: NT * 4 <= 32 bits
      if (!interior) {
        ok_bits = 0;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int row = row_lo + 8 * (c >> 1);
            const int col = c0 + 8 * j + 2 * t + (c & 1);
            bool ok;
            if (plain_causal) {
              ok = row < length && col <= row;
            } else {
              const int i = c >> 1, cc = fold(col);
              int dist = rr[i] - cc;
              if (!causal) dist = abs(dist);
              ok = dist > 0 || row == col;
              if (mal > 0) ok = ok && (dist <= mal || row_full[i]);
              if (ctx > 0) ok = ok || (row_ctx[i] && cc < max_ids);
              ok = ok && row_live[i] && col < length;
            }
            ok_bits |= (ok ? 1u : 0u) << (4 * j + c);
          }
        }
      }
      if (RELBIAS) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int row = row_lo + 8 * (c >> 1);
            const int col = c0 + 8 * j + 2 * t + (c & 1);
            if constexpr (GT)
              bias[4 * j + c] = __ldg(p.pos_w + hstu::pos_index(row, col, p.Nm)) +
                                __ldg(p.ts_w + hstu::ts_bucket(tq[c >> 1], col < p.N ? __ldg(tsb + col) : 0.f,
                                                               p.NB));
            else
              bias[RELBIAS ? 4 * j + c : 0] = pos_s[hstu::pos_index(row, col, p.Nm)] +
                                              ts_s[hstu::ts_bucket(tq[c >> 1], tk_s[col], p.NB)];
          }
      }
      // the warp's part of the tile holds no live element: no products
      const bool dead = __all_sync(kFull, ok_bits == 0);
      if constexpr (DENSE) {
        // the bias of the thread's elements, two neighbouring columns of a
        // row a load; nothing is read for a dead part, nor past the length
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = row_lo + 8 * i;
          const bool live = !dead && row < length;
          const long long at = b * p.bias_sb + (long long)row * p.bias_sn;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int col = c0 + 8 * j + 2 * t;
            const float2 x = live ? load_bias2(p, at + col, col < length, col + 1 < length)
                                  : make_float2(0.f, 0.f);
            bias[4 * j + 2 * i] = x.x;
            bias[4 * j + 2 * i + 1] = x.y;
          }
        }
      }

#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        if (hh < nh) {
          const bf16* Ks = stages + (step & 1) * STAGE;
          const bf16* Vs = Ks + BK * PQ;
          cp_async_wait_all();
          // this step's tiles are in place, and every warp is done with the
          // previous step's
          __syncthreads();
          {  // the next step's K and V, into the other stage
            int nkt = kt, nhh = hh + 1;
            if (nhh >= nh) {
              nhh = 0;
              nkt = kt + 1;
            }
            if (nkt < kt_end) load_step(nkt, nhh, (step + 1) & 1);
            cp_async_commit();
          }

          if (!dead) {
            // S = (alpha Q) K^T: the warp's 16 x BK part
            const bf16* Qh = Qs + hh * kRows * PQ;
            float s[NT][4];
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
              uint32_t a[4];
              hstu_bf16::ldsm(a, hstu_bf16::a_at(Qh, PQ, warp * 16, ks * 16));
#pragma unroll
              for (int j = 0; j < NT; j += 2) {
                uint32_t kf[4];
                hstu_bf16::ldsm(kf, hstu_bf16::b_nk_at(Ks, PQ, j * 8, ks * 16));
                hstu_bf16::mma(s[j], a, kf[0], kf[1]);
                hstu_bf16::mma(s[j + 1], a, kf[2], kf[3]);
              }
            }
            // P = silu(s + bias), 0 where masked; an interior part has
            // nothing to mask
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const float x = BIASED ? s[j][c] + bias[BIASED ? 4 * j + c : 0] : s[j][c];
                s[j][c] = __fdividef(x, 1.f + __expf(-x));
              }
            if (!interior) {
#pragma unroll
              for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                  if (!((ok_bits >> (4 * j + c)) & 1u)) s[j][c] = 0.f;
            }
            // P in bfloat16 as the TPU kernel rounds it, packed as the A
            // fragments of P V's k-steps
            uint32_t pa[NT / 2][4];
#pragma unroll
            for (int kk = 0; kk < NT / 2; ++kk) {
              pa[kk][0] = hstu_bf16::pack(s[2 * kk][0], s[2 * kk][1]);
              pa[kk][1] = hstu_bf16::pack(s[2 * kk][2], s[2 * kk][3]);
              pa[kk][2] = hstu_bf16::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
              pa[kk][3] = hstu_bf16::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
            }
            // O += P V
#pragma unroll
            for (int kk = 0; kk < NT / 2; ++kk)
#pragma unroll
              for (int n = 0; n < NO; n += 2) {
                uint32_t vf[4];
                hstu_bf16::ldsm_t(vf, hstu_bf16::b_kn_at(Vs, PV, kk * 16, n * 8));
                hstu_bf16::mma(acc[hh][n], pa[kk], vf[0], vf[1]);
                hstu_bf16::mma(acc[hh][n + 1], pa[kk], vf[2], vf[3]);
              }
          }
          ++step;
        }
      }
    }
  }

  // every element of the tile's rows below N: a walk of one chunk (or none)
  // writes O, zeros where the row is dead; a chunk of a longer walk writes
  // its float32 sums to its slice of the scratch
  const bool whole = chunks <= 1;
#pragma unroll
  for (int hh = 0; hh < HG; ++hh) {
    if (hh >= nh) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_lo + 8 * i;
      if (row >= p.N) continue;
      const long long at = (((long long)b * p.N + row) * p.H + h0 + hh) * p.V;
      bf16* o = static_cast<bf16*>(p.out) + at;
      float* part = whole ? nullptr : p.scratch + (long long)ch * p.B * p.N * p.H * p.V + at;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int col = 8 * n + 2 * t;
        const float x0 = acc[hh][n][2 * i], x1 = acc[hh][n][2 * i + 1];
        if (whole) {
          if (col + 1 < p.V && p.V % 2 == 0) {
            *reinterpret_cast<__nv_bfloat162*>(o + col) = __floats2bfloat162_rn(x0 * p.inv_norm, x1 * p.inv_norm);
          } else {
            if (col < p.V) o[col] = __float2bfloat16_rn(x0 * p.inv_norm);
            if (col + 1 < p.V) o[col + 1] = __float2bfloat16_rn(x1 * p.inv_norm);
          }
        } else if (col + 1 < p.V && p.V % 2 == 0) {
          *reinterpret_cast<float2*>(part + col) = make_float2(x0, x1);
        } else {
          if (col < p.V) part[col] = x0;
          if (col + 1 < p.V) part[col + 1] = x1;
        }
      }
    }
  }
}

// O of the rows whose tile's walk was cut in chunks: their sums added in
// chunk order, times 1 / norm, rounded once to bfloat16. One block a (batch
// row, row); the rows of a walk of one chunk were written by their block.
__global__ void fwd_sums_kernel(Params p, int rows) {
  const int b = (int)(blockIdx.x / (unsigned)p.N), row = (int)(blockIdx.x % (unsigned)p.N);
  const int length = min(p.lengths[b], p.N);
  const int chunks =
      (walk_end(row / rows * rows, rows, length, p.causal != 0, p.contextual_seq_len) + p.chunk - 1) / p.chunk;
  if (chunks <= 1) return;
  const long long plane = (long long)p.B * p.N * p.H * p.V;
  const long long at = ((long long)b * p.N + row) * p.H * p.V;
  for (int e = threadIdx.x; e < p.H * p.V; e += blockDim.x) {
    float sum = 0.f;
    for (int c = 0; c < chunks; ++c) sum += p.scratch[c * plane + at + e];
    static_cast<__nv_bfloat16*>(p.out)[at + e] = __float2bfloat16_rn(sum * p.inv_norm);
  }
}

// rows readable in 16-byte pieces of 8 bfloat16
__host__ inline bool vec8(const void* ptr, long long sb, long long sn, long long sh, int w) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 8 == 0 && sn % 8 == 0 && sh % 8 == 0 && w % 8 == 0;
}

template <int W, int BIAS>
cudaError_t launch_bf16_w(Params p, cudaStream_t stream) {
  using T = TilingBf16<W>;
  constexpr int rows = 16 * T::NW;
  // the plan's chunk: whole key tiles, and a scratch wherever a walk may be cut
  if (p.chunk < T::BK || p.chunk % T::BK != 0) return cudaErrorInvalidValue;
  const int n_ch = (p.N + p.chunk - 1) / p.chunk;
  if (n_ch > 1 && p.scratch == nullptr) return cudaErrorInvalidValue;
  const int tables = BIAS == kRelBias ? 2 * p.Nm - 1 + p.NB + 1 : 0;
  const int ts_row = BIAS == kRelBias ? (p.N + T::BK - 1) / T::BK * T::BK : 0;
  const long long smem = smem_bytes_bf16<W>(tables, ts_row);
  if (smem > kMaxShared) return cudaErrorInvalidValue;
  auto kernel = fwd_bf16_kernel<W, BIAS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)((p.N + rows - 1) / rows) * n_ch * ((p.H + T::HG - 1) / T::HG) * p.B;
  if (blocks > 0x7fffffffLL || (long long)p.B * p.N > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, 32 * T::NW, (size_t)smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_ch == 1) return err;
  fwd_sums_kernel<<<(unsigned)((long long)p.B * p.N), 128, 0, stream>>>(p, rows);
  return cudaGetLastError();
}

template <int BIAS>
int launch_bf16(Params p, int route, cudaStream_t s) {
  if (p.D > 256 || p.V > 128) return (int)cudaErrorInvalidValue;
  if (route == hstu::kRead && BIAS != kRelBias) return (int)cudaErrorInvalidValue;
  p.vec_q = vec8(p.q, p.q_sb, p.q_sn, p.q_sh, p.D);
  p.vec_k = vec8(p.k, p.k_sb, p.k_sn, p.k_sh, p.D);
  p.vec_v = vec8(p.v, p.v_sb, p.v_sn, p.v_sh, p.V);
  constexpr int B2 = BIAS == kRelBias ? kRelBiasGlobal : BIAS;  // the tables-read route
  const int w = p.D > p.V ? p.D : p.V;
  if (route == hstu::kRead) {
    if (w <= 32) return (int)launch_bf16_w<32, B2>(p, s);
    if (w <= 64) return (int)launch_bf16_w<64, B2>(p, s);
    if (w <= 128) return (int)launch_bf16_w<128, B2>(p, s);
    return (int)launch_bf16_w<256, B2>(p, s);
  }
  if (w <= 32) return (int)launch_bf16_w<32, BIAS>(p, s);
  if (w <= 64) return (int)launch_bf16_w<64, BIAS>(p, s);
  if (w <= 128) return (int)launch_bf16_w<128, BIAS>(p, s);
  return (int)launch_bf16_w<256, BIAS>(p, s);
}

}  // namespace hstu_fwd
