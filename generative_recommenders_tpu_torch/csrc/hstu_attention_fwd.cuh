// HSTU attention forward for Hopper (sm_90a) on the tensor cores, float32 in
// and out: the shared body of the dense kernel K1 (hstu_mha_fwd.cu) and the
// relative-bias kernel K6 (hstu_mha_relbias_fwd.cu); both also bfloat16 in
// and out (E = __nv_bfloat16), with the TPU kernels' rounding: alpha Q
// rounded to bfloat16 (where alpha != 1), S and the sum P V in float32, P
// rounded to bfloat16 before P V, O = (P V) / norm written as bfloat16. The
// bfloat16 tiles are converted to float32 on their way into shared memory
// (synchronously, `load_tile`'s bfloat16 overload, which also forms alpha Q),
// and every product is one exact TF32 `mma` (`mma<true>`, tf32_mma.cuh)
// instead of three.
//
//   S = alpha Q K^T (+ bias)   P = silu(S) * valid_mask   O = (P V) / norm
//
// with the mask `valid_elem` (length guard on) and, for K6, the bias of
// `pos_index` / `ts_bucket` (hstu_attention.cuh). Replaces the Pallas TPU
// kernels `_fwd_kernel_rkv` / `_fwd_kernel` of
// generative_recommenders_tpu/ops/pallas/hstu_attention.py and
// `_fwd_kernel_relbias` of hstu_attention_relbias.py.
//
// Bound on the H100: 2 (D + V) multiply-adds per live element and head
// against 4 (2 D + V) bytes per live row and head. Held to the tensor cores'
// 3xTF32 rate (a third of dense TF32, 165 TFLOP/s) the operations take less
// time than the bytes at the research shape (D = V = 32) and at the serving
// shape (D = V = 128); chip_smoke.py prints both. The design, each choice timed by
// a knock-out variant (ops/cuda/variants.py, PERF.md):
// * Tensor cores with float32 accuracy: S = Q K^T and O += P V run as
//   `mma.sync.m16n8k8` TF32 with the 3xTF32 split of tf32_mma.cuh. Each key
//   tile's P V goes into fresh accumulators that are added to the walk's sum
//   in float32 (the tensor cores' accumulator truncates).
// * P stays in registers. Each warp owns 16 whole query rows of the tile:
//   the C fragment of S, after the bias, silu and the mask, is split once
//   and serves as the A fragment of P V with k in pairs; V's rows are read
//   paired to match (`load_b_kn<true>`). No round trip of P through shared
//   memory.
// * Q, K and V sit in shared memory as they are and are split on each read,
//   at the conflict-free pitches of K7 (Q, K: width + 8; V: width + 4, where
//   the paired read of two rows meets no bank twice). A first design split
//   every operand once, on the way into shared memory as {big, big, small,
//   small} pairs: twice the shared memory, one block of 8 warps an SM, and
//   slower at both shapes. The products wait on latency, not on the split
//   (without it the kernel gains under a tenth, PERF.md).
// * A block owns one query tile of one batch row and a group of HG heads
//   (K6: the TPU kernel's head loop). Per key tile the mask, and for K6
//   `pos_index`, the bucket (one logf) and both table reads, are computed
//   once into registers laid out like the S fragment; per head only
//   x = alpha s + bias, silu and the two products follow, into the head's
//   accumulators, which stay in registers. H need not be a multiple of HG.
//   A warp's 16 x BK part that lies wholly inside the mask (the common case)
//   skips the mask per element.
// * Loads in flight: the next (key tile, head) step's K and V arrive by
//   `cp.async` into the second of two stages while this step's products run;
//   one barrier a step. The key tiles are summed in a fixed order, with no
//   atomics: every run gives the same bits.
// * The walk stops at the row's live bound: the length, and for causal
//   attention the tile's last row once the tile is past the contextual rows
//   (a contextual row sees every column below the target boundary). A warp
//   whose part of the key tile holds no live element skips its products.
//   Blocks start last query tile first: those walk the most key tiles.
// Head widths are padded with zero columns to W = 32, 64, 128 or 256 (V to at
// most 128). `Tiling` sets per width the warps (query rows) and heads of a
// block and its key tile, so that blocks fit the shared memory and the
// registers: at the research width 8 warps, 2 heads, 32 columns, 2 blocks an
// SM; at the serving width 4 warps, 1 head, 32 columns, 2 blocks an SM.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "hstu_attention.cuh"
#include "tf32_mma.cuh"

namespace hstu_fwd {

using namespace hstu_tf32;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxShared = 232448;

struct Params {
  // float32, or bfloat16 for the bfloat16 kernels
  const void* q;
  const void* k;
  const void* v;
  void* out;  // contiguous [B, N, H, V]
  const int* lengths;      // int32 [B]
  const int* num_targets;  // int32 [B] or null (no targets)
  int B, N, H, D, V;
  long long q_sb, q_sn, q_sh;
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  float alpha, inv_norm;
  int causal, max_attn_len, contextual_seq_len, min_full_attn_seq_len;
  // the relative-bias kernel K6 only
  const float* ts = nullptr;     // float32 [B, N] timestamps, contiguous
  const float* pos_w = nullptr;  // float32 [2 Nm - 1]
  const float* ts_w = nullptr;   // float32 [NB + 1]
  int Nm = 0, NB = 0;
  // rows readable in 16-byte pieces (set by `launch`)
  int vec_q = 0, vec_k = 0, vec_v = 0;
};

// Per padded width W: warps per block (each owns 16 query rows), heads per
// block, key columns per tile, blocks an SM (what the shared memory and the
// registers allow).
template <int W> struct Tiling;
template <> struct Tiling<32> { static constexpr int NW = 8, HG = 2, BK = 32, MINB = 2; };
template <> struct Tiling<64> { static constexpr int NW = 8, HG = 2, BK = 32, MINB = 1; };
template <> struct Tiling<128> { static constexpr int NW = 4, HG = 1, BK = 32, MINB = 2; };
template <> struct Tiling<256> { static constexpr int NW = 4, HG = 1, BK = 16, MINB = 1; };

// Q of HG heads; two stages of a K tile and a V tile; for K6 the tables and
// the row's timestamps up to the last key tile.
template <int W>
__host__ __device__ constexpr int smem_floats(int tables, int ts_row) {
  constexpr int WV = W < 128 ? W : 128;
  using T = Tiling<W>;
  return T::HG * 16 * T::NW * (W + 8) + 2 * T::BK * (W + 8 + WV + 4) + tables + ts_row;
}

// P's k-step j as an A fragment, split: the C fragment of S with k in pairs
__device__ __forceinline__ FragA frag_a_p(const float (&s)[4]) {
  FragA f;
  split(s[0], f.big[0], f.small[0]);
  split(s[2], f.big[1], f.small[1]);
  split(s[1], f.big[2], f.small[2]);
  split(s[3], f.big[3], f.small[3]);
  return f;
}

// W: the padded head width; RELBIAS: K6, the relative bias added to S; E:
// the type of q, k, v and out (float, or __nv_bfloat16).
template <int W, bool RELBIAS, typename E>
__global__ void __launch_bounds__(32 * Tiling<W>::NW, Tiling<W>::MINB) fwd_kernel(Params p) {
  using T = Tiling<W>;
  constexpr bool kBf16 = !std::is_same<E, float>::value;
  constexpr int HG = T::HG, BK = T::BK;
  constexpr int kRows = 16 * T::NW, kThreads = 32 * T::NW;
  constexpr int WV = W < 128 ? W : 128;
  constexpr int PQ = W + 8;        // pitch of the Q and K tiles
  constexpr int PV = WV + 4;       // pitch of the V tile
  constexpr int KS = W / 8;        // k-steps of S
  constexpr int NT = BK / 8;       // 8-column tiles of S = k-steps of P V
  constexpr int NO = WV / 8;       // 8-column tiles of O
  constexpr int NG = NO < 4 ? NO : 4;  // output tiles summed side by side
  constexpr int STAGE = BK * (PQ + PV);

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                          // [HG][kRows][PQ]
  float* stages = Qs + HG * kRows * PQ;      // 2 x { K [BK][PQ], V [BK][PV] }
  float* pos_s = stages + 2 * STAGE;         // RELBIAS: pos_w [2 Nm - 1]
  float* ts_s = pos_s + 2 * p.Nm - 1;        // RELBIAS: ts_w [NB + 1]
  float* tk_s = ts_s + p.NB + 1;             // RELBIAS: the row's timestamps

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // Blocks start in the order of their index; the index counts the query
  // tile last, from the row's end: every row's last tile (the longest walk)
  // starts before any row's second to last.
  const int groups = (p.H + HG - 1) / HG;
  const int n_qt = (p.N + kRows - 1) / kRows;
  const int q0 = (n_qt - 1 - (int)blockIdx.x / (groups * p.B)) * kRows;
  const int h0 = (int)blockIdx.x % groups * HG;
  const int b = (int)blockIdx.x / groups % p.B;
  const int nh = min(HG, p.H - h0);  // heads of this group
  const int length = min(p.lengths[b], p.N);
  const int nt = p.num_targets ? p.num_targets[b] : 0;
  const bool causal = p.causal != 0;
  int kv_limit = length;
  // causal: a row at or past the contextual rows sees no column past itself
  // (a contextual row sees every column below the target boundary)
  if (causal && q0 >= p.contextual_seq_len) kv_limit = min(kv_limit, q0 + kRows);
  if (q0 >= length) kv_limit = 0;  // every row of the tile is dead
  const int n_kt = (kv_limit + BK - 1) / BK;
  // no targets, no window, no contextual rows: the mask is col <= row
  const bool plain_causal =
      causal && p.contextual_seq_len == 0 && nt == 0 && p.max_attn_len == 0;
  const int row_lo = q0 + warp * 16 + g;  // the thread's rows: row_lo, row_lo + 8
  // bfloat16: alpha rides the Q tile, rounded to bfloat16 as the TPU kernel
  // rounds alpha q (the scalar itself in bfloat16, as JAX's weakly typed
  // Python float); S then takes no alpha
  const float q_scale = kBf16 && p.alpha != 1.f ? round_bf16(p.alpha) : 1.f;
  const float s_alpha = kBf16 ? 1.f : p.alpha;
  // `valid_elem` (length guard on) cut into what depends on the row alone,
  // once per block, and what depends on the column: contextual rows and
  // columns folded onto 0, both clipped at the target boundary
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

  if (n_kt > 0) {
    const E* qb = static_cast<const E*>(p.q) + b * p.q_sb + h0 * p.q_sh;
    const E* kb = static_cast<const E*>(p.k) + b * p.k_sb + h0 * p.k_sh;
    const E* vb = static_cast<const E*>(p.v) + b * p.v_sb + h0 * p.v_sh;
    const float* tsb = RELBIAS ? p.ts + (long long)b * p.N : nullptr;
    // the step's K and V tiles: step (kt, hh) into stage `st`
    auto load_step = [&](int kt, int hh, int st) {
      float* K = stages + st * STAGE;
      load_tile<W, PQ, BK, kThreads>(K, kb + hh * p.k_sh, p.k_sn, kt * BK, length, p.D,
                                     p.vec_k != 0);
      load_tile<WV, PV, BK, kThreads>(K + BK * PQ, vb + hh * p.v_sh, p.v_sn, kt * BK, length,
                                      p.V, p.vec_v != 0);
    };
    for (int hh = 0; hh < nh; ++hh) {
      if constexpr (kBf16)  // alpha q, rounded to bfloat16
        load_tile<W, PQ, kRows, kThreads>(Qs + hh * kRows * PQ, qb + hh * p.q_sh, p.q_sn, q0, p.N,
                                          p.D, p.vec_q != 0, q_scale);
      else
        load_tile<W, PQ, kRows, kThreads>(Qs + hh * kRows * PQ, qb + hh * p.q_sh, p.q_sn, q0, p.N,
                                          p.D, p.vec_q != 0);
    }
    load_step(0, 0, 0);
    cp_async_commit();
    if (RELBIAS) {  // visible after the barrier before the first key tile's bias
      for (int idx = threadIdx.x; idx < 2 * p.Nm - 1; idx += kThreads) pos_s[idx] = p.pos_w[idx];
      for (int idx = threadIdx.x; idx <= p.NB; idx += kThreads) ts_s[idx] = p.ts_w[idx];
      for (int idx = threadIdx.x; idx < n_kt * BK; idx += kThreads)
        tk_s[idx] = idx < p.N ? tsb[idx] : 0.f;
    }
    // RELBIAS: the timestamps the thread's two rows read, the next
    // position's (the last position's at the last row), whether or not it
    // lies past the row's length
    float tq[2] = {0.f, 0.f};
    if (RELBIAS) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row_lo + 8 * i;
        if (row < p.N) tq[i] = tsb[min(row + 1, p.N - 1)];
      }
    }

    int step = 0;
    for (int kt = 0; kt < n_kt; ++kt) {
      const int c0 = kt * BK;
      // mask and bias of the thread's elements of the warp's 16 x BK part of
      // the tile, once for every head: element e = 4 j + c is row
      // row_lo + 8 (c / 2), column c0 + 8 j + 2 t + c % 2
      float bias[RELBIAS ? NT * 4 : 1];
      if (RELBIAS && kt == 0) __syncthreads();  // the tables and timestamps are in place
      // the warp's 16 x BK part lies wholly inside the mask (away from the
      // diagonal, the length and a window's edge; the common case): causal,
      // every row and column live, the last column before the first row's
      // own, the first column inside the last row's window
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
        // on every element, masked or not: a branch around it would keep the
        // compiler from interleaving it with its neighbours
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int row = row_lo + 8 * (c >> 1);
            const int col = c0 + 8 * j + 2 * t + (c & 1);
            bias[RELBIAS ? 4 * j + c : 0] = pos_s[hstu::pos_index(row, col, p.Nm)] +
                                            ts_s[hstu::ts_bucket(tq[c >> 1], tk_s[col], p.NB)];
          }
      }
      // the warp's part of the tile holds no live element (above the
      // diagonal, past the length, outside a window): no products
      const bool dead = __all_sync(kFull, ok_bits == 0);

#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        if (hh < nh) {
          const float* Ks = stages + (step & 1) * STAGE;
          const float* Vs = Ks + BK * PQ;
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
            if (nkt < n_kt) load_step(nkt, nhh, (step + 1) & 1);
            cp_async_commit();
          }

          if (!dead) {
            // S = Q K^T: the warp's 16 x BK part
            const float* Qh = Qs + hh * kRows * PQ;
            float s[NT][4];
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {  // S's k-steps
              const FragA a = load_a(Qh, PQ, warp * 16, ks * 8);
#pragma unroll
              for (int j = 0; j < NT; ++j) mma<kBf16>(s[j], a, load_b_nk(Ks, PQ, j * 8, ks * 8));
            }
            // P = silu(alpha s + bias), 0 where masked; an interior part has
            // nothing to mask
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const int e = 4 * j + c;
                const float x = RELBIAS ? fmaf(s[j][c], s_alpha, bias[RELBIAS ? e : 0])
                                        : s[j][c] * s_alpha;
                s[j][c] = __fdividef(x, 1.f + __expf(-x));
              }
            if (!interior) {
#pragma unroll
              for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                  if (!((ok_bits >> (4 * j + c)) & 1u)) s[j][c] = 0.f;
            }
            if constexpr (kBf16) {  // P V takes P in bfloat16, as the TPU kernel
#pragma unroll
              for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int c = 0; c < 4; ++c) s[j][c] = round_bf16(s[j][c]);
            }
            // O += P V, the tile's share in fresh accumulators (NG output
            // tiles side by side) added to the walk's sum in float32
            FragA pa[NO > NG ? NT : 1];
            if constexpr (NO > NG) {
#pragma unroll
              for (int j = 0; j < NT; ++j) pa[j] = frag_a_p(s[j]);
            }
#pragma unroll
            for (int n0 = 0; n0 < NO; n0 += NG) {
              float part[NG][4];
#pragma unroll
              for (int n = 0; n < NG; ++n)
#pragma unroll
                for (int c = 0; c < 4; ++c) part[n][c] = 0.f;
#pragma unroll
              for (int j = 0; j < NT; ++j) {
                const FragA a = NO > NG ? pa[NO > NG ? j : 0] : frag_a_p(s[j]);
#pragma unroll
                for (int n = 0; n < NG; ++n)
                  mma<kBf16>(part[n], a, load_b_kn<true>(Vs, PV, j * 8, (n0 + n) * 8));
              }
#pragma unroll
              for (int n = 0; n < NG; ++n)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[hh][n0 + n][c] += part[n][c];
            }
          }
          ++step;
        }
      }
    }
  }

  // every element of the tile's rows below N is written: zeros where the row
  // is dead
#pragma unroll
  for (int hh = 0; hh < HG; ++hh) {
    if (hh >= nh) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_lo + 8 * i;
      if (row >= p.N) continue;
      E* o = static_cast<E*>(p.out) + (((long long)b * p.N + row) * p.H + h0 + hh) * p.V;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int col = 8 * n + 2 * t;
        const float x0 = acc[hh][n][2 * i] * p.inv_norm, x1 = acc[hh][n][2 * i + 1] * p.inv_norm;
        if (col + 1 < p.V && p.V % 2 == 0) {
          if constexpr (kBf16)
            *reinterpret_cast<__nv_bfloat162*>(o + col) = __floats2bfloat162_rn(x0, x1);
          else
            *reinterpret_cast<float2*>(o + col) = make_float2(x0, x1);
        } else {
          if (col < p.V) o[col] = E(x0);
          if (col + 1 < p.V) o[col + 1] = E(x1);
        }
      }
    }
  }
}

template <int W, bool RELBIAS, typename E>
cudaError_t launch_w(const Params& p, cudaStream_t stream) {
  using T = Tiling<W>;
  const int tables = RELBIAS ? 2 * p.Nm - 1 + p.NB + 1 : 0;
  const int ts_row = RELBIAS ? (p.N + T::BK - 1) / T::BK * T::BK : 0;
  const long long smem = (long long)smem_floats<W>(tables, ts_row) * (long long)sizeof(float);
  if (smem > kMaxShared) return cudaErrorInvalidValue;
  auto kernel = fwd_kernel<W, RELBIAS, E>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)((p.N + 16 * T::NW - 1) / (16 * T::NW)) * ((p.H + T::HG - 1) / T::HG) * p.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, 32 * T::NW, (size_t)smem, stream>>>(p);
  return cudaGetLastError();
}

// rows readable in pieces of 4 elements (16 bytes of float32, 8 of bfloat16)
__host__ inline bool vec16(const void* ptr, long long sb, long long sn, long long sh, int w) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 4 == 0 && sn % 4 == 0 &&
         sh % 4 == 0 && w % 4 == 0;
}

// Launches on `stream`; returns the launch's cudaGetLastError(). D is at most
// 256 and V at most 128 (the Python wrapper checks both); both are padded to
// the next of 32, 64, 128 (256 for D). RELBIAS also needs both tables to fit
// the block's shared memory beside the tiles. E: float, or __nv_bfloat16.
template <bool RELBIAS, typename E = float>
int launch(Params p, void* stream) {
  if (p.B == 0 || p.N == 0 || p.H == 0) return 0;
  if (p.D < 1 || p.D > 256 || p.V < 1 || p.V > 128) return (int)cudaErrorInvalidValue;
  if (RELBIAS && (p.Nm < 1 || p.NB < 0)) return (int)cudaErrorInvalidValue;
  p.vec_q = vec16(p.q, p.q_sb, p.q_sn, p.q_sh, p.D);
  p.vec_k = vec16(p.k, p.k_sb, p.k_sn, p.k_sh, p.D);
  p.vec_v = vec16(p.v, p.v_sb, p.v_sn, p.v_sh, p.V);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = p.D > p.V ? p.D : p.V;
  if (w <= 32) return (int)launch_w<32, RELBIAS, E>(p, s);
  if (w <= 64) return (int)launch_w<64, RELBIAS, E>(p, s);
  if (w <= 128) return (int)launch_w<128, RELBIAS, E>(p, s);
  return (int)launch_w<256, RELBIAS, E>(p, s);
}

}  // namespace hstu_fwd
