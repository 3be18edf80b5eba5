// HSTU attention at any head width for Hopper (sm_90a): the bodies that the
// kernels K1, K1-bias, K2, K3, K4, K6, K7 and K7-det take where their own
// tilings end, float32 and bfloat16. The Pallas TPU kernels of
// generative_recommenders_tpu/ops/pallas/hstu_attention.py and
// hstu_attention_relbias.py lane-pad any width and, past their VMEM gates,
// drop to 3-D-grid kernels that take any width; these bodies are the port's
// counterpart. The entry points dispatch here by the route of the Python
// plan (`hstu::Route`):
// * the forward (K1, K1-bias, K6): V above 128 or D above 256;
// * the dense backward (K2, K3, K4): V above 128 or D above 256;
// * the relative-bias backward (K7, K7-det): D or V above 128.
// Route kWideTile, the float32 forward of K1 and K1-bias at V of 129 to 256
// with D up to 256 and V up to 384 with D up to 128 (`tile_fwd_kernel`):
// one block of 8 warps per (64-row query tile, head, batch row), no cluster;
// the two warps of a row group each form S over half of D for a 32-key step
// and sum the halves through shared memory, both keep P in registers, each
// multiplies P by half of V's columns; Q resident (registers up to D 128,
// else shared memory), K and V streamed by `cp.async` in two stages, 3xTF32.
// Route kWide: thread block clusters whose blocks split D's and V's columns
// and form S (and dP) once per tile pair, the blocks' parts summed through
// distributed shared memory in rank order (the same bits on every run);
// copies double-buffered by `cp.async`; 3xTF32 in float32, the bfloat16
// tensor cores (m16n8k16) on bfloat16:
// * the forward (`fwd_kernel`, bfloat16 and the relative bias everywhere,
//   float32 K1 past the tile forward's widths): one cluster per (64-row
//   query tile, head, batch row), each block a slice of D's columns for S
//   (Q resident, K streamed) and of V's for O (V streamed, O in registers);
// * the backward (`bwd_kernel`): one cluster per 64-row tile, each block one
//   or two 128-column chunks of D or of V.
// Route kWideChunks, for the widths no cluster takes (the forward past 16
// blocks of 3 tiles of 128 columns, the backward past 16 blocks of two
// chunks): the per-chunk bodies (`fwd_chunks_kernel`, `dq_chunks_kernel`,
// `dkv_chunks_kernel`), a block per output chunk, which recompute S (and dP)
// for each chunk, multiply in TF32 on float32 tiles (3xTF32 in float32, one
// exact product on bfloat16 values) and whose loads wait; any width.
// Tables and timestamps of the relative bias are read through the L1 cache,
// never staged: a table of any length fits.
// Bound: the kernels' own (the same functions); PERF.md has the times.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "bf16_mma.cuh"
#include "hstu_attention.cuh"
#include "tf32_mma.cuh"

namespace hstu_wide {

using namespace hstu_tf32;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxShared = 232448;
constexpr int kThreads = 128;     // the per-chunk forward: 4 warps
constexpr int kBwdThreads = 256;  // the other bodies: 8 warps
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
  void* dq;   // the dq pass: E; the dkv pass with FUSED: a zeroed float32 buffer; `dq_chunks_kernel`: its DQ;
              // contiguous [B, N, H, D]
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
  // the bfloat16 backward: the wrapper's buffers for bfloat16(alpha q)
  // (where alpha != 1) and bfloat16(dO / norm)
  E* qs = nullptr;
  E* dos = nullptr;
};

__host__ __device__ constexpr int chunks(int w) { return (w + kC - 1) / kC; }

// The per-chunk forward: Q [64][kP], K [32][kP], V [32][kC + 4]
constexpr int kFwdRows = 64, kFwdCols = 32;
constexpr int fwd_chunks_smem_bytes() { return 4 * (kFwdRows * kP + kFwdCols * kP + kFwdCols * (kC + 4)); }
// The per-chunk dq pass: Q and dO [64][kP], K and V [32][kP], dS [64][32 + 8],
// the warps' live flags
constexpr int kDqRows = 64, kDqCols = 32;
constexpr int dq_chunks_smem_bytes() {
  return 4 * (2 * kDqRows * kP + 2 * kDqCols * kP + kDqRows * (kDqCols + 8) + kBwdThreads / 32);
}
// The per-chunk dkv pass: Q and dO [32][kP], K and V [64][kP], P and dS [32][64
// + 8]; with the bias the float32 dS [32][72], the step's diagonal sums and
// eight warps' copies of `dts_w`'s sums
constexpr int kDkvRows = 32, kDkvCols = 64, kDkvDiags = kDkvRows + kDkvCols - 1;
constexpr int dkv_chunks_smem_bytes(bool relbias) {
  return 4 * (2 * kDkvRows * kP + 2 * kDkvCols * kP + 2 * kDkvRows * (kDkvCols + 8) +
              (relbias ? kDkvRows * (kDkvCols + 8) + kDkvDiags + 1 + kBwdThreads / 32 * kTsSlots : 0));
}
static_assert(dkv_chunks_smem_bytes(true) <= kMaxShared && dq_chunks_smem_bytes() <= kMaxShared &&
                  fwd_chunks_smem_bytes() <= kMaxShared,
              "the tiles fit a block's shared memory");

// The per-chunk bodies' loads: chunk c (columns c kC .. + kC) of one head's
// rows [r0, r0 + ROWS) into a [ROWS][P] float32 tile: float32
// asynchronously, bfloat16 converted (scaled and rounded where scale != 1);
// zeros at rows >= lim and columns >= w.
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

// ----------------------------------------------------------------- backward
// One thread block cluster per (64-row tile, head, batch row): per query
// tile in the dq pass, per key tile in the dkv pass. The cluster's blocks
// split D's and V's chunks (`Cluster`): ranks 0 .. nd - 1 own M chunks of D
// each (the last may own fewer), ranks nd .. nd + nv - 1 M chunks of V. A
// D-block keeps its chunks of Q (dq pass) or K (dkv pass) resident and
// streams K or Q; a V-block keeps dO or V resident and streams V or dO, 32
// rows a step in two stages (the next step's rows arrive while this step
// runs). Per step each block forms only its own part of T = R X^T (R the
// resident rows, X the streamed ones: S or S^T summed over the block's D
// chunks, dP or dP^T over its V chunks); the parts are summed through
// distributed shared memory in rank order (S and dP, the same bits on every
// run), and the per-element work (mask, bias, silu, P, dS) fills each
// block's A tile:
// * SPLIT (clusters of kSplitFrom blocks and more): warp w's 16 x 16
//   fragment of T belongs to block w % cs; every block stores its part of
//   the fragment into the owner's receive buffer, the owner sums the parts,
//   does the fragment's per-element work and stores its dS or P into every
//   block's A tile; two cluster barriers a step;
// * else every block reads every block's part from its exchange buffers and
//   does all the per-element work itself; one cluster barrier a step.
// Each block then forms its own outputs from its own chunks:
// * the dq pass (K3, K7-det's first pass): dQ_c += dS K_c in the D-blocks
//   (the V-blocks lend dP);
// * the dkv pass (K4; with FUSED K2 and K7; K7-det's second pass): dK_c +=
//   dS^T Q_c in the D-blocks, dV_c += P^T dO_c in the V-blocks; FUSED: the
//   D-blocks also add dQ_c = dS K_c into the zeroed float32 dq with float4
//   atomics. With the relative bias `dpos_w` is summed by diagonals of the
//   step's dS in the step's table block (rank s % cs at step s), `dts_w` per
//   warp by shuffles into the warp's copy of the reachable buckets where the
//   fragment's per-element work runs; K7 adds both to the zeroed tables with
//   atomics, K7-det writes each block's to its own row of `partial`, which
//   the relative-bias kernel sums in row order.
// Products per live element and head, from the code: S 2 D and dP 2 V once
// in either pass; dQ 2 D, dK 2 D, dV 2 V: K2 and K7 2 (3 D + 2 V), K3 2 (2 D
// + V), K4 2 (2 D + 2 V), K7-det K3's plus K4's.
// float32 multiplies in 3xTF32 (tf32_mma.cuh); bfloat16 keeps bfloat16
// tiles and multiplies with m16n8k16 on `ldmatrix` fragments (bf16_mma.cuh),
// at the narrow bodies' rounding points: alpha q and dO / norm rounded once
// by the pre-scaling pass, P and dS rounded to bfloat16 before their
// products, S, dP and the outputs' sums float32.
constexpr int kR = 64;                   // resident rows of a tile
constexpr int kS = 32;                   // streamed rows a step
constexpr int kXP = kS + 8;              // pitch of the exchange buffers and of the A tile
constexpr int kDiags = kR + kS - 1;      // diagonals of a step's dS^T
constexpr int kPortableCluster = 8;      // blocks a cluster takes on any card
constexpr int kMaxCluster = 16;          // with cudaFuncAttributeNonPortableClusterSizeAllowed
constexpr int kMaxOwn = 2;               // chunks a block owns at most
// Clusters of kSplitFrom blocks and more split the per-element work by
// fragment (each block sums, forms and hands out the fragments it owns:
// remote stores, two cluster barriers a step); smaller ones repeat it in
// every block (each reading every block's part of T: remote loads, one
// barrier), which measured faster there (PERF.md)
constexpr int kSplitFrom = 5;
// a block's receive buffer when split: cs * ceil(8 / cs) fragments of 256
// floats, at most 16 for cs up to 16, in the space of the two exchange
// buffers [2][64][kXP] of the repeated work
constexpr int kRecvSlots = 16;
constexpr int kXchFloats = 2 * kR * kXP;
static_assert(kRecvSlots * 256 <= kXchFloats, "the receive buffer fits the exchange buffers");
enum Pass : int { kDqPass = 0, kDkvPass = 1 };

// The cluster of a backward launch (mirrored by `_wide_cluster` in
// ops/cuda/hstu_attention.py): M chunks a block, one while chunks(D) +
// chunks(V) blocks fit a portable cluster, else two; nd D-blocks, nv
// V-blocks, cs = nd + nv; split: the per-element work split across the
// blocks. cs = 0: wider than 16 blocks of two chunks (the per-chunk bodies
// take those widths, route kWideChunks).
struct Cluster {
  int m, nd, nv, cs, split;
};
inline Cluster cluster_of(int D, int V) {
  const int n_dc = chunks(D), n_vc = chunks(V);
  for (int m = 1; m <= kMaxOwn; ++m) {
    const int nd = (n_dc + m - 1) / m, nv = (n_vc + m - 1) / m;
    if (nd + nv <= kPortableCluster || (m == kMaxOwn && nd + nv <= kMaxCluster))
      return {m, nd, nv, nd + nv, nd + nv >= kSplitFrom ? 1 : 0};
  }
  return {0, 0, 0, 0, 0};
}

// A block's shared memory: R [M][64][kP] and two stages of X [2][M][32][kP]
// of the element type, two float32 exchange buffers [2][64][kXP] (or the
// receive buffer), the A tile (P^T, dS^T or dS) [64][kXP] of the element
// type, the warps' live flags; with the table sums the float32 dS^T
// [64][kXP], the step's diagonal sums and eight warps' copies of `dts_w`'s
// sums.
constexpr int bwd_smem_bytes(int elem, int m, bool tables) {
  return elem * (m * kR * kP + 2 * m * kS * kP + kR * kXP) + 4 * (kXchFloats + kBwdThreads / 32) +
         (tables ? 4 * (kR * kXP + kDiags + 1 + kBwdThreads / 32 * kTsSlots) : 0);
}
static_assert(bwd_smem_bytes(4, kMaxOwn, true) <= kMaxShared, "the tiles fit a block's shared memory");
// Blocks an SM holds by shared memory (228 KB, 1 KB reserved a block): where
// two fit, the registers are held to two blocks' worth too (128 a thread);
// ptxas otherwise took up to 166 for the bfloat16 K7 and left one block an
// SM, 1.4x slower (PERF.md)
constexpr int bwd_blocks_per_sm(int elem, int m, bool tables) {
  return 2 * (bwd_smem_bytes(elem, m, tables) + 1024) <= 233472 ? 2 : 1;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Rows [r0, r0 + ROWS) of chunk c of one head's rows of width w into a
// [ROWS][kP] tile of the element type, asynchronously where `vec` (float32
// always): zeros at rows >= lim and columns >= w
template <int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long sn, int r0, int lim, int w, int c,
                                          bool vec) {
  load_tile<kC, kP, ROWS, kBwdThreads>(dst, src + c * kC, sn, r0, lim, w - c * kC, vec);
}
template <int ROWS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, long long sn, int r0, int lim,
                                          int w, int c, bool vec) {
  hstu_bf16::load_rows<kC, kP, ROWS, kBwdThreads>(dst, src + c * kC, sn, r0, lim, w - c * kC, vec);
}

// t += R X^T for the warp's 16 x 16 part of T (rows wm 16 .., columns wn
// 16 ..), over the kw live columns of one chunk (tiles at a pitch of `pitch`)
__device__ __forceinline__ void part_product(float (&t)[2][4], const float* R, const float* X, int wm, int wn,
                                             int kw, int pitch = kP) {
  const int steps = (kw + 7) / 8;
#pragma unroll 4
  for (int ks = 0; ks < steps; ++ks) {
    const FragA a = load_a(R, pitch, wm * 16, ks * 8);
#pragma unroll
    for (int j = 0; j < 2; ++j) mma3(t[j], a, load_b_nk(X, pitch, wn * 16 + j * 8, ks * 8));
  }
}
__device__ __forceinline__ void part_product(float (&t)[2][4], const __nv_bfloat16* R, const __nv_bfloat16* X, int wm,
                                             int wn, int kw, int pitch = kP) {
  const int steps = (kw + 15) / 16;
#pragma unroll 4
  for (int ks = 0; ks < steps; ++ks) {
    uint32_t a[4], b[4];
    hstu_bf16::ldsm(a, hstu_bf16::a_at(R, pitch, wm * 16, ks * 16));
    hstu_bf16::ldsm(b, hstu_bf16::b_nk_at(X, pitch, wn * 16, ks * 16));
    hstu_bf16::mma(t[0], a, b[0], b[1]);
    hstu_bf16::mma(t[1], a, b[2], b[3]);
  }
}

// acc += A X for the warp's 16 rows (wm 16 ..) by 64 columns (wn 64 ..) of
// a chunk: A the block's [64][kXP] tile, k over the step's kn live rows of
// X. float32: the step's share is summed in fresh accumulators, then added
// in float32: summed across the walk's steps inside the tensor cores'
// accumulators, dK at N 4096 drifted past 2e-5 of its max. bfloat16 (its
// outputs rounded to 8 bits) sums in place.
__device__ __forceinline__ void out_product(float (&acc)[8][4], const float* A, const float* X, int wm, int wn,
                                            int kn) {
  const int steps = (kn + 7) / 8;
  float part[8][4] = {};
  for (int ks = 0; ks < steps; ++ks) {
    const FragA a = load_a(A, kXP, wm * 16, ks * 8);
#pragma unroll
    for (int n = 0; n < 8; ++n) mma3(part[n], a, load_b_kn<true>(X, kP, ks * 8, wn * 64 + n * 8));
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] += part[n][c];
}
__device__ __forceinline__ void out_product(float (&acc)[8][4], const __nv_bfloat16* A, const __nv_bfloat16* X, int wm,
                                            int wn, int kn) {
  const int steps = (kn + 15) / 16;
  for (int ks = 0; ks < steps; ++ks) {
    uint32_t a[4];
    hstu_bf16::ldsm(a, hstu_bf16::a_at(A, kXP, wm * 16, ks * 16));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      hstu_bf16::ldsm_t(b, hstu_bf16::b_kn_at(X, kP, ks * 16, wn * 64 + np * 16));
      hstu_bf16::mma(acc[2 * np], a, b[0], b[1]);
      hstu_bf16::mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// dq = A^T R for the warp's 16 streamed rows (wq 16 ..) by 32 columns (wd
// 32 ..) of a chunk: A the block's [64][kXP] dS^T, k over the kr live
// resident rows
__device__ __forceinline__ void dq_product(float (&dq)[4][4], const float* A, const float* R, int wq, int wd, int kr) {
  const int steps = (kr + 7) / 8;
  for (int ks = 0; ks < steps; ++ks) {
    const FragA a = load_a_t(A, kXP, wq * 16, ks * 8);
#pragma unroll
    for (int n = 0; n < 4; ++n) mma3(dq[n], a, load_b_kn(R, kP, ks * 8, wd * 32 + n * 8));
  }
}
__device__ __forceinline__ void dq_product(float (&dq)[4][4], const __nv_bfloat16* A, const __nv_bfloat16* R, int wq,
                                           int wd, int kr) {
  const int steps = (kr + 15) / 16;
  for (int ks = 0; ks < steps; ++ks) {
    uint32_t a[4];
    hstu_bf16::ldsm_t(a, hstu_bf16::a_t_at(A, kXP, wq * 16, ks * 16));
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b[4];
      hstu_bf16::ldsm_t(b, hstu_bf16::b_kn_at(R, kP, ks * 16, wd * 32 + np * 16));
      hstu_bf16::mma(dq[2 * np], a, b[0], b[1]);
      hstu_bf16::mma(dq[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// a pair of values of the A tile, as the element type
__device__ __forceinline__ void put2(float* at, float x0, float x1) {
  *reinterpret_cast<float2*>(at) = make_float2(x0, x1);
}
__device__ __forceinline__ void put2(__nv_bfloat16* at, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(x0, x1);
}

// 8 warps: warp w owns rows (w / 2) 16 .. + 16 of T (and of the outputs)
// and T's columns (w % 2) 16 .. + 16 (the outputs' (w % 2) 64 .. + 64).
// Element e = 4 j + c of a warp's part of T is T's row wm 16 + g + 8 (c / 2),
// column wn 16 + 8 j + 2 t + c % 2: in the dq pass query row base + row and
// key column s0 + column; in the dkv pass key column base + row and query
// row s0 + column.
template <int PASS, bool RELBIAS, bool DET, bool FUSED, int M, bool SPLIT, typename E>
__global__ void __launch_bounds__(kBwdThreads, bwd_blocks_per_sm(sizeof(E), M, RELBIAS && PASS == kDkvPass))
    bwd_kernel(Params<E> p, Cluster cl) {
  namespace cg = cooperative_groups;
  constexpr bool kBf16 = !std::is_same<E, float>::value;
  constexpr bool kDkv = PASS == kDkvPass;
  constexpr bool kTables = RELBIAS && kDkv;
  constexpr int T = kBwdThreads, NW = T / 32;
  const float s_alpha = kBf16 ? 1.f : p.alpha, dp_scale = kBf16 ? 1.f : p.inv_norm;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* Rs = reinterpret_cast<E*>(smem_raw);                        // [M][kR][kP]
  E* Xs = Rs + M * kR * kP;                                       // [2][M][kS][kP]
  float* xch = reinterpret_cast<float*>(Xs + 2 * M * kS * kP);    // [2][kR][kXP] or [kRecvSlots][256]
  E* As = reinterpret_cast<E*>(xch + kXchFloats);                 // [kR][kXP]
  int* part_live = reinterpret_cast<int*>(As + kR * kXP);         // [NW]
  float* Ts = reinterpret_cast<float*>(part_live + NW);           // tables: dS^T [kR][kXP]
  float* diag = Ts + kR * kXP;                                    // tables: [kDiags + 1]
  float* dts_s = diag + kDiags + 1;                               // tables: [NW][kTsSlots]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const bool is_d = rank < cl.nd;
  const int width = is_d ? p.D : p.V;
  const int c0 = (is_d ? rank : rank - cl.nd) * M;  // the block's first chunk
  const int own = min(M, chunks(width) - c0);
  // the cluster's unit counts the head first and the tile last; in the dq
  // pass from the end, so that the longest walks start first
  int unit = (int)(blockIdx.x / (unsigned)cl.cs);
  const int h = unit % p.H;
  unit /= p.H;
  const int b = unit % p.B;
  const int n_tiles = (p.N + kR - 1) / kR;
  const int base = (kDkv ? unit / p.B : n_tiles - 1 - unit / p.B) * kR;
  const int length = min(p.lengths[b], p.N);
  const int nt = p.num_targets ? p.num_targets[b] : 0;
  const E* qb = p.q + b * p.q_sb + h * p.q_sh;
  const E* kb = p.k + b * p.k_sb + h * p.k_sh;
  const E* vb = p.v + b * p.v_sb + h * p.v_sh;
  const E* ob = p.dout + b * p.do_sb + h * p.do_sh;
  const E* rsrc = kDkv ? (is_d ? kb : vb) : (is_d ? qb : ob);
  const E* xsrc = kDkv ? (is_d ? qb : ob) : (is_d ? kb : vb);
  const long long r_sn = kDkv ? (is_d ? p.k_sn : p.v_sn) : (is_d ? p.q_sn : p.do_sn);
  const long long x_sn = kDkv ? (is_d ? p.q_sn : p.do_sn) : (is_d ? p.k_sn : p.v_sn);
  const bool r_vec = (kDkv ? (is_d ? p.vec_k : p.vec_v) : (is_d ? p.vec_q : p.vec_do)) != 0;
  const bool x_vec = (kDkv ? (is_d ? p.vec_q : p.vec_do) : (is_d ? p.vec_k : p.vec_v)) != 0;
  const float* tsb = RELBIAS ? p.ts + (long long)b * p.N : nullptr;

  // the walk. dq pass: the key tiles up to the tile's last visible column;
  // dkv pass (causal): the query steps of the contextual rows (which see
  // every column below the target boundary), then those from the key tile's
  // own on
  const bool causal = p.causal != 0;
  int end = 0;
  if (base < length) end = !kDkv && causal && base >= p.contextual_seq_len ? min(length, base + kR) : length;
  const int ctx_end = causal ? (p.contextual_seq_len + kS - 1) / kS * kS : 0;
  auto next_step = [&](int s) { return kDkv && causal && s >= ctx_end && s < base ? base : s; };

  const int n_pos = 2 * p.Nm - 1, n_ts = p.NB + 1, n_slots = min(n_ts, kTsSlots);
  float* prow = kTables && DET ? p.partial + (long long)blockIdx.x * (n_pos + n_ts) : nullptr;
  float* my_dts = dts_s + warp * kTsSlots;
  if constexpr (kTables) {
    for (int idx = threadIdx.x; idx < NW * kTsSlots; idx += T) dts_s[idx] = 0.f;
    if (DET)
      for (int idx = threadIdx.x; idx < n_pos; idx += T) prow[idx] = 0.f;
  }

  float acc[M][8][4];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][n][c] = 0.f;

  int s0 = next_step(0);
  if (s0 < end) {
#pragma unroll
    for (int i = 0; i < M; ++i)
      if (i < own) {
        load_rows<kR>(Rs + i * kR * kP, rsrc, r_sn, base, length, width, c0 + i, r_vec);
        load_rows<kS>(Xs + i * kS * kP, xsrc, x_sn, s0, length, width, c0 + i, x_vec);
      }
  }
  cp_async_commit();
  const int at = (wm * 16 + g) * kXP + wn * 16 + 2 * t;  // the lane's first pair in T's tiles
  for (int step = 0; s0 < end; ++step) {
    const int s1 = next_step(s0 + kS);
    const int stage = step & 1;
    cp_async_wait_all();
    __syncthreads();  // this step's rows are in place; every warp is done with the last step's
    if (s1 < end) {   // the next step's rows, into the other stage, while this step runs
#pragma unroll
      for (int i = 0; i < M; ++i)
        if (i < own) load_rows<kS>(Xs + ((stage ^ 1) * M + i) * kS * kP, xsrc, x_sn, s1, length, width, c0 + i, x_vec);
    }
    cp_async_commit();

    uint32_t ok_bits = 0;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int tr = wm * 16 + g + 8 * (c >> 1), tc = wn * 16 + 8 * j + 2 * t + (c & 1);
        const bool ok = kDkv ? live(p, s0 + tc, base + tr, length, nt) : live(p, base + tr, s0 + tc, length, nt);
        ok_bits |= (ok ? 1u : 0u) << (4 * j + c);
      }
    const bool dead = __all_sync(kFull, ok_bits == 0);

    // the block's part of T
    float tp[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) tp[j][c] = 0.f;
    if (!dead) {
#pragma unroll
      for (int i = 0; i < M; ++i)
        if (i < own)
          part_product(tp, Rs + i * kR * kP, Xs + (stage * M + i) * kS * kP, wm, wn, min(kC, width - (c0 + i) * kC));
    }
    if (lane == 0) part_live[warp] = !dead;
    // split: the warp's fragment of T belongs to block warp % cs, which
    // takes every block's part of it into its own buffer (remote stores, lane
    // by lane), sums them, does the fragment's per-element work and stores
    // its part of the A tile (dS or P) to every block that needs it, and the
    // float32 dS to the step's table block. Else every block reads every
    // block's part from its exchange buffer and does all the work itself.
    constexpr bool split = SPLIT;
    const int nslot = (NW + cl.cs - 1) / cl.cs, fslot = warp / cl.cs;
    const bool mine = !split || warp % cl.cs == rank;
    const int tblock = step % cl.cs;  // the step's table block
    float* xb = xch + (split ? 0 : stage * kR * kXP);
    if (split) {
      float* dst = cluster.map_shared_rank(xch, warp % cl.cs) + ((rank * nslot + fslot) * 32 + lane) * 8;
      *reinterpret_cast<float4*>(dst) = make_float4(tp[0][0], tp[0][1], tp[0][2], tp[0][3]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(tp[1][0], tp[1][1], tp[1][2], tp[1][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        *reinterpret_cast<float2*>(xb + at + 8 * j) = make_float2(tp[j][0], tp[j][1]);
        *reinterpret_cast<float2*>(xb + at + 8 * j + 8 * kXP) = make_float2(tp[j][2], tp[j][3]);
      }
    }
    cluster_arrive();
    // the bias while the other blocks arrive
    float bias[RELBIAS ? 8 : 1];
    int slot[kTables ? 8 : 1];
    if constexpr (RELBIAS) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int tr = wm * 16 + g + 8 * ((e & 3) >> 1), tc = wn * 16 + 8 * (e >> 2) + 2 * t + (e & 1);
        const int row = kDkv ? s0 + tc : base + tr, col = kDkv ? base + tr : s0 + tc;
        int bucket = 0;
        bias[e] = mine && (ok_bits >> e) & 1u
                      ? rel_bias(p, row, col, ts_row(tsb, row, p.N), ts_col(tsb, col, p.N), bucket)
                      : 0.f;
        if constexpr (kTables) slot[e] = min(bucket, n_slots - 1);
      }
    }
    cluster_wait();
    // the per-element work: the A tile (dq pass: dS; dkv pass: dS^T for the
    // D-blocks, P^T for the V-blocks); unsplit, the dq pass's V-blocks are
    // done
    const bool forms = split ? mine : kDkv || is_d;
    const bool tables = kTables && tblock == rank;
    if (forms) {
      // S and dP of the warp's fragment: every block's part, in rank order
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
      if (!dead) {
        // the part's elements 0..3 (j = 0) in x0, 4..7 in x1
        auto add = [](float (&acc)[2][4], const float4& x0, const float4& x1) {
          acc[0][0] += x0.x, acc[0][1] += x0.y, acc[0][2] += x0.z, acc[0][3] += x0.w;
          acc[1][0] += x1.x, acc[1][1] += x1.y, acc[1][2] += x1.z, acc[1][3] += x1.w;
        };
        for (int r = 0; r < cl.cs; ++r) {
          float4 x0, x1;
          if (split) {
            const float* src = xch + ((r * nslot + fslot) * 32 + lane) * 8;
            x0 = *reinterpret_cast<const float4*>(src);
            x1 = *reinterpret_cast<const float4*>(src + 4);
          } else {
            const float* src = cluster.map_shared_rank(xb, r);
            const float2 lo0 = *reinterpret_cast<const float2*>(src + at);
            const float2 hi0 = *reinterpret_cast<const float2*>(src + at + 8 * kXP);
            const float2 lo1 = *reinterpret_cast<const float2*>(src + at + 8);
            const float2 hi1 = *reinterpret_cast<const float2*>(src + at + 8 + 8 * kXP);
            x0 = make_float4(lo0.x, lo0.y, hi0.x, hi0.y);
            x1 = make_float4(lo1.x, lo1.y, hi1.x, hi1.y);
          }
          // one branch each: a runtime choice of array would put both in local memory
          if (r < cl.nd)
            add(s, x0, x1);
          else
            add(dp, x0, x1);
        }
      }
      float pv[8], ds[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        pv[e] = ds[e] = 0.f;
        if ((ok_bits >> e) & 1u) {
          const float sv = s[e >> 2][e & 3];
          const float x = RELBIAS ? fmaf(sv, s_alpha, bias[RELBIAS ? e : 0]) : sv * s_alpha;
          const float sig = __fdividef(1.f, 1.f + __expf(-x));
          ds[e] = dp[e >> 2][e & 3] * dp_scale * sig * (1.f + x * (1.f - sig));
          pv[e] = x * sig;
        }
      }
      // bfloat16: P and dS rounded before their products (`put2`)
      for (int r = split ? 0 : rank; r < (split ? cl.cs : rank + 1); ++r) {
        if (!kDkv && r >= cl.nd) break;  // the dq pass's V-blocks take no A tile
        E* Ab = split ? cluster.map_shared_rank(As, r) : As;
        const bool wants_p = kDkv && r >= cl.nd;
        float av[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) av[e] = wants_p ? pv[e] : ds[e];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          put2(Ab + at + 8 * j, av[4 * j], av[4 * j + 1]);
          put2(Ab + at + 8 * j + 8 * kXP, av[4 * j + 2], av[4 * j + 3]);
        }
      }
      if constexpr (kTables) {
        if (split || tables) {
          float* Tb = split ? cluster.map_shared_rank(Ts, tblock) : Ts;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            put2(Tb + at + 8 * j, ds[4 * j], ds[4 * j + 1]);
            put2(Tb + at + 8 * j + 8 * kXP, ds[4 * j + 2], ds[4 * j + 3]);
          }
          // dts_w: per element slot the warp takes its distinct buckets in
          // turn, sums each by shuffles, and one lane adds the sum to the
          // warp's own copy (no atomics)
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const bool ok = (ok_bits >> e) & 1u;
            const int key = slot[e];
            unsigned rest = __ballot_sync(kFull, ok);
            while (rest != 0) {
              const int first = __ffs(rest) - 1;
              const int bucket = __shfl_sync(kFull, key, first);
              const bool same = ok && key == bucket;
              float sum = same ? ds[e] : 0.f;
#pragma unroll
              for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
              if (lane == first) my_dts[bucket] += sum;
              __syncwarp();
              rest &= ~__ballot_sync(kFull, same);
            }
          }
        }
      }
    }
    if (split) {  // every block's A tile, the table block's dS^T and the flags are whole
      cluster_arrive();
      cluster_wait();
    } else {
      __syncthreads();  // the A tile, the float32 dS^T and the flags are whole
    }

    const int kn = min(kS, length - s0);  // the step's live streamed rows
    if ((kDkv || is_d) && (part_live[2 * wm] || part_live[2 * wm + 1])) {
#pragma unroll
      for (int i = 0; i < M; ++i)
        if (i < own) out_product(acc[i], As, Xs + (stage * M + i) * kS * kP, wm, wn, kn);
    }
    if constexpr (FUSED) {
      // dQ = dS K for the step's 32 query rows: warp w rows (w / 4) 16 ..,
      // columns (w % 4) 32 .. of each of the block's chunks. Where D is a
      // multiple of 4 a lane pair trades halves, so that each lane adds four
      // floats of one row at once: the even lane row g, the odd lane row g + 8
      const int wq = warp >> 2, wd = warp & 3;
      if (is_d && (part_live[wq] || part_live[2 + wq] || part_live[4 + wq] || part_live[6 + wq])) {
        const int kr = min(kR, length - base);
        const bool odd = (t & 1) != 0;
        float* dqh = static_cast<float*>(p.dq) + ((long long)b * p.N * p.H + h) * p.D;
#pragma unroll
        for (int i = 0; i < M; ++i) {
          if (i >= own) continue;
          float dq[4][4];
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int c = 0; c < 4; ++c) dq[n][c] = 0.f;
          dq_product(dq, As, Rs + i * kR * kP, wq, wd, kr);
          const int d0 = (c0 + i) * kC + wd * 32;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const float x0 = __shfl_xor_sync(kFull, odd ? dq[n][0] : dq[n][2], 1);
            const float x1 = __shfl_xor_sync(kFull, odd ? dq[n][1] : dq[n][3], 1);
            if (p.D % 4 == 0) {
              const int row = s0 + wq * 16 + g + (odd ? 8 : 0);
              const int d = d0 + n * 8 + 2 * (t & ~1);
              if (row < length && d < p.D) {
                const float4 x = odd ? make_float4(x0, x1, dq[n][2], dq[n][3]) : make_float4(dq[n][0], dq[n][1], x0, x1);
                atomicAdd(reinterpret_cast<float4*>(dqh + (long long)row * p.H * p.D + d),
                          make_float4(p.alpha * x.x, p.alpha * x.y, p.alpha * x.z, p.alpha * x.w));
              }
            } else {
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const int row = s0 + wq * 16 + g + 8 * (c / 2);
                const int d = d0 + n * 8 + 2 * t + c % 2;
                if (row < length && d < p.D) atomicAdd(dqh + (long long)row * p.H * p.D + d, p.alpha * dq[n][c]);
              }
            }
          }
        }
      }
    }
    if constexpr (kTables) {
      if (tables) {
        // dpos_w: diagonal d holds the elements with col - row = d - (kS - 1)
        // + base - s0
        const int d = threadIdx.x;
        const int last = s0 + kS - 1;
        float sum = 0.f;
        if (d < kDiags)
          for (int tc = 0; tc < kS; ++tc) {
            const int tr = d - (kS - 1) + tc;
            if (tr >= 0 && tr < kR) sum += Ts[tr * kXP + tc];
          }
        if constexpr (DET) {
          // each run of diagonals that meet on one entry (one diagonal, or
          // those clipped where N > Nm) summed in order by one thread, into
          // the block's row
          if (d < kDiags) diag[d] = sum;
          __syncthreads();
          if (d < kDiags) {
            const int idx = hstu::pos_index(last, base + d, p.Nm);
            if (d == 0 || hstu::pos_index(last, base + d - 1, p.Nm) != idx) {
              float run = 0.f;
              for (int e = d; e < kDiags && hstu::pos_index(last, base + e, p.Nm) == idx; ++e) run += diag[e];
              prow[idx] += run;
            }
          }
        } else {
          if (d < kDiags && sum != 0.f) atomicAdd(p.dpos + hstu::pos_index(last, base + d, p.Nm), sum);
        }
      }
    }
    s0 = s1;
  }

  if constexpr (kTables) {
    __syncthreads();  // every warp's copy of dts_w's sums is whole
    for (int idx = threadIdx.x; idx < (DET ? n_ts : n_slots); idx += T) {
      // DET: every entry of the row; else the slots, each to its bucket
      // (slot n_slots - 1 holds bucket NB)
      const int sl = DET ? (idx < n_slots - 1 ? idx : (idx == p.NB ? n_slots - 1 : -1)) : idx;
      float sum = 0.f;
      if (sl >= 0)
        for (int w = 0; w < NW; ++w) sum += dts_s[w * kTsSlots + sl];
      if constexpr (DET) {
        prow[n_pos + idx] = sum;
      } else {
        if (sum != 0.f) atomicAdd(p.dts + (idx == n_slots - 1 ? p.NB : idx), sum);
      }
    }
  }
  // no block leaves while another may still read its exchange buffers
  cluster_arrive();

  // every element of the block's chunks in the tile's rows: zeros where the
  // tile is dead (the dq pass's V-blocks own no output)
  if (kDkv || is_d) {
    E* out = kDkv ? (is_d ? p.dk : p.dv) : static_cast<E*>(p.dq);
    const float scale = kDkv ? (is_d ? s_alpha : dp_scale) : p.alpha;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (i >= own) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = base + wm * 16 + g + 8 * r;
        if (row >= p.N) continue;
        E* dst = out + (((long long)b * p.N + row) * p.H + h) * width;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          store2(dst, (c0 + i) * kC + wn * 64 + 8 * n + 2 * t, width, scale * acc[i][n][2 * r],
                 scale * acc[i][n][2 * r + 1]);
      }
    }
  }
  cluster_wait();
}

// ------------------------------------------------------------------ forward
// One thread block cluster of cs blocks per (64-row query tile, head, batch
// row) (`FwdCluster`): block r owns D's columns [r dw, r dw + dw) and V's
// columns [r vw, r vw + vw) (the last blocks' may be short or empty), in md
// and mv tiles of up to 128 columns. It keeps its columns of Q resident for
// the whole walk and streams its columns of K and V, 32 key rows a step in
// two stages (the next step's rows arrive while this step runs). Per step
// each block forms only its own part of S = Q K^T, over its D columns; the
// parts are summed through distributed shared memory in rank order (S, and so
// O, the same bits on every run; no atomics), the per-element work (mask,
// bias, silu) fills each block's P tile, and each block adds P V for its own
// V columns to O in registers:
// * SPLIT (clusters of kFwdSplitFrom blocks and more): warp w's fragment of
//   S belongs to block w % cs, which takes every block's part of it (remote
//   stores), sums them, does the fragment's per-element work and stores its
//   P into every block's P tile; two cluster barriers a step;
// * else every block reads every block's part of S (remote loads) and does
//   all the per-element work itself; one cluster barrier a step; the P tile
//   lies in the exchange buffer of the other stage, which no block reads
//   during the step.
// 8 warps: warp w forms S's rows (w / 2) 16 .. + 16, columns (w % 2) 16 ..
// + 16 of the step, and O's rows (w / 2) 16 .. + 16 in half of each of the
// block's V tiles. Products per live element and head: S 2 D, P V 2 V, each
// once. float32 multiplies in 3xTF32; bfloat16 keeps bfloat16 tiles and
// multiplies with m16n8k16 on `ldmatrix` fragments, at the narrow body's
// rounding points: alpha q rounded once as Q is staged, P rounded to
// bfloat16 before P V, S and O summed in float32.
struct FwdCluster {
  int cs, dw, vw, md, mv, split;
};
// Clusters of this many blocks and more split the per-element work by
// fragment; smaller ones repeat it in every block (PERF.md has both: split,
// 2 blocks lost 3-7%, 4 blocks won 14-16%)
constexpr int kFwdSplitFrom = 4;
// the tiles a block holds at most: md + mv (two of either at most)
constexpr int kFwdMaxTiles = 3;

// The pitch of a block's tiles of w columns: w + 8 where one tile holds them,
// else kP (tiles of 128)
__host__ __device__ constexpr int fwd_pitch(int w) { return (w < kC ? w : kC) + 8; }

// A block's shared memory: Q [md][64][pd] and two stages of K [2][md][32][pd]
// and of V [2][mv][32][pv] of the element type, two float32 exchange buffers
// [2][64][kXP] (or the receive buffer), SPLIT the P tile [64][kXP] of the
// element type (else in the exchange buffers), the warps' live flags
inline int fwd_smem_bytes(int elem, const FwdCluster& c) {
  const int pd = fwd_pitch(c.dw), pv = fwd_pitch(c.vw);
  return elem * (c.md * kR * pd + 2 * c.md * kS * pd + 2 * c.mv * kS * pv + (c.split ? kR * kXP : 0)) +
         4 * (kXchFloats + kBwdThreads / 32);
}

// The forward's cluster (mirrored by `_wide_fwd_cluster` in
// ops/cuda/hstu_attention.py): a block per chunk of V or per two chunks of D,
// whichever needs more, 16 at most (a block's S part over more of D spreads
// each step's fixed costs: at D 512 / V 64, 2 blocks of 256 columns took
// 0.83 ms in float32 where 4 of 128 took 0.98); each block's columns of D and
// of V the widths' shares rounded up to 32. cs = 0 where a block would hold
// more than kFwdMaxTiles tiles (the per-chunk forward takes those widths,
// route kWideChunks).
inline FwdCluster fwd_cluster_of(int D, int V) {
  const int cs = min(kMaxCluster, max((chunks(D) + 1) / 2, chunks(V)));
  const int dw = ((D + cs - 1) / cs + 31) / 32 * 32, vw = ((V + cs - 1) / cs + 31) / 32 * 32;
  const int md = chunks(dw), mv = chunks(vw);
  if (md > kMaxOwn || mv > kMaxOwn || md + mv > kFwdMaxTiles) return {0, 0, 0, 0, 0, 0};
  return {cs, dw, vw, md, mv, cs >= kFwdSplitFrom ? 1 : 0};
}

// Columns [0, w) of one head's rows [r0, r0 + ROWS) (src at the block's
// first column) into a [ROWS][pitch] tile of the element type: zeros at rows
// >= lim and at columns [w, w rounded up to 32); later columns are neither
// loaded nor read. float32 by `cp.async` (16-byte pieces where vec).
template <int ROWS>
__device__ __forceinline__ void fwd_load(float* dst, const float* src, long long sn, int r0, int lim, int w,
                                         int pitch, bool vec, float /*scale*/) {
  if (w <= 0) return;
  const int wp = (w + 31) & ~31;
  if (vec) {
    for (int idx = threadIdx.x; idx < ROWS * (kC / 4); idx += kBwdThreads) {
      const int r = idx / (kC / 4), c = idx % (kC / 4) * 4;
      if (c >= wp) continue;
      const bool ok = r0 + r < lim && c < w;
      cp_async16(dst + r * pitch + c, ok ? src + (long long)(r0 + r) * sn + c : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * kC; idx += kBwdThreads) {
      const int r = idx / kC, c = idx % kC;
      if (c >= wp) continue;
      const bool ok = r0 + r < lim && c < w;
      cp_async4(dst + r * pitch + c, ok ? src + (long long)(r0 + r) * sn + c : src, ok);
    }
  }
}
// bfloat16: by 16-byte `cp.async` where vec (pieces of 8), else element by
// element; where scale != 1 (alpha q) each element stored as bfloat16(x
// scale), synchronously. A synchronous tile is in place after the barrier
// that follows, as an asynchronous one after its wait and that barrier.
template <int ROWS>
__device__ __forceinline__ void fwd_load(__nv_bfloat16* dst, const __nv_bfloat16* src, long long sn, int r0,
                                         int lim, int w, int pitch, bool vec, float scale) {
  if (w <= 0) return;
  const int wp = (w + 31) & ~31;
  if (vec) {
    for (int idx = threadIdx.x; idx < ROWS * (kC / 8); idx += kBwdThreads) {
      const int r = idx / (kC / 8), c = idx % (kC / 8) * 8;
      if (c >= wp) continue;
      const bool ok = r0 + r < lim && c < w;
      if (scale != 1.f) {
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (ok) x = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * sn + c);
        uint32_t* e = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
        for (int i = 0; i < 4; ++i)  // a bfloat16 is the top half of the float32 of the same value
          e[i] = hstu_bf16::pack(__uint_as_float(e[i] << 16) * scale, __uint_as_float(e[i] & 0xffff0000u) * scale);
        *reinterpret_cast<uint4*>(dst + r * pitch + c) = x;
      } else {
        hstu_bf16::cp_async16(dst + r * pitch + c, ok ? src + (long long)(r0 + r) * sn + c : src, ok);
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * kC; idx += kBwdThreads) {
      const int r = idx / kC, c = idx % kC;
      if (c >= wp) continue;
      const float x = r0 + r < lim && c < w ? __bfloat162float(src[(long long)(r0 + r) * sn + c]) : 0.f;
      dst[r * pitch + c] = __float2bfloat16_rn(x * scale);
    }
  }
}

// acc += P X for the warp's 16 rows (wm 16 ..) by nt 8-column tiles of X from
// column n0: P the block's [64][kXP] tile, X [kS][pitch], k over the step's
// kn live key rows. float32 sums the step's share in fresh accumulators, then
// adds it in float32 (as `out_product`); bfloat16 sums in place, and where nt
// is odd also forms the next tile, which nobody stores.
__device__ __forceinline__ void pv_product(float (&acc)[8][4], const float* P, const float* X, int pitch, int wm,
                                           int n0, int nt, int kn) {
  const int steps = (kn + 7) / 8;
  float part[8][4] = {};
  for (int ks = 0; ks < steps; ++ks) {
    const FragA a = load_a(P, kXP, wm * 16, ks * 8);
#pragma unroll
    for (int n = 0; n < 8; ++n)
      if (n < nt) mma3(part[n], a, load_b_kn<true>(X, pitch, ks * 8, n0 + n * 8));
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] += part[n][c];
}
__device__ __forceinline__ void pv_product(float (&acc)[8][4], const __nv_bfloat16* P, const __nv_bfloat16* X,
                                           int pitch, int wm, int n0, int nt, int kn) {
  const int steps = (kn + 15) / 16;
  for (int ks = 0; ks < steps; ++ks) {
    uint32_t a[4];
    hstu_bf16::ldsm(a, hstu_bf16::a_at(P, kXP, wm * 16, ks * 16));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (2 * np >= nt) break;
      uint32_t b[4];
      hstu_bf16::ldsm_t(b, hstu_bf16::b_kn_at(X, pitch, ks * 16, n0 + np * 16));
      hstu_bf16::mma(acc[2 * np], a, b[0], b[1]);
      hstu_bf16::mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// The two warps of row group wm, which write and read rows wm 16 .. + 16 of
// the P tile (named barrier 1 + wm of 64 threads; 0 is __syncthreads')
__device__ __forceinline__ void pair_sync(int wm) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + wm) : "memory");
}

// A warp's columns of a V tile of w live columns: [n0, n0 + 8 nt) of the
// tile, the two warps of a row group a half each (in 16-column steps)
__device__ __forceinline__ void pv_cols(int w, int wn, int& n0, int& nt) {
  w = max(w, 0);
  const int half = ((w + 1) / 2 + 15) & ~15;
  n0 = wn * half;
  nt = (max(0, min(w, n0 + half) - n0) + 7) / 8;
}

template <int BIAS, int MV, bool SPLIT, typename E>
__global__ void __launch_bounds__(kBwdThreads, MV == 1 ? 2 : 1) fwd_kernel(Params<E> p, FwdCluster cl) {
  namespace cg = cooperative_groups;
  constexpr bool kBf16 = !std::is_same<E, float>::value;
  constexpr int NW = kBwdThreads / 32;
  // bfloat16: alpha rides Q, rounded; S then takes none
  const float s_alpha = kBf16 ? 1.f : p.alpha;
  const float q_scale = kBf16 && p.alpha != 1.f ? round_bf16(p.alpha) : 1.f;
  const int pd = fwd_pitch(cl.dw), pv = fwd_pitch(cl.vw), md = cl.md, cs = cl.cs;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* Qs = reinterpret_cast<E*>(smem_raw);                           // [md][kR][pd]
  E* Ks = Qs + md * kR * pd;                                         // [2][md][kS][pd]
  E* Vs = Ks + 2 * md * kS * pd;                                     // [2][MV][kS][pv]
  float* xch = reinterpret_cast<float*>(Vs + 2 * MV * kS * pv);      // [2][kR][kXP] or [kRecvSlots][256]
  E* Ps = reinterpret_cast<E*>(xch + kXchFloats);                    // SPLIT: [kR][kXP]
  int* part_live = reinterpret_cast<int*>(SPLIT ? Ps + kR * kXP : Ps);  // [NW]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  // the cluster's unit counts the head first and the tile last, from the
  // row's end: the longest walks start first
  int unit = (int)(blockIdx.x / (unsigned)cs);
  const int h = unit % p.H;
  unit /= p.H;
  const int b = unit % p.B;
  const int n_tiles = (p.N + kR - 1) / kR;
  const int base = (n_tiles - 1 - unit / p.B) * kR;
  const int length = min(p.lengths[b], p.N);
  const int nt = p.num_targets ? p.num_targets[b] : 0;
  // the block's columns of D and of V
  const int dlo = rank * cl.dw, vlo = rank * cl.vw;
  const int dcols = max(0, min(cl.dw, p.D - dlo)), vcols = max(0, min(cl.vw, p.V - vlo));
  const E* qb = p.q + b * p.q_sb + h * p.q_sh + dlo;
  const E* kb = p.k + b * p.k_sb + h * p.k_sh + dlo;
  const E* vb = p.v + b * p.v_sb + h * p.v_sh + vlo;
  const float* tsb = BIAS == kRelBias ? p.ts + (long long)b * p.N : nullptr;
  // the walk: the key tiles up to the tile's last visible column
  int end = 0;
  if (base < length) end = p.causal && base >= p.contextual_seq_len ? min(length, base + kR) : length;
  auto load_step = [&](int stage, int s) {
    for (int i = 0; i < md; ++i)
      fwd_load<kS>(Ks + (stage * md + i) * kS * pd, kb + i * kC, p.k_sn, s, length, min(kC, dcols - i * kC), pd,
                   p.vec_k != 0, 1.f);
#pragma unroll
    for (int i = 0; i < MV; ++i)
      if (i < cl.mv)
        fwd_load<kS>(Vs + (stage * MV + i) * kS * pv, vb + i * kC, p.v_sn, s, length, min(kC, vcols - i * kC), pv,
                     p.vec_v != 0, 1.f);
  };

  float acc[MV][8][4];
#pragma unroll
  for (int i = 0; i < MV; ++i)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][n][c] = 0.f;

  if (end > 0) {
    for (int i = 0; i < md; ++i)
      fwd_load<kR>(Qs + i * kR * pd, qb + i * kC, p.q_sn, base, length, min(kC, dcols - i * kC), pd, p.vec_q != 0,
                   q_scale);
    load_step(0, 0);
  }
  cp_async_commit();
  const int at = (wm * 16 + g) * kXP + wn * 16 + 2 * t;  // the lane's first pair in S's tiles
  float tq[2] = {0.f, 0.f};                                // the rows' next timestamps
  if constexpr (BIAS == kRelBias) {
    tq[0] = ts_row(tsb, base + wm * 16 + g, p.N);
    tq[1] = ts_row(tsb, base + wm * 16 + g + 8, p.N);
  }
  for (int step = 0, s0 = 0; s0 < end; ++step, s0 += kS) {
    const int stage = step & 1;
    cp_async_wait_all();
    __syncthreads();  // this step's rows are in place; every warp is done with the last step's
    if (s0 + kS < end) load_step(stage ^ 1, s0 + kS);  // the next step's, into the other stage
    cp_async_commit();

    // element e = 4 j + c of the warp's fragment: row base + wm 16 + g + 8 (c
    // / 2), column s0 + wn 16 + 8 j + 2 t + c % 2
    uint32_t ok_bits = 0;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok = live(p, base + wm * 16 + g + 8 * (c >> 1), s0 + wn * 16 + 8 * j + 2 * t + (c & 1), length, nt);
        ok_bits |= (ok ? 1u : 0u) << (4 * j + c);
      }
    const bool dead = __all_sync(kFull, ok_bits == 0);

    // the block's part of S
    float sp[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) sp[j][c] = 0.f;
    if (!dead) {
      for (int i = 0; i < md; ++i) {
        const int kw = min(kC, dcols - i * kC);
        if (kw > 0) part_product(sp, Qs + i * kR * pd, Ks + (stage * md + i) * kS * pd, wm, wn, kw, pd);
      }
    }
    if (lane == 0) part_live[warp] = !dead;
    const int nslot = (NW + cs - 1) / cs, fslot = warp / cs;
    const bool mine = !SPLIT || warp % cs == rank;
    float* xs = xch + (SPLIT ? 0 : stage * kR * kXP);  // the step's exchange buffer
    // the P tile; repeated, in the other stage's exchange buffer, which every
    // block has read (last step's) before the barrier below lets it on
    E* Pt = SPLIT ? Ps : reinterpret_cast<E*>(xch + (stage ^ 1) * kR * kXP);
    if constexpr (SPLIT) {
      float* dst = cluster.map_shared_rank(xch, warp % cs) + ((rank * nslot + fslot) * 32 + lane) * 8;
      *reinterpret_cast<float4*>(dst) = make_float4(sp[0][0], sp[0][1], sp[0][2], sp[0][3]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(sp[1][0], sp[1][1], sp[1][2], sp[1][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        *reinterpret_cast<float2*>(xs + at + 8 * j) = make_float2(sp[j][0], sp[j][1]);
        *reinterpret_cast<float2*>(xs + at + 8 * j + 8 * kXP) = make_float2(sp[j][2], sp[j][3]);
      }
    }
    cluster_arrive();
    // the bias, while the other blocks arrive
    float bias[BIAS == kNoBias ? 1 : 8];
    if constexpr (BIAS != kNoBias) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int row = base + wm * 16 + g + 8 * ((e & 3) >> 1), col = s0 + wn * 16 + 8 * (e >> 2) + 2 * t + (e & 1);
        bias[e] = 0.f;
        if (mine && (ok_bits >> e) & 1u) {
          if constexpr (BIAS == kRelBias) {
            int bucket;
            bias[e] = rel_bias(p, row, col, tq[(e & 3) >> 1], ts_col(tsb, col, p.N), bucket);
          } else {
            bias[e] = dense_bias(p, b, row, col);
          }
        }
      }
    }
    cluster_wait();
    if (mine) {
      // S of the warp's fragment: every block's part, in rank order
      float s[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) s[e] = 0.f;
      if (!dead) {
        for (int r = 0; r < cs; ++r) {
          float4 x0, x1;
          if constexpr (SPLIT) {
            const float* src = xch + ((r * nslot + fslot) * 32 + lane) * 8;
            x0 = *reinterpret_cast<const float4*>(src);
            x1 = *reinterpret_cast<const float4*>(src + 4);
          } else {
            const float* src = cluster.map_shared_rank(xs, r);
            const float2 lo0 = *reinterpret_cast<const float2*>(src + at);
            const float2 hi0 = *reinterpret_cast<const float2*>(src + at + 8 * kXP);
            const float2 lo1 = *reinterpret_cast<const float2*>(src + at + 8);
            const float2 hi1 = *reinterpret_cast<const float2*>(src + at + 8 + 8 * kXP);
            x0 = make_float4(lo0.x, lo0.y, hi0.x, hi0.y);
            x1 = make_float4(lo1.x, lo1.y, hi1.x, hi1.y);
          }
          s[0] += x0.x, s[1] += x0.y, s[2] += x0.z, s[3] += x0.w;
          s[4] += x1.x, s[5] += x1.y, s[6] += x1.z, s[7] += x1.w;
        }
      }
      // P = silu(alpha S + bias) on live elements; bfloat16: rounded (`put2`)
      float pe[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        pe[e] = 0.f;
        if ((ok_bits >> e) & 1u) {
          const float x = BIAS == kNoBias ? s[e] * s_alpha : fmaf(s[e], s_alpha, bias[BIAS == kNoBias ? 0 : e]);
          pe[e] = __fdividef(x, 1.f + __expf(-x));
        }
      }
      for (int r = SPLIT ? 0 : rank; r < (SPLIT ? cs : rank + 1); ++r) {
        E* Pb = SPLIT ? cluster.map_shared_rank(Ps, r) : Pt;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          put2(Pb + at + 8 * j, pe[4 * j], pe[4 * j + 1]);
          put2(Pb + at + 8 * j + 8 * kXP, pe[4 * j + 2], pe[4 * j + 3]);
        }
      }
    }
    if constexpr (!SPLIT) {
      pair_sync(wm);  // the row group's rows of the P tile and its flags are whole
    } else {  // every block's P tile and the flags are whole
      cluster_arrive();
      cluster_wait();
    }

    // O += P V over the block's V tiles, for the warp's rows where any is live
    const int kn = min(kS, length - s0);
    if (part_live[2 * wm] || part_live[2 * wm + 1]) {
#pragma unroll
      for (int i = 0; i < MV; ++i) {
        int n0, ntiles;
        pv_cols(min(kC, vcols - i * kC), wn, n0, ntiles);
        if (i < cl.mv && ntiles > 0) pv_product(acc[i], Pt, Vs + (stage * MV + i) * kS * pv, pv, wm, n0, ntiles, kn);
      }
    }
  }
  // no block leaves while another may still read its exchange buffers or
  // store into its P tile
  cluster_arrive();

  // every element of the block's V columns in the tile's rows below N: zeros
  // where the row is dead
#pragma unroll
  for (int i = 0; i < MV; ++i) {
    int n0, ntiles;
    pv_cols(min(kC, vcols - i * kC), wn, n0, ntiles);
    if (i >= cl.mv) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = base + wm * 16 + g + 8 * r;
      if (row >= p.N) continue;
      E* o = static_cast<E*>(p.out) + (((long long)b * p.N + row) * p.H + h) * p.V;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        if (n < ntiles)
          store2(o, vlo + i * kC + n0 + 8 * n + 2 * t, p.V, acc[i][n][2 * r] * p.inv_norm,
                 acc[i][n][2 * r + 1] * p.inv_norm);
    }
  }
  cluster_wait();
}

// ----------------------------------------------------------- tile forward
// Route kWideTile: the float32 forward (K1, K1-bias) at D up to 256 and V of
// 129 to 256, and at D up to 128 V up to 384 (the Python plan chooses). One
// block of 8 warps per (64-row query tile, head, batch row), no cluster.
// Warp w owns query rows (w / 2) 16 .. + 16 (its row group) and half of D's
// and of V's columns (w % 2). Per step of 32 key rows the two warps of a
// row group each form their part of S = Q K^T for the group's 16 rows and
// the step's keys over their half of D, in fresh float32 accumulators, and
// meet in the exchange buffer under the group's named barrier
// (`pair_sync`): S = the two parts' float32 sum, the same bits in both
// warps, so both form P = silu(alpha S + bias) on the live elements and keep
// it in registers as the A fragments of P V (`frag_a_c`); each then adds P V
// over its half of V's columns to O in registers, the step's share in fresh
// accumulators added in float32. S is formed once per (query tile, key
// step) and each bias element read once: products per live element and
// head 2 D + 2 V.
// Bound on this card by shared memory's bandwidth and the tensor cores'
// `mma.sync` rate together (PERF.md's knock-outs), so what the products read
// from shared memory is cut to the fragments: Q stays resident for the whole
// walk, in registers up to D 128 (each lane's A fragments of its warp's half
// of D, loaded once), in shared memory past it (held in registers it
// spilled); K and V stream as float32 tiles in two stages by `cp.async`
// (the next step's rows issued before this step's products); each fragment
// is split into its TF32 big and small parts as it is read (tiles of both
// parts, split once as they land, read twice the bytes: PERF.md has both),
// 8 bytes a lane: K's pair along D in one load, V's pair of key rows in
// two, pitches 8 and 4 past a multiple of 32 floats, no bank conflicts.
// 3xTF32 (`mma.sync.m16n8k8`), the small parts' products in accumulators
// apart from the big parts'; no branch inside a group of P V's products, so
// that their loads run ahead of them.
// Shared memory at D = V = 256: 218,112 bytes; at D 128 / V 256, 117,760; one
// block (8 warps) an SM, registers up to 255 a thread.
constexpr int kTileRows = 64;             // query rows of a block
constexpr int kTileStep = 32;             // key rows a step
constexpr int kTileNs = kTileStep / 8;    // S's 8-key tiles a step (P V's k-steps)
constexpr int kTileMaxD = 256;            // Q's 16 k-steps a lane holds
constexpr int kTileMaxV = 384;            // 24 of O's 8-column tiles a warp (D up to 128)
// D and V rounded up to 32: a warp's half of either is whole k-steps or
// 8-column tiles, and the tiles' pitches (Dp + 8, Vp + 4) keep the
// fragments' loads free of bank conflicts
__host__ __device__ constexpr int tile_width(int w) { return (w + 31) / 32 * 32; }
// A block's shared memory: two stages of K [32][Dp + 8] and of V [32][Vp +
// 4] float32; the exchange buffer, each warp's part of S a float4 a lane
// and 8-key tile [8][4][32]; at D past 128 Q [64][Dp + 8] float32
__host__ __device__ constexpr int tile_smem_bytes(int D, int V) {
  return 4 * 2 * kTileStep * (tile_width(D) + 8 + tile_width(V) + 4) + 16 * kBwdThreads * kTileNs +
         (tile_width(D) > 128 ? 4 * kTileRows * (tile_width(D) + 8) : 0);
}
// Whether the tile forward takes the widths (its registers: Q's and O's)
__host__ __device__ constexpr bool tile_takes(int D, int V) {
  return D <= kTileMaxD && V <= kTileMaxV && (D <= 128 || V <= 256);
}

// 4 consecutive float32 values at src, w of them inside the row's width,
// into dst by `cp.async` (one 16-byte piece where vec): zeros where !row_ok
// and past the width (the copy then reads nothing, at a valid address: base)
__device__ __forceinline__ void tile_load4(float* dst, const float* src, const float* base, bool row_ok, int w,
                                           bool vec) {
  if (vec) {
    const bool ok = row_ok && w > 0;
    cp_async16(dst, ok ? src : base, ok);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = row_ok && e < w;
      cp_async4(dst + e, ok ? src + e : base, ok);
    }
  }
}

// Rows [r0, r0 + ROWS) of width w (columns [0, wp), wp a multiple of 4) into
// a [ROWS][pitch] float32 tile: zeros past the length and w. The thread's
// pieces are stepped through with no division or 64-bit product a piece:
// 256 pieces on is rows + 256 / (wp / 4), the column piece + 256 % (wp / 4)
template <int ROWS>
__device__ __forceinline__ void tile_rows(float* dst, const float* src, long long sn, int r0, int length, int w,
                                          int wp, int pitch, bool vec) {
  const int n4 = wp / 4, dr = kBwdThreads / n4, dc = 4 * (kBwdThreads % n4);
  int r = threadIdx.x / n4, c = 4 * (threadIdx.x % n4);
  const float* s = src + (long long)(r0 + r) * sn + c;
  float* d = dst + r * pitch + c;
  while (r < ROWS) {
    tile_load4(d, s, src, r0 + r < length, w - c, vec);
    r += dr;
    c += dc;
    s += dr * sn + dc;
    d += dr * pitch + dc;
    if (c >= wp) c -= wp, ++r, s += sn - wp, d += pitch - wp;
  }
}

// A step's K and V rows [s0, s0 + 32) into a stage
__device__ __forceinline__ void tile_issue(float* ks, float* vs, const float* kb, const float* vb,
                                           const Params<float>& p, int s0, int length, int dp, int vp) {
  tile_rows<kTileStep>(ks, kb, p.k_sn, s0, length, p.D, dp, dp + 8, p.vec_k != 0);
  tile_rows<kTileStep>(vs, vb, p.v_sn, s0, length, p.V, vp, vp + 4, p.vec_v != 0);
}

// The lane's values of Q's A fragments over its warp's half of D, k-step ks
// at columns c0 = d_lo + 8 ks: q[ks] = (row g, c0 + 2 t), (row g + 8, c0 +
// 2 t), (row g, c0 + 2 t + 1), (row g + 8, c0 + 2 t + 1), in `load_a`'s
// order; zeros past the length and D
template <int QK>
__device__ __forceinline__ void tile_load_q(float (&q)[QK][4], const float* qb, const Params<float>& p, int r0,
                                            int length, int d_lo, int nks) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int ks = 0; ks < QK; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + 8 * (e & 1), col = d_lo + 8 * ks + 2 * t + (e >> 1);
      q[ks][e] = ks < nks && row < length && col < p.D ? __ldg(qb + (long long)row * p.q_sn + col) : 0.f;
    }
}

// QK: Q's k-steps a lane holds in registers (8, for D up to 128), or 0: Q
// resident in shared memory [64][Dp + 8] (D of 129 to 256, where registers
// held for Q spilled); NTV: O's 8-column tiles a warp holds (16 for V up to
// 256, 24 up to 384)
template <int BIAS, int QK, int NTV>
__global__ void __launch_bounds__(kBwdThreads, 1) tile_fwd_kernel(Params<float> p) {
  constexpr int NS = kTileNs;
  const int dp = tile_width(p.D), vp = tile_width(p.V);
  const int kp = dp + 8, vpp = vp + 4;                 // the tiles' pitches (and Q's: kp)
  const int dh = dp / 2, vh = vp / 2, nvt = vh / 8;  // a warp's columns of D and of V, its O tiles
  const int k_stage = kTileStep * kp, v_stage = kTileStep * vpp;  // floats
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                  // [2][32][kp]
  float* Vs = Ks + 2 * k_stage;      // [2][32][vpp]
  float* xch = Vs + 2 * v_stage;     // [8][NS][32] float4s
  float* Qs = xch + 4 * NS * kBwdThreads;  // QK 0: [64][kp]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  // the block's unit counts the head first and the tile last, from the
  // row's end: the longest walks start first
  int unit = (int)blockIdx.x;
  const int h = unit % p.H;
  unit /= p.H;
  const int b = unit % p.B;
  const int n_tiles = (p.N + kTileRows - 1) / kTileRows;
  const int base = (n_tiles - 1 - unit / p.B) * kTileRows;
  const int length = min(p.lengths[b], p.N);
  const int nt = p.num_targets ? p.num_targets[b] : 0;
  // the walk: the key rows up to the tile's last visible column
  int end = 0;
  if (base < length) end = p.causal && base >= p.contextual_seq_len ? min(length, base + kTileRows) : length;
  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;
  // a row group's part of the step lies wholly inside the mask (the narrow
  // body's test): causal, every row and column live, the last column
  // before the first row's own, the first inside the last row's window;
  // contextual rows and columns folded onto 0, clipped at the targets
  const int ctx = p.contextual_seq_len, mal = p.max_attn_len;
  const int max_ids = length - (ctx > 0 ? ctx - 1 : 0) - nt;
  auto fold = [&](int x) { return min(ctx > 0 ? max(x - ctx + 1, 0) : x, max_ids); };
  const int r_first = base + wm * 16;
  const int d_lo = wn * dh, nks = dh / 8;  // the warp's half of D: nks k-steps from column d_lo

  float acc[NTV][4];
#pragma unroll
  for (int n = 0; n < NTV; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  if (end > 0) {
    if constexpr (QK == 0) tile_rows<kTileRows>(Qs, qb, p.q_sn, base, length, p.D, dp, kp, p.vec_q != 0);
    tile_issue(Ks, Vs, kb, vb, p, 0, length, dp, vp);
  }
  cp_async_commit();
  float q[QK > 0 ? QK : 1][4];
  if constexpr (QK > 0) tile_load_q<QK>(q, qb, p, r_first, end > 0 ? length : 0, d_lo, nks);
  // the row group's parts of S, a float4 a lane and 8-key tile: the warp's
  // and its partner's
  float4* mine = reinterpret_cast<float4*>(xch) + warp * NS * 32 + lane;
  const float4* other = reinterpret_cast<const float4*>(xch) + (warp ^ 1) * NS * 32 + lane;
  for (int step = 0, s0 = 0; s0 < end; ++step, s0 += kTileStep) {
    const float* ks = Ks + (step & 1) * k_stage;
    const float* vs = Vs + (step & 1) * v_stage;
    cp_async_wait_all();
    __syncthreads();  // the step's K and V rows are in place; every warp is done with the last step's
    if (s0 + kTileStep < end)
      tile_issue(Ks + ((step + 1) & 1) * k_stage, Vs + ((step + 1) & 1) * v_stage, kb, vb, p, s0 + kTileStep, length,
                 dp, vp);
    cp_async_commit();

    // element e = 4 j + c of the row group's part: row r_first + g + 8 (c /
    // 2), column s0 + 8 j + 2 t + c % 2
    const int c_last = s0 + kTileStep - 1;
    const bool interior = p.causal && r_first + 15 < length && c_last < length && fold(c_last) < fold(r_first) &&
                          (mal == 0 || fold(s0) >= fold(r_first + 15) - mal);
    uint32_t ok_bits = ~0u;
    if (!interior) {
      ok_bits = 0;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool ok = live(p, r_first + g + 8 * (c >> 1), s0 + 8 * j + 2 * t + (c & 1), length, nt);
          ok_bits |= (ok ? 1u : 0u) << (4 * j + c);
        }
    }
    // the row group's part is dead: both its warps skip the step
    if (__all_sync(kFull, ok_bits == 0)) continue;
    // the dense bias of the live elements, while S is formed
    float bias[BIAS == kNoBias ? 1 : 4 * NS];
    if constexpr (BIAS == kDenseBias) {
#pragma unroll
      for (int e = 0; e < 4 * NS; ++e)
        bias[e] = (ok_bits >> e) & 1u
                      ? dense_bias(p, b, r_first + g + 8 * ((e & 3) >> 1), s0 + 8 * (e >> 2) + 2 * t + (e & 1))
                      : 0.f;
    }

    // the warp's part of S, over its half of D's columns
    float sb[NS][4], ss[NS][4];  // the big parts' products; the small parts'
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) sb[j][c] = ss[j][c] = 0.f;
#pragma unroll
    for (int kq = 0; kq < (QK > 0 ? QK : kTileMaxD / 16); ++kq) {
      if (kq >= nks) break;
      FragA a;
      if constexpr (QK > 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) split(q[kq][e], a.big[e], a.small[e]);
      } else {
        a = load_a(Qs, kp, wm * 16, d_lo + 8 * kq);
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const FragB f = load_b_nk(ks, kp, 8 * j, d_lo + 8 * kq);
        mma_tf32(ss[j], a.small, f.big);
        mma_tf32(ss[j], a.big, f.small);
        mma_tf32(sb[j], a.big, f.big);
      }
    }
    // S: the two halves' parts summed (a sum of two: the same bits in both
    // warps of the row group)
#pragma unroll
    for (int j = 0; j < NS; ++j)
      mine[32 * j] = make_float4(sb[j][0] + ss[j][0], sb[j][1] + ss[j][1], sb[j][2] + ss[j][2], sb[j][3] + ss[j][3]);
    pair_sync(wm);  // both parts of the row group's S are in place
    // P = silu(alpha S + bias) on the live elements (split into P V's A
    // fragments where they are used: fewer registers held across P V)
    float pj[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float4 x0 = mine[32 * j], x1 = other[32 * j];
      const float sj[4] = {x0.x + x1.x, x0.y + x1.y, x0.z + x1.z, x0.w + x1.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int e = 4 * j + c;
        float x = BIAS == kNoBias ? sj[c] * p.alpha : fmaf(sj[c], p.alpha, bias[BIAS == kNoBias ? 0 : e]);
        x = __fdividef(x, 1.f + __expf(-x));
        pj[j][c] = (ok_bits >> e) & 1u ? x : 0.f;
      }
    }
    // O += P V over the warp's half of V's columns, 4 of its tiles at a
    // time: no branch inside a group, so that its loads run ahead of its
    // products (P is 0 past the length, V's rows there are zeros; a tile
    // past the warp's columns, where nvt is not a multiple of 4, reads
    // other columns of the stage and is never stored)
    const float* vw = vs + wn * vh;
#pragma unroll
    for (int n0 = 0; n0 < NTV; n0 += 4) {
      if (n0 >= nvt) break;
      float pb[4][4], ps[4][4];  // the big parts' products; the small parts'
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) pb[n][c] = ps[n][c] = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const FragA a = frag_a_c(pj[j]);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const FragB f = load_b_kn<true>(vw, vpp, 8 * j, (n0 + n) * 8);
          mma_tf32(ps[n], a.small, f.big);
          mma_tf32(ps[n], a.big, f.small);
          mma_tf32(pb[n], a.big, f.big);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[n0 + n][c] += pb[n][c] + ps[n][c];
    }
  }

  // every element of the warp's V columns in the tile's rows below N: zeros
  // where the row is dead
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_first + g + 8 * r;
    if (row >= p.N) continue;
    float* o = static_cast<float*>(p.out) + (((long long)b * p.N + row) * p.H + h) * p.V;
#pragma unroll
    for (int n = 0; n < NTV; ++n)
      if (n < nvt)
        store2(o, wn * vh + 8 * n + 2 * t, p.V, acc[n][2 * r] * p.inv_norm, acc[n][2 * r + 1] * p.inv_norm);
  }
}

// -------------------------------------------------------- per-chunk bodies
// Route kWideChunks: the widths no cluster takes. The forward and the dq and
// dkv passes of the backward, one block per output chunk; S = alpha Q K^T
// and dP = dO V^T are summed over their chunks in registers before the bias,
// silu and the mask, and recomputed by each output chunk's block. Q (or K)
// and dO (or V) stay resident where they are one chunk wide; wider ones are
// loaded chunk by chunk per tile, and every load waits. The products are
// `mma.sync.m16n8k8` TF32 on float32 tiles: 3xTF32 in float32, one exact
// TF32 product on bfloat16 values (alpha q and dO / norm rounded on load, P
// and dS rounded before their products). The relative-bias backward is the
// two passes, as K7-det: `dq_chunks_kernel` with the bias writes dQ whole (no
// atomics); in `dkv_chunks_kernel` with the bias the blocks of chunk 0 also
// sum the table gradients, per step: `dpos_w` by diagonals of the step's dS,
// `dts_w` per warp by shuffles into the warp's copy of the reachable buckets.
// K7 adds both to the zeroed tables with atomics; K7-det writes them to the
// block's row of `partial`, which the relative-bias kernel sums in block
// order. The dense fused backward K2 is the same pair without the bias.
// One block of 4 warps per (64-row query tile, head, batch row, V chunk):
// each warp owns 16 query rows. Per 32-column key tile S is summed over D's
// chunks, then P = silu(alpha S + bias) * mask stays in registers as the A
// fragment of P V (`frag_a_c`) for the block's V chunk.
template <int BIAS, typename E>
__global__ void __launch_bounds__(kThreads) fwd_chunks_kernel(Params<E> p) {
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
        // the chunk's share in fresh accumulators, added in float32: summed in
        // place across D's chunks, O drifted past 2e-5 of its max at D 8192
        float sc[NT][4] = {};
#pragma unroll 4
        for (int ks = 0; ks < kC / 8; ++ks) {
          const FragA a = load_a(Qs, kP, warp * 16, ks * 8);
#pragma unroll
          for (int j = 0; j < NT; ++j) mma<kBf16>(sc[j], a, load_b_nk(Ks, kP, j * 8, ks * 8));
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[j][c] += sc[j][c];
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

// One block of 8 warps per (64-row query tile, head, batch row, dQ chunk):
// warp w owns query rows (w / 2) 16 .. + 16 and, of each 32-column key tile,
// columns (w % 2) 16 .. + 16 of S and dP, and of the block's dQ chunk
// columns (w % 2) 64 .. + 64. Per key tile S is summed over D's chunks and
// dP over V's, dS goes to shared memory, and dQ += dS K for the block's
// chunk of K. DQ: the type dq is written in (float for a float32 buffer that
// a second kernel rounds to bfloat16; else E).
template <bool RELBIAS, typename E, typename DQ>
__global__ void __launch_bounds__(kBwdThreads) dq_chunks_kernel(Params<E> p) {
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
          // each chunk's share in fresh accumulators, added in float32:
          // summed in place across the chunks, dV drifted past 2e-5 of its
          // max at D 3968
          float sc[NA][4] = {}, dc[NA][4] = {};
          if (c < n_dc) {
#pragma unroll 4
            for (int ks = 0; ks < kC / 8; ++ks) {
              const FragA a = load_a(Qs, kP, wr * 16, ks * 8);
#pragma unroll
              for (int j = 0; j < NA; ++j) mma<kBf16>(sc[j], a, load_b_nk(Ks, kP, wc * 16 + j * 8, ks * 8));
            }
          }
          if (c < n_vc) {
#pragma unroll 4
            for (int ks = 0; ks < kC / 8; ++ks) {
              const FragA a = load_a(dOs, kP, wr * 16, ks * 8);
#pragma unroll
              for (int j = 0; j < NA; ++j) mma<kBf16>(dc[j], a, load_b_nk(Vs, kP, wc * 16 + j * 8, ks * 8));
            }
          }
#pragma unroll
          for (int j = 0; j < NA; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] += sc[j][e], dp[j][e] += dc[j][e];
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

// One block of 8 warps per (64-column key tile, head, batch row, output
// chunk): chunks 0 .. n_vc - 1 are dV's, the rest dK's. Per 32-row query
// step warp w computes rows (w / 4) 16 .. + 16 by columns (w % 4) 16 .. + 16
// of S (summed over D's chunks) and dP (over V's) and writes P and dS to
// shared memory; then it sums dV += P^T dO or dK += dS^T Q for key rows
// (w / 2) 16 .. + 16 and columns (w % 2) 64 .. + 64 of the block's chunk.
// RELBIAS: the bias added to S, and the blocks of chunk 0 sum the table
// gradients; DET: those sums to the block's row of `partial` in a fixed order.
template <bool RELBIAS, bool DET, typename E>
__global__ void __launch_bounds__(kBwdThreads) dkv_chunks_kernel(Params<E> p) {
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
  float* diag = Ts + BQ * PS;   // RELBIAS: the step's diagonal sums [kDkvDiags + 1]
  float* dts_s = diag + kDkvDiags + 1;  // RELBIAS: `dts_w`'s sums, one copy per warp [8][kTsSlots]

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
          // each chunk's share in fresh accumulators, added in float32:
          // summed in place across the chunks, dV drifted past 2e-5 of its
          // max at D 3968
          float sc[NA][4] = {}, dc[NA][4] = {};
          if (c < n_dc) {
#pragma unroll 4
            for (int ks = 0; ks < kC / 8; ++ks) {
              const FragA a = load_a(Qs, kP, wr * 16, ks * 8);
#pragma unroll
              for (int j = 0; j < NA; ++j) mma<kBf16>(sc[j], a, load_b_nk(Ks, kP, wc * 16 + j * 8, ks * 8));
            }
          }
          if (c < n_vc) {
#pragma unroll 4
            for (int ks = 0; ks < kC / 8; ++ks) {
              const FragA a = load_a(dOs, kP, wr * 16, ks * 8);
#pragma unroll
              for (int j = 0; j < NA; ++j) mma<kBf16>(dc[j], a, load_b_nk(Vs, kP, wc * 16 + j * 8, ks * 8));
            }
          }
#pragma unroll
          for (int j = 0; j < NA; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] += sc[j][e], dp[j][e] += dc[j][e];
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
        if (d < kDkvDiags)
          for (int r = 0; r < BQ; ++r) {
            const int cc = r + d - (BQ - 1);
            if (cc >= 0 && cc < BK) sum += Ts[r * PS + cc];
          }
        if constexpr (DET) {
          // each run of diagonals that meet on one entry (one diagonal, or
          // those clipped where N > Nm) summed in order by one thread, into
          // the block's row
          if (d < kDkvDiags) diag[d] = sum;
          __syncthreads();
          if (d < kDkvDiags) {
            const int idx = hstu::pos_index(last, col0 + d, p.Nm);
            if (d == 0 || hstu::pos_index(last, col0 + d - 1, p.Nm) != idx) {
              float run = 0.f;
              for (int e = d; e < kDkvDiags && hstu::pos_index(last, col0 + e, p.Nm) == idx; ++e) run += diag[e];
              prow[idx] += run;
            }
          }
        } else {
          if (d < kDkvDiags && sum != 0.f) atomicAdd(p.dpos + hstu::pos_index(last, col0 + d, p.Nm), sum);
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

// Launches `kernel` in clusters of `cs` blocks of kBwdThreads threads and
// `smem` bytes of shared memory by cudaLaunchKernelEx. A cluster no part of
// the card can hold (cudaOccupancyMaxActiveClusters 0, asked once per card,
// cluster size and shared memory; `fits`: the bytes known to fit per card and
// cluster size, `fails` the least known not to) is refused with
// cudaErrorInvalidConfiguration, never run otherwise.
template <typename Kernel, typename... Args>
cudaError_t launch_clusters(Kernel kernel, long long blocks, int cs, int smem, int (&fits)[8][kMaxCluster + 1],
                            int (&fails)[8][kMaxCluster + 1], cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cs > kPortableCluster)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kBwdThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool known = device < 8 && smem <= fits[device][cs];
  if (!known) {
    if (device < 8 && fails[device][cs] != 0 && smem >= fails[device][cs]) return cudaErrorInvalidConfiguration;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (device < 8) {
      if (clusters > 0 && smem > fits[device][cs]) fits[device][cs] = smem;
      if (clusters == 0 && (fails[device][cs] == 0 || smem < fails[device][cs])) fails[device][cs] = smem;
    }
    if (clusters == 0) return cudaErrorInvalidConfiguration;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The forward on clusters: one cluster of cs blocks per (64-row query tile,
// head, batch row). bfloat16 reads rows in 16-byte pieces of 8 where the
// pointer, the strides and the width allow (float32: the caller's `vec_*`,
// pieces of 4).
template <int BIAS, int MV, bool SPLIT, typename E>
cudaError_t launch_fwd_m(const Params<E>& p, const FwdCluster& cl, cudaStream_t stream) {
  static int fits[8][kMaxCluster + 1] = {}, fails[8][kMaxCluster + 1] = {};
  const long long blocks = (long long)((p.N + kR - 1) / kR) * p.H * p.B * cl.cs;
  return launch_clusters(fwd_kernel<BIAS, MV, SPLIT, E>, blocks, cl.cs, fwd_smem_bytes((int)sizeof(E), cl), fits,
                         fails, stream, p, cl);
}

__host__ inline int vec8(const void* ptr, long long sb, long long sn, long long sh, int w) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 8 == 0 && sn % 8 == 0 && sh % 8 == 0 && w % 8 == 0;
}

template <int BIAS, typename E>
cudaError_t launch_fwd(Params<E> p, cudaStream_t stream) {
  const FwdCluster cl = fwd_cluster_of(p.D, p.V);
  if (cl.cs == 0) return cudaErrorInvalidValue;
  if constexpr (!std::is_same<E, float>::value) {
    p.vec_q = vec8(p.q, p.q_sb, p.q_sn, p.q_sh, p.D);
    p.vec_k = vec8(p.k, p.k_sb, p.k_sn, p.k_sh, p.D);
    p.vec_v = vec8(p.v, p.v_sb, p.v_sn, p.v_sh, p.V);
  }
  if (cl.mv == 1) {
    if (cl.split) return launch_fwd_m<BIAS, 1, true, E>(p, cl, stream);
    return launch_fwd_m<BIAS, 1, false, E>(p, cl, stream);
  }
  // two V tiles a block: V past 16 chunks, so 16 blocks, split
  if (!cl.split) return cudaErrorInvalidValue;
  return launch_fwd_m<BIAS, 2, true, E>(p, cl, stream);
}

// The per-chunk forward: a block per (64-row query tile, head, batch row, V
// chunk)
template <int BIAS, typename E>
cudaError_t launch_fwd_chunks(const Params<E>& p, cudaStream_t stream) {
  constexpr int smem = fwd_chunks_smem_bytes();
  auto kernel = fwd_chunks_kernel<BIAS, E>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((p.N + kFwdRows - 1) / kFwdRows) * p.H * p.B * chunks(p.V);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The tile forward: a block per (64-row query tile, head, batch row); float32
// K1 and K1-bias where `tile_takes` the widths
template <int BIAS>
cudaError_t launch_tile(const Params<float>& p, cudaStream_t stream) {
  if constexpr (BIAS == kRelBias) {
    return cudaErrorInvalidValue;
  } else {
    const int smem = tile_smem_bytes(p.D, p.V);
    if (!tile_takes(p.D, p.V) || smem > kMaxShared) return cudaErrorInvalidValue;
    auto kernel = tile_width(p.D) > 128 ? tile_fwd_kernel<BIAS, 0, 16>
                  : tile_width(p.V) > 256 ? tile_fwd_kernel<BIAS, 8, 24> : tile_fwd_kernel<BIAS, 8, 16>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const long long blocks = (long long)((p.N + kTileRows - 1) / kTileRows) * p.H * p.B;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    kernel<<<(unsigned)blocks, kBwdThreads, smem, stream>>>(p);
    return cudaGetLastError();
  }
}

// The rows of K7-det's `partial` that the dkv pass with DET writes: one per
// block, (tile, batch row, head, rank) in that order
inline long long bwd_table_rows(int B, int N, int H, int D, int V) {
  return (long long)((N + kR - 1) / kR) * H * B * cluster_of(D, V).cs;
}

// A backward pass: one cluster of cs blocks per (64-row tile, head, batch
// row).
template <int PASS, bool RELBIAS, bool DET, bool FUSED, int M, bool SPLIT, typename E>
cudaError_t launch_bwd_m(const Params<E>& p, const Cluster& cl, cudaStream_t stream) {
  static int fits[8][kMaxCluster + 1] = {}, fails[8][kMaxCluster + 1] = {};
  const long long blocks = (long long)((p.N + kR - 1) / kR) * p.H * p.B * cl.cs;
  return launch_clusters(bwd_kernel<PASS, RELBIAS, DET, FUSED, M, SPLIT, E>, blocks, cl.cs,
                         bwd_smem_bytes((int)sizeof(E), M, RELBIAS && PASS == kDkvPass), fits, fails, stream, p, cl);
}

template <int PASS, bool RELBIAS, bool DET, bool FUSED, typename E>
cudaError_t launch_bwd(const Params<E>& p, cudaStream_t stream) {
  const Cluster cl = cluster_of(p.D, p.V);
  if (cl.cs == 0) return cudaErrorInvalidValue;
  if (cl.m == 1) {
    if (cl.split) return launch_bwd_m<PASS, RELBIAS, DET, FUSED, 1, true, E>(p, cl, stream);
    return launch_bwd_m<PASS, RELBIAS, DET, FUSED, 1, false, E>(p, cl, stream);
  }
  // two chunks a block: more than 8 chunks, so at least 5 blocks, split
  if (!cl.split) return cudaErrorInvalidValue;
  return launch_bwd_m<PASS, RELBIAS, DET, FUSED, kMaxOwn, true, E>(p, cl, stream);
}

// The per-chunk dq pass: a block per (64-row query tile, head, batch row, dQ
// chunk), dQ written whole as DQ
template <bool RELBIAS, typename E, typename DQ>
cudaError_t launch_dq_chunks(const Params<E>& p, cudaStream_t stream) {
  constexpr int smem = dq_chunks_smem_bytes();
  auto kernel = dq_chunks_kernel<RELBIAS, E, DQ>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((p.N + kDqRows - 1) / kDqRows) * p.H * p.B * chunks(p.D);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kBwdThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The rows of K7-det's `partial` that the per-chunk dkv pass with DET
// writes: one per (key tile, head, batch row)
inline long long dkv_chunks_table_rows(int B, int N, int H) {
  return (long long)((N + kDkvCols - 1) / kDkvCols) * H * B;
}

// The per-chunk dkv pass: a block per (64-column key tile, head, batch row,
// dK or dV chunk)
template <bool RELBIAS, bool DET, typename E>
cudaError_t launch_dkv_chunks(const Params<E>& p, cudaStream_t stream) {
  constexpr int smem = dkv_chunks_smem_bytes(RELBIAS);
  auto kernel = dkv_chunks_kernel<RELBIAS, DET, E>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = dkv_chunks_table_rows(p.B, p.N, p.H) * (chunks(p.D) + chunks(p.V));
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kBwdThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The bfloat16 backward's pre-scaling pass (bf16_mma.cuh) on the wide
// parameters: q and dO then point at bfloat16(alpha q) and bfloat16(dO /
// norm) in the wrapper's buffers. float32: nothing. (The per-chunk bodies
// round alpha q and dO / norm as they load them and take no pass.)
template <typename E>
cudaError_t prescale(Params<E>& p, cudaStream_t stream) {
  if constexpr (std::is_same<E, float>::value) {
    return cudaSuccess;
  } else {
    return hstu_bf16::prescale(p, stream);
  }
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
