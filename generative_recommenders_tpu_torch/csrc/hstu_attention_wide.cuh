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
// Route kWideChunks, for the widths no cluster takes, any width: the
// per-pair bodies, S (and dP) formed once per 64 x 64 tile pair and kept, as
// P (and dS), in a float32 scratch that the wrapper allocates, then a block
// per output tile and chunk forms O, or dQ, dK and dV, over them; copies in a
// ring of `cp.async` stages, 3xTF32 in float32, m16n8k16 on bfloat16:
// * the forward past 16 blocks of 3 tiles of 128 columns (`sdp_kernel` in
//   its S-only mode, then `grad_kernel`'s O = P V), Q read once per tile
//   pair (`ops/cuda/variants.py --wide-chunks-fwd` times it, run as a file
//   on the card from two checkouts in turns; `--wide-chunks-fwd-variants`
//   its knock-outs);
// * the backward past 16 blocks of two chunks (`sdp_kernel`, `grad_kernel`,
//   `tables_kernel`; `--wide-chunks-bwd`, `--wide-chunks-bwd-variants`).
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
constexpr int kBwdThreads = 256;  // every body: 8 warps
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
  void* dq;   // the dq pass: E; the dkv pass with FUSED: a zeroed float32 buffer; `grad_kernel`: its DQT;
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
  // the per-pair bodies (route kWideChunks): the wrapper's float32
  // scratch, the slabs of a group and the S (/ dP) pass's splits, as planned
  float* scratch = nullptr;
  int group_slabs = 0, splits = 0;
};

__host__ __device__ constexpr int chunks(int w) { return (w + kC - 1) / kC; }

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
// blocks. cs = 0: wider than 16 blocks of two chunks (the per-pair bodies
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
// more than kFwdMaxTiles tiles (the per-pair forward takes those widths,
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

// ---------------------------------------------------------- per-pair bodies
// Route kWideChunks's forward: K1, K1-bias and K6 past 16 blocks of 3 tiles
// of 128 columns (the TPU kernels `_fwd_kernel_rkv` / `_fwd_kernel` of
// hstu_attention.py and `_fwd_kernel_relbias` of hstu_attention_relbias.py,
// whose 3-D grids take any width). It is the backward's design below with
// S alone: `sdp_kernel` in its FWD mode forms S = Q K^T once per tile pair
// over D's 64-column steps (Q read once per pair, the steps split across
// blocks where the pairs are few, the splits summed in order), then per
// element alpha, the bias (none, dense, or relative), silu and the mask; P
// goes to the scratch (rounded to bfloat16 values on bfloat16) with the
// pair's live flag. `grad_kernel` in its FWD mode, a block per (64-row query
// tile, 128-column V chunk, slab), forms O = P V over the tile's live pairs
// ascending (dQ = dS K's path with P for dS and V for K), scales it by 1 /
// norm and writes the tile whole: zeros on dead rows, no atomics, the same
// bits on every run. bfloat16: alpha q is rounded to bfloat16 as its
// fragments are read (the TPU kernel's rounding point), S and O's sums
// float32. Products per live pair and head: S 2 D, O 2 V per element.
// Route kWideChunks's backward: K2, K3, K4, K7 and K7-det past 16 blocks of
// two chunks (the TPU kernels `_bwd_fused_kernel_rkv`, `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` of hstu_attention.py and `_bwd_kernel_relbias` of
// hstu_attention_relbias.py, whose 3-D grids take any width). At these
// widths S and dP (B H N^2 scalars) are small beside Q, K, V and dO (B N H
// (2 D + 2 V)): P and dS of the widest-heads ranker's layer take 26 MB,
// against its 281 MB of inputs, and fit the card's 50 MB L2. So S and dP are
// formed once per (64-row query tile, 64-column key tile) pair and kept, as
// P and dS, in a float32 scratch that the wrapper allocates; then the three
// gradient products run over them, each block writing one output tile whole
// (the same bits on every run, no atomics). The (batch row, head) slabs run
// in groups whose scratch fits the plan's cap, one group after the other:
// * `sdp_kernel`, a block per (pair, split, slab): S summed over D's columns
//   and dP over V's, 64 columns a step from a ring of kSdpStages `cp.async`
//   stages (the next steps' copies in flight while a step multiplies), each
//   step's share in fresh accumulators added in float32 (summed in place
//   across the chunks, dV drifted past 2e-5 of its max at D 3968); then per
//   element the bias (K7, K7-det), silu and the mask, P and dS to the
//   scratch and the pair's live flag. Where the pairs are too few to fill
//   the card (fewer than kSplitTarget blocks), the steps are split across
//   `splits` blocks, whose partial S and dP `sdp_sums_kernel` adds in split
//   order (the same bits on every run) before the per-element work;
// * `grad_kernel`, a block per (64-row output tile, 128-column chunk, slab):
//   dQ = dS K over the query tile's key tiles ascending, dK = dS^T Q and dV =
//   P^T dO over the key tile's query tiles ascending; the A tile (P or dS)
//   and the chunk's B tile in two `cp.async` stages;
// * `tables_kernel` (K7, K7-det), a block per (64-column key tile, slab):
//   `dpos_w` by diagonals of each pair's float32 dS and `dts_w` per warp by
//   shuffles into the warp's copy of the reachable buckets, walking the key
//   tile's query tiles ascending; K7 adds both to the zeroed tables with
//   atomics, K7-det writes them to the block's row of `partial`, which the
//   relative-bias kernel sums in row order.
// Every pass walks the same pairs: the tiles below the length, causal ones
// skipping a query tile of no contextual row that lies wholly above its key
// tile (`walked`), and of those the pairs with a live element (the flag).
// float32 multiplies in 3xTF32; bfloat16 keeps bfloat16 tiles of Q, K, V and
// dO (alpha q and dO / norm from the pre-scaling pass) and multiplies with
// m16n8k16 (`ldmatrix` fragments; P and dS rounded to bfloat16 as their
// fragments are formed), S, dP, the scratch and the outputs' sums float32.
// Products per live pair and head: S 2 D and dP 2 V per element once; dQ 2
// D, dK 2 D, dV 2 V: K2 and K7 2 (4 D + 2 V), K3 2 (2 D + V), K4 2 (3 D + 2 V).
constexpr int kPT = 64;                  // rows and columns of a tile pair
constexpr int kPK = 64;                  // columns of D or V an S / dP step takes
constexpr int kPA = kPK + 8;             // pitch of its tiles and of the A tile (P or dS)
constexpr int kPairFloats = kPT * kPT;   // a pair's P (or dS) in the scratch, [64][64]
constexpr int kFwdMats = 1, kBwdMats = 2;  // the tiles a pair keeps: P (the forward), or P and dS
constexpr int kSdpStages = 3;            // the S (/ dP) pass's ring
constexpr int kGradStages = 2;           // the gradient pass's
constexpr int kPairDiags = 2 * kPT - 1;  // diagonals of a pair
// the S / dP pass's blocks aimed at where the pairs are few: two an SM of
// the H100's 132 (the plan's splits mirror it)
constexpr int kSplitTarget = 264;

// the S pass's steps (FWD), or the S / dP pass's
__host__ __device__ constexpr int sdp_steps(int D, int V, bool fwd) {
  return (D + kPK - 1) / kPK + (fwd ? 0 : (V + kPK - 1) / kPK);
}
// shared memory: the ring of (R, X) tiles of the element type; the A tile
// (float32) and the B tile (a 128-column chunk of the element type) per
// stage; the pair's dS [64][65], its diagonal sums, eight warps' copies of
// `dts_w`'s sums
constexpr int sdp_smem_bytes(int elem) { return kSdpStages * 2 * kPT * kPA * elem; }
constexpr int grad_smem_bytes(int elem) { return kGradStages * (4 * kPT * kPA + elem * kPT * kP); }
constexpr int tables_smem_bytes() { return 4 * (kPT * (kPT + 1) + 2 * kPT + kBwdThreads / 32 * kTsSlots); }
static_assert(2 * (sdp_smem_bytes(4) + 1024) <= 233472 && 2 * (grad_smem_bytes(4) + 1024) <= 233472,
              "two blocks an SM");

// A launch's view of the scratch, per group: `mats` float32 tiles per pair,
// P [tiles][64][64] (and the backward's dS [tiles][64][64]), the pairs' live
// flags [tiles] (int, padded to 4), then with splits the parts
// [splits][tiles][mats][64][64] (S, and dP): mats tiles 4096 + ceil(tiles /
// 4) 4 (+ splits tiles mats 4096) floats, the wrapper's `scratch_shape`;
// tiles = group_slabs qt^2, pair (qt_, kt) of the group's slab sl at (sl qt +
// qt_) qt + kt.
struct Pairs {
  float* scratch;
  long long tiles;
  int qt;            // 64-row tiles of N
  int slab0;         // the group's first slab (b H + h)
  int splits, per;   // the S (/ dP) steps split in `splits` runs of `per`
  int mats;          // kFwdMats or kBwdMats
};

__device__ __forceinline__ int* pair_flags(const Pairs& w) {
  return reinterpret_cast<int*>(w.scratch + w.mats * w.tiles * kPairFloats);
}
// split sp's partial S (and dP) of a pair
__device__ __forceinline__ float* pair_part(const Pairs& w, int sp, long long tile) {
  return w.scratch + w.mats * w.tiles * kPairFloats + (w.tiles + 3) / 4 * 4 +
         ((long long)sp * w.tiles + tile) * w.mats * kPairFloats;
}

// Whether every pass visits the pair: both tiles start below the length, and
// no causal pair whose query tile holds no contextual row lies wholly above
// the diagonal (every element dead)
template <typename E>
__device__ __forceinline__ bool walked(const Params<E>& p, int qt, int kt, int length) {
  return qt * kPT < length && kt * kPT < length && !(p.causal && qt * kPT >= p.contextual_seq_len && qt < kt);
}

// The S / dP pass's 8 warps: warp w owns rows (w / 4) 32 .. + 32 and
// columns (w % 4) 16 .. + 16 of the pair; its element e = 4 (2 m + j) + c is
// row (w / 4) 32 + 16 m + g + 8 (c / 2), column (w % 4) 16 + 8 j + 2 t + c % 2.
template <typename E>
__device__ __forceinline__ uint32_t pair_ok_bits(const Params<E>& p, int r0, int c0, int length, int nt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  uint32_t ok_bits = 0;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int row = r0 + (warp >> 2) * 32 + 16 * (e >> 3) + g + 8 * ((e & 3) >> 1);
    const int col = c0 + (warp & 3) * 16 + 8 * ((e >> 2) & 1) + 2 * t + (e & 1);
    ok_bits |= (live(p, row, col, length, nt) ? 1u : 0u) << e;
  }
  return ok_bits;
}

// x of a warp's part into (STORE) or added from (else) a [64][64] tile
template <bool STORE>
__device__ __forceinline__ void pair_io(float* tile, float (&x)[2][2][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float2* at = reinterpret_cast<float2*>(tile + ((warp >> 2) * 32 + 16 * m + g + 8 * i) * kPT + (warp & 3) * 16 +
                                               8 * j + 2 * t);
        if constexpr (STORE) {
          *at = make_float2(x[m][j][2 * i], x[m][j][2 * i + 1]);
        } else {
          const float2 v = *at;
          x[m][j][2 * i] += v.x;
          x[m][j][2 * i + 1] += v.y;
        }
      }
}

// The per-element work of a live pair: P = silu(x) and (but FWD) dS = dP
// silu'(x) with x = alpha S (+ the bias: relative, or dense), zeros where the
// mask is 0; P (FWD on bfloat16: rounded to bfloat16 values, as P V takes
// it), dS and the flag to the scratch. bfloat16: alpha (and 1 / norm) are in
// alpha q (and dO / norm) already.
template <int BIAS, bool FWD, typename E>
__device__ __forceinline__ void pair_finish(const Params<E>& p, const Pairs& w, long long tile,
                                            float (&s)[2][2][4], float (&dp)[2][2][4], uint32_t ok_bits, int b,
                                            int r0, int c0) {
  constexpr bool kBf16 = !std::is_same<E, float>::value;
  const float s_alpha = kBf16 ? 1.f : p.alpha, dp_scale = kBf16 ? 1.f : p.inv_norm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const float* tsb = BIAS == kRelBias ? p.ts + (long long)b * p.N : nullptr;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int m = e >> 3, j = (e >> 2) & 1, c = e & 3;
    float pv = 0.f, ds = 0.f;
    if ((ok_bits >> e) & 1u) {
      const int row = r0 + (warp >> 2) * 32 + 16 * m + g + 8 * (c >> 1);
      const int col = c0 + (warp & 3) * 16 + 8 * j + 2 * t + (c & 1);
      float x = s[m][j][c] * s_alpha;
      if constexpr (BIAS == kRelBias) {
        int bucket;
        x = fmaf(s[m][j][c], s_alpha, rel_bias(p, row, col, ts_row(tsb, row, p.N), ts_col(tsb, col, p.N), bucket));
      } else if constexpr (BIAS == kDenseBias) {
        x = fmaf(s[m][j][c], s_alpha, dense_bias(p, b, row, col));
      }
      const float sig = __fdividef(1.f, 1.f + __expf(-x));
      pv = x * sig;
      if constexpr (FWD && kBf16) pv = round_bf16(pv);
      if constexpr (!FWD) ds = dp[m][j][c] * dp_scale * sig * (1.f + x * (1.f - sig));
    }
    s[m][j][c] = pv;
    dp[m][j][c] = ds;
  }
  pair_io<true>(w.scratch + tile * kPairFloats, s);
  if constexpr (!FWD) pair_io<true>(w.scratch + (w.tiles + tile) * kPairFloats, dp);
  if (threadIdx.x == 0) pair_flags(w)[tile] = 1;
}

// acc += R X^T over one 64-column step for the warp's 32 x 16 part
template <bool SCALE = false>
__device__ __forceinline__ void sdp_product(float (&acc)[2][2][4], const float* R, const float* X, int wr, int wc,
                                            float = 1.f) {
#pragma unroll
  for (int ks = 0; ks < kPK / 8; ++ks) {
    const FragA a0 = load_a(R, kPA, wr * 32, ks * 8), a1 = load_a(R, kPA, wr * 32 + 16, ks * 8);
    const FragB b0 = load_b_nk(X, kPA, wc * 16, ks * 8), b1 = load_b_nk(X, kPA, wc * 16 + 8, ks * 8);
    mma3(acc[0][0], a0, b0);
    mma3(acc[0][1], a0, b1);
    mma3(acc[1][0], a1, b0);
    mma3(acc[1][1], a1, b1);
  }
}
// bfloat16: SCALE (the forward's alpha q where alpha != 1) rounds each
// element of R's fragments times `scale` to bfloat16 as it is read, the
// pre-scaling pass's value (a product of two bfloat16 values is exact in
// float32, so one rounding)
__device__ __forceinline__ uint32_t scaled_bf16x2(uint32_t x, float scale) {
  return hstu_bf16::pack(__uint_as_float(x << 16) * scale, __uint_as_float(x & 0xffff0000u) * scale);
}
template <bool SCALE = false>
__device__ __forceinline__ void sdp_product(float (&acc)[2][2][4], const __nv_bfloat16* R, const __nv_bfloat16* X,
                                            int wr, int wc, float scale = 1.f) {
#pragma unroll
  for (int ks = 0; ks < kPK / 16; ++ks) {
    uint32_t a0[4], a1[4], b[4];
    hstu_bf16::ldsm(a0, hstu_bf16::a_at(R, kPA, wr * 32, ks * 16));
    hstu_bf16::ldsm(a1, hstu_bf16::a_at(R, kPA, wr * 32 + 16, ks * 16));
    hstu_bf16::ldsm(b, hstu_bf16::b_nk_at(X, kPA, wc * 16, ks * 16));
    if constexpr (SCALE) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a0[i] = scaled_bf16x2(a0[i], scale);
        a1[i] = scaled_bf16x2(a1[i], scale);
      }
    }
    hstu_bf16::mma(acc[0][0], a0, b[0], b[1]);
    hstu_bf16::mma(acc[0][1], a0, b[2], b[3]);
    hstu_bf16::mma(acc[1][0], a1, b[0], b[1]);
    hstu_bf16::mma(acc[1][1], a1, b[2], b[3]);
  }
}

// Columns [c, c + 64) of one head's rows [r0, r0 + 64) of width w into a
// [64][kPA] tile of the element type: zeros at rows >= lim and columns >= w
__device__ __forceinline__ void load_step(float* dst, const float* src, long long sn, int r0, int lim, int w, int c,
                                          bool vec) {
  load_tile<kPK, kPA, kPT, kBwdThreads>(dst, src + c, sn, r0, lim, w - c, vec);
}
__device__ __forceinline__ void load_step(__nv_bfloat16* dst, const __nv_bfloat16* src, long long sn, int r0, int lim,
                                          int w, int c, bool vec) {
  hstu_bf16::load_rows<kPK, kPA, kPT, kBwdThreads>(dst, src + c, sn, r0, lim, w - c, vec);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The S / dP pass, or with FWD the forward's S pass: a block per (pair,
// split, slab of the group), pairs ordered (slab, split, query tile, key
// tile). PARTS: the block sums steps [split per, + per) and stores its
// partial S (and dP); else every step, then the per-element work. BIAS:
// kNoBias, kRelBias, or (FWD) kDenseBias.
template <int BIAS, bool FWD, bool PARTS, typename E>
__global__ void __launch_bounds__(kBwdThreads, 2) sdp_kernel(Params<E> p, Pairs w) {
  constexpr bool kBf16 = !std::is_same<E, float>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* ring = reinterpret_cast<E*>(smem_raw);  // [kSdpStages][2][64][kPA]: R (Q or dO), X (K or V)
  const int warp = threadIdx.x >> 5, wr = warp >> 2, wc = warp & 3;
  long long blk = blockIdx.x;
  const int kt = (int)(blk % w.qt);
  blk /= w.qt;
  const int qt = (int)(blk % w.qt);
  blk /= w.qt;
  const int sp = (int)(blk % w.splits);
  const int sl = (int)(blk / w.splits);
  const int slab = w.slab0 + sl, b = slab / p.H, h = slab % p.H;
  const int length = min(p.lengths[b], p.N);
  if (!walked(p, qt, kt, length)) return;
  const int nt = p.num_targets ? p.num_targets[b] : 0;
  const int r0 = qt * kPT, c0 = kt * kPT;
  const long long tile = ((long long)sl * w.qt + qt) * w.qt + kt;
  const uint32_t ok_bits = pair_ok_bits(p, r0, c0, length, nt);
  if (!__syncthreads_or(ok_bits != 0)) {  // a dead pair: its flag 0 (the sums' kernel's with PARTS)
    if (!PARTS && threadIdx.x == 0) pair_flags(w)[tile] = 0;
    return;
  }
  const bool dead = __all_sync(kFull, ok_bits == 0);  // the warp's part
  // the forward on bfloat16: alpha q rounded to bfloat16 as Q's fragments are read
  const float q_scale = FWD && kBf16 ? round_bf16(p.alpha) : 1.f;
  const E* qb = p.q + b * p.q_sb + h * p.q_sh;
  const E* kb = p.k + b * p.k_sb + h * p.k_sh;
  const E* vb = p.v + b * p.v_sb + h * p.v_sh;
  const E* ob = p.dout + b * p.do_sb + h * p.do_sh;
  const int n_ds = (p.D + kPK - 1) / kPK, n_steps = sdp_steps(p.D, p.V, FWD);
  const int u0 = PARTS ? min(sp * w.per, n_steps) : 0, u1 = PARTS ? min(u0 + w.per, n_steps) : n_steps;
  auto issue = [&](int u, int stage) {
    E* R = ring + stage * 2 * kPT * kPA;
    E* X = R + kPT * kPA;
    if (FWD || u < n_ds) {
      load_step(R, qb, p.q_sn, r0, length, p.D, u * kPK, p.vec_q != 0);
      load_step(X, kb, p.k_sn, c0, length, p.D, u * kPK, p.vec_k != 0);
    } else {
      load_step(R, ob, p.do_sn, r0, length, p.V, (u - n_ds) * kPK, p.vec_do != 0);
      load_step(X, vb, p.v_sn, c0, length, p.V, (u - n_ds) * kPK, p.vec_v != 0);
    }
  };
  float s[2][2][4] = {}, dp[2][2][4] = {};
#pragma unroll
  for (int i = 0; i < kSdpStages - 1; ++i) {
    if (u0 + i < u1) issue(u0 + i, i);
    cp_async_commit();
  }
  for (int u = u0; u < u1; ++u) {
    cp_async_wait<kSdpStages - 2>();
    __syncthreads();  // step u's tiles are in place; every warp is done with step u - 1's stage
    if (u + kSdpStages - 1 < u1) issue(u + kSdpStages - 1, (u + kSdpStages - 1 - u0) % kSdpStages);
    cp_async_commit();
    if (!dead) {
      const E* R = ring + ((u - u0) % kSdpStages) * 2 * kPT * kPA;
      float acc[2][2][4] = {};
      if (FWD && kBf16 && q_scale != 1.f)
        sdp_product<true>(acc, R, R + kPT * kPA, wr, wc, q_scale);
      else
        sdp_product(acc, R, R + kPT * kPA, wr, wc);
      if (FWD || u < n_ds) {
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[m][j][c] += acc[m][j][c];
      } else {
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) dp[m][j][c] += acc[m][j][c];
      }
    }
  }
  if constexpr (PARTS) {
    float* part = pair_part(w, sp, tile);
    pair_io<true>(part, s);
    if constexpr (!FWD) pair_io<true>(part + kPairFloats, dp);
  } else {
    pair_finish<BIAS, FWD>(p, w, tile, s, dp, ok_bits, b, r0, c0);
  }
}

// The split S (/ dP) pass's sums: a block per (pair, slab of the group) adds
// the splits' parts in split order, then the per-element work.
template <int BIAS, bool FWD, typename E>
__global__ void __launch_bounds__(kBwdThreads) sdp_sums_kernel(Params<E> p, Pairs w) {
  long long blk = blockIdx.x;
  const int kt = (int)(blk % w.qt);
  blk /= w.qt;
  const int qt = (int)(blk % w.qt);
  const int sl = (int)(blk / w.qt);
  const int slab = w.slab0 + sl, b = slab / p.H;
  const int length = min(p.lengths[b], p.N);
  if (!walked(p, qt, kt, length)) return;
  const int nt = p.num_targets ? p.num_targets[b] : 0;
  const int r0 = qt * kPT, c0 = kt * kPT;
  const long long tile = ((long long)sl * w.qt + qt) * w.qt + kt;
  const uint32_t ok_bits = pair_ok_bits(p, r0, c0, length, nt);
  if (!__syncthreads_or(ok_bits != 0)) {
    if (threadIdx.x == 0) pair_flags(w)[tile] = 0;
    return;
  }
  float s[2][2][4] = {}, dp[2][2][4] = {};
  for (int sp = 0; sp < w.splits; ++sp) {
    float* part = pair_part(w, sp, tile);
    pair_io<false>(part, s);
    if constexpr (!FWD) pair_io<false>(part + kPairFloats, dp);
  }
  pair_finish<BIAS, FWD>(p, w, tile, s, dp, ok_bits, b, r0, c0);
}

// The bfloat16 A fragment (m16n8k16) of a float32 [m][k] tile at (m0, k0),
// and of the transpose of a float32 [k][m] tile (A[m][k] = X[k][m]): each
// pair rounded to bfloat16 as it is packed
__device__ __forceinline__ void frag_a_bf16(uint32_t (&a)[4], const float* X, int pitch, int m0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* x = X + (m0 + g) * pitch + k0 + 2 * t;
  const float2 v0 = *reinterpret_cast<const float2*>(x), v1 = *reinterpret_cast<const float2*>(x + 8 * pitch);
  const float2 v2 = *reinterpret_cast<const float2*>(x + 8), v3 = *reinterpret_cast<const float2*>(x + 8 * pitch + 8);
  a[0] = hstu_bf16::pack(v0.x, v0.y);
  a[1] = hstu_bf16::pack(v1.x, v1.y);
  a[2] = hstu_bf16::pack(v2.x, v2.y);
  a[3] = hstu_bf16::pack(v3.x, v3.y);
}
__device__ __forceinline__ void frag_a_t_bf16(uint32_t (&a)[4], const float* X, int pitch, int m0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* x = X + (k0 + 2 * t) * pitch + m0 + g;
  a[0] = hstu_bf16::pack(x[0], x[pitch]);
  a[1] = hstu_bf16::pack(x[8], x[pitch + 8]);
  a[2] = hstu_bf16::pack(x[8 * pitch], x[9 * pitch]);
  a[3] = hstu_bf16::pack(x[8 * pitch + 8], x[9 * pitch + 8]);
}

// acc += A B over one 64-deep step for the warp's 32 x 32 part (rows wr 32
// .., columns wc 32 ..) of a 64 x 128 output tile: A the [64][kPA] copy of a
// scratch tile (TRANS: its transpose, dS^T or P^T), B the chunk's [64][kP]
// tile. float32: the step's share summed in fresh accumulators, then added
// in float32 (summed across the walk in place, dK at N 4096 drifted past
// 2e-5 of its max); bfloat16 (its outputs rounded to 8 bits) in place.
template <bool TRANS>
__device__ __forceinline__ void grad_product(float (&acc)[2][4][4], const float* A, const float* Bt, int wr, int wc) {
  float part[2][4][4] = {};
#pragma unroll 2
  for (int ks = 0; ks < kPT / 8; ++ks) {
    FragA a[2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
      a[m] = TRANS ? load_a_t(A, kPA, wr * 32 + 16 * m, ks * 8) : load_a(A, kPA, wr * 32 + 16 * m, ks * 8);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const FragB bf = TRANS ? load_b_kn<false>(Bt, kP, ks * 8, wc * 32 + 8 * n)
                             : load_b_kn<true>(Bt, kP, ks * 8, wc * 32 + 8 * n);
      mma3(part[0][n], a[0], bf);
      mma3(part[1][n], a[1], bf);
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][n][c] += part[m][n][c];
}
template <bool TRANS>
__device__ __forceinline__ void grad_product(float (&acc)[2][4][4], const float* A, const __nv_bfloat16* Bt, int wr,
                                             int wc) {
#pragma unroll
  for (int ks = 0; ks < kPT / 16; ++ks) {
    uint32_t a[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (TRANS)
        frag_a_t_bf16(a[m], A, kPA, wr * 32 + 16 * m, ks * 16);
      else
        frag_a_bf16(a[m], A, kPA, wr * 32 + 16 * m, ks * 16);
    }
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t bf[4];
      hstu_bf16::ldsm_t(bf, hstu_bf16::b_kn_at(Bt, kP, ks * 16, wc * 32 + 16 * np));
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        hstu_bf16::mma(acc[m][2 * np], a[m], bf[0], bf[1]);
        hstu_bf16::mma(acc[m][2 * np + 1], a[m], bf[2], bf[3]);
      }
    }
  }
}

// The gradient pass: a block per (64-row output tile, 128-column chunk, slab
// of the group); per slab DQ's blocks (query tile, D chunk), then DKV's: dK's
// (key tile, D chunk) and dV's (key tile, V chunk), the chunk fastest. The
// block walks its tile's live pairs ascending, A (dS or P) and B (K's, Q's
// or dO's chunk of the other tile's rows) in kGradStages stages, and writes
// its tile whole: zeros past the length. DQT: dq's type (float for K2's and
// K7's float32 buffer, else E). FWD (with DQ): the forward's P V pass, dQ's
// path with P for dS, V's chunks for K's and 1 / norm for alpha, into out
// (a block per query tile and V chunk).
template <bool DQ, bool DKV, bool FWD, typename E, typename DQT>
__global__ void __launch_bounds__(kBwdThreads, 2) grad_kernel(Params<E> p, Pairs w) {
  constexpr bool kBf16 = !std::is_same<E, float>::value;
  constexpr int kStage = 4 * kPT * kPA + (int)sizeof(E) * kPT * kP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int wr = warp >> 2, wc = warp & 3;
  const int n_dc = chunks(p.D), n_vc = chunks(p.V);
  const int q_blocks = DQ ? w.qt * (FWD ? n_vc : n_dc) : 0;
  const int per_slab = q_blocks + (DKV ? w.qt * (n_dc + n_vc) : 0);
  const int sl = (int)(blockIdx.x / (unsigned)per_slab);
  int r = (int)(blockIdx.x % (unsigned)per_slab);
  int kind = 0;  // 0 dQ, 1 dK, 2 dV
  if (r >= q_blocks) {
    r -= q_blocks;
    kind = r < w.qt * n_dc ? 1 : 2;
    if (kind == 2) r -= w.qt * n_dc;
  }
  const int nch = kind == 2 || FWD ? n_vc : n_dc;
  const int ot = r / nch, oc = r % nch;
  const int slab = w.slab0 + sl, b = slab / p.H, h = slab % p.H;
  const int length = min(p.lengths[b], p.N);
  const float* A_src = w.scratch + (kind == 2 || FWD ? 0 : w.tiles * kPairFloats);  // P or dS
  const int* flags = pair_flags(w);
  const E* B_src = FWD ? p.v + b * p.v_sb + h * p.v_sh
                   : kind == 0 ? p.k + b * p.k_sb + h * p.k_sh
                   : kind == 1 ? p.q + b * p.q_sb + h * p.q_sh : p.dout + b * p.do_sb + h * p.do_sh;
  const long long b_sn = FWD ? p.v_sn : kind == 0 ? p.k_sn : kind == 1 ? p.q_sn : p.do_sn;
  const bool b_vec = (FWD ? p.vec_v : kind == 0 ? p.vec_k : kind == 1 ? p.vec_q : p.vec_do) != 0;
  const int width = kind == 2 || FWD ? p.V : p.D;
  const long long tile0 = (long long)sl * w.qt * w.qt;
  // the walk's pair with other tile o: (ot, o) for dQ, (o, ot) for dK and dV
  auto pair_of = [&](int o) { return kind == 0 ? tile0 + (long long)ot * w.qt + o : tile0 + (long long)o * w.qt + ot; };
  auto next = [&](int o) {
    for (; o < w.qt; ++o)
      if ((kind == 0 ? walked(p, ot, o, length) : walked(p, o, ot, length)) && flags[pair_of(o)] != 0) break;
    return o;
  };
  auto issue = [&](int o, int stage) {
    float* As = reinterpret_cast<float*>(smem_raw + stage * kStage);
    E* Bs = reinterpret_cast<E*>(smem_raw + stage * kStage + 4 * kPT * kPA);
    const float* src = A_src + pair_of(o) * kPairFloats;
    for (int idx = threadIdx.x; idx < kPT * kPT / 4; idx += kBwdThreads) {
      const int rr = idx / (kPT / 4), cc = idx % (kPT / 4) * 4;
      cp_async16(As + rr * kPA + cc, src + rr * kPT + cc, true);
    }
    load_rows<kPT>(Bs, B_src, b_sn, o * kPT, length, width, oc, b_vec);
  };
  float acc[2][4][4] = {};
  int o = next(0), stage = 0;
  if (o < w.qt) issue(o, 0);
  cp_async_commit();
  while (o < w.qt) {
    const int on = next(o + 1);
    if (on < w.qt) issue(on, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this step's tiles are in place
    const float* As = reinterpret_cast<const float*>(smem_raw + stage * kStage);
    const E* Bs = reinterpret_cast<const E*>(smem_raw + stage * kStage + 4 * kPT * kPA);
    if (kind == 0)
      grad_product<false>(acc, As, Bs, wr, wc);
    else
      grad_product<true>(acc, As, Bs, wr, wc);
    __syncthreads();  // every warp is done with the stage the next issue fills
    o = on;
    stage ^= 1;
  }
  const float s_alpha = kBf16 ? 1.f : p.alpha, dp_scale = kBf16 ? 1.f : p.inv_norm;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = ot * kPT + wr * 32 + 16 * m + g + 8 * i;
      if (row >= p.N) continue;
      const long long at = (((long long)b * p.N + row) * p.H + h) * width;
      const float scale =
          kind == 0 ? (row < length ? (FWD ? p.inv_norm : p.alpha) : 0.f) : kind == 1 ? s_alpha : dp_scale;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = oc * kC + wc * 32 + 8 * n + 2 * t;
        const float x0 = scale * acc[m][n][2 * i], x1 = scale * acc[m][n][2 * i + 1];
        if (FWD)
          store2(static_cast<E*>(p.out) + at, col, width, x0, x1);
        else if (kind == 0)
          store2(static_cast<DQT*>(p.dq) + at, col, width, x0, x1);
        else
          store2((kind == 1 ? p.dk : p.dv) + at, col, width, x0, x1);
      }
    }
}

// The relative bias's table sums: a block per (64-column key tile, slab of
// the group) walks its key tile's live pairs, query tiles ascending, over
// the float32 dS in the scratch (warp w rows 8 w .. + 8 of a pair, lane l
// columns l and l + 32): `dpos_w` by the pair's 127 diagonals, `dts_w` per
// warp by shuffles into the warp's copy of the reachable buckets (no
// atomics); K7 adds both to the zeroed tables with atomics, K7-det writes
// them to the block's row of `partial` ((key tile, head, batch row) in that
// order), each entry in the walk's order.
template <bool DET, typename E>
__global__ void __launch_bounds__(kBwdThreads) tables_kernel(Params<E> p, Pairs w) {
  extern __shared__ __align__(16) float smem[];
  float* Ts = smem;                        // the pair's dS [64][65]
  float* diag = Ts + kPT * (kPT + 1);      // its diagonal sums [128]
  float* dts_s = diag + 2 * kPT;           // `dts_w`'s sums, one copy per warp [8][kTsSlots]
  constexpr int NW = kBwdThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kt = (int)(blockIdx.x % (unsigned)w.qt), sl = (int)(blockIdx.x / (unsigned)w.qt);
  const int slab = w.slab0 + sl, b = slab / p.H, h = slab % p.H;
  const int length = min(p.lengths[b], p.N);
  const int nt = p.num_targets ? p.num_targets[b] : 0;
  const int n_pos = 2 * p.Nm - 1, n_ts = p.NB + 1, n_slots = min(n_ts, kTsSlots);
  const int c0 = kt * kPT;
  float* prow = DET ? p.partial + ((long long)kt * p.H * p.B + (long long)h * p.B + b) * (n_pos + n_ts) : nullptr;
  if (c0 >= length) {  // a dead key tile's row of `partial` holds zeros
    if (DET)
      for (int idx = threadIdx.x; idx < n_pos + n_ts; idx += kBwdThreads) prow[idx] = 0.f;
    return;
  }
  for (int idx = threadIdx.x; idx < NW * kTsSlots; idx += kBwdThreads) dts_s[idx] = 0.f;
  if (DET)
    for (int idx = threadIdx.x; idx < n_pos; idx += kBwdThreads) prow[idx] = 0.f;
  const float* dS = w.scratch + w.tiles * kPairFloats;
  const int* flags = pair_flags(w);
  const long long tile0 = (long long)sl * w.qt * w.qt;
  const float* tsb = p.ts + (long long)b * p.N;
  const float tk[2] = {ts_col(tsb, c0 + lane, p.N), ts_col(tsb, c0 + 32 + lane, p.N)};
  float* my_dts = dts_s + warp * kTsSlots;
  for (int qt = 0; qt < w.qt; ++qt) {
    const long long tile = tile0 + (long long)qt * w.qt + kt;
    if (!walked(p, qt, kt, length) || flags[tile] == 0) continue;
    const int r0 = qt * kPT;
    __syncthreads();  // every warp is done with the last pair's dS and diagonal sums
    const float* src = dS + tile * kPairFloats;
#pragma unroll 4
    for (int e = 0; e < 16; ++e) {
      const int rl = warp * 8 + (e >> 1), cl = (e & 1) * 32 + lane;
      const float x = src[rl * kPT + cl];
      Ts[rl * (kPT + 1) + cl] = x;
      const bool ok = live(p, r0 + rl, c0 + cl, length, nt);
      const int key = min(hstu::ts_bucket(ts_row(tsb, r0 + rl, p.N), tk[e & 1], p.NB), n_slots - 1);
      unsigned rest = __ballot_sync(kFull, ok);
      while (rest != 0) {
        const int first = __ffs(rest) - 1;
        const int bucket = __shfl_sync(kFull, key, first);
        const bool mine = ok && key == bucket;
        float sum = mine ? x : 0.f;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
        if (lane == first) my_dts[bucket] += sum;
        __syncwarp();
        rest &= ~__ballot_sync(kFull, mine);
      }
    }
    __syncthreads();  // the pair's dS is whole
    // dpos_w: diagonal d holds the elements with col - row = d - 63
    const int d = threadIdx.x, last = r0 + kPT - 1;
    float sum = 0.f;
    if (d < kPairDiags)
      for (int rr = 0; rr < kPT; ++rr) {
        const int cc = rr + d - (kPT - 1);
        if (cc >= 0 && cc < kPT) sum += Ts[rr * (kPT + 1) + cc];
      }
    if constexpr (DET) {
      // each run of diagonals that meet on one entry (one diagonal, or those
      // clipped where N > Nm) summed in order by one thread, into the row
      if (d < kPairDiags) diag[d] = sum;
      __syncthreads();
      if (d < kPairDiags) {
        const int idx = hstu::pos_index(last, c0 + d, p.Nm);
        if (d == 0 || hstu::pos_index(last, c0 + d - 1, p.Nm) != idx) {
          float run = 0.f;
          for (int e = d; e < kPairDiags && hstu::pos_index(last, c0 + e, p.Nm) == idx; ++e) run += diag[e];
          prow[idx] += run;
        }
      }
    } else {
      if (d < kPairDiags && sum != 0.f) atomicAdd(p.dpos + hstu::pos_index(last, c0 + d, p.Nm), sum);
    }
  }
  __syncthreads();  // every warp's copy of dts_w's sums is whole
  for (int idx = threadIdx.x; idx < (DET ? n_ts : n_slots); idx += kBwdThreads) {
    // DET: every entry of the row; else the slots, each to its bucket (slot
    // n_slots - 1 holds bucket NB)
    const int s = DET ? (idx < n_slots - 1 ? idx : (idx == p.NB ? n_slots - 1 : -1)) : idx;
    float sum = 0.f;
    if (s >= 0)
      for (int ww = 0; ww < NW; ++ww) sum += dts_s[ww * kTsSlots + s];
    if constexpr (DET) {
      prow[n_pos + idx] = sum;
    } else {
      if (sum != 0.f) atomicAdd(p.dts + (idx == n_slots - 1 ? p.NB : idx), sum);
    }
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

// The bfloat16 backward's pre-scaling pass (bf16_mma.cuh) on the wide
// parameters: q and dO then point at bfloat16(alpha q) and bfloat16(dO /
// norm) in the wrapper's buffers. float32: nothing.
template <typename E>
cudaError_t prescale(Params<E>& p, cudaStream_t stream) {
  if constexpr (std::is_same<E, float>::value) {
    return cudaSuccess;
  } else {
    return hstu_bf16::prescale(p, stream);
  }
}

// The per-pair backward (route kWideChunks) on the plan's scratch: for each
// group of p.group_slabs (batch row, head) slabs in turn, the S / dP pass
// (split in p.splits, then the splits' sums, where the plan splits it), the
// gradient pass (dQ's blocks with DQ, dK's and dV's with DKV; dq written as
// DQT) and with RELBIAS the table sums (DET: to `partial`'s rows, one per
// key tile, head and batch row, `pairs_table_rows`). bfloat16 after the
// pre-scaling pass. The scratch: as `Pairs` lays it out.
inline long long pairs_table_rows(int B, int N, int H) { return (long long)((N + kPT - 1) / kPT) * H * B; }

template <bool RELBIAS, bool DET, bool DQ, bool DKV, typename E, typename DQT>
cudaError_t launch_pairs(Params<E> p, cudaStream_t stream) {
  if (p.scratch == nullptr || p.group_slabs < 1 || p.splits < 1) return cudaErrorInvalidValue;
  cudaError_t err = prescale(p, stream);
  if (err != cudaSuccess) return err;
  const int elem = (int)sizeof(E);
  Pairs w;
  w.scratch = p.scratch;
  w.qt = (p.N + kPT - 1) / kPT;
  w.tiles = (long long)p.group_slabs * w.qt * w.qt;
  w.splits = p.splits;
  w.mats = kBwdMats;
  w.per = (sdp_steps(p.D, p.V, false) + p.splits - 1) / p.splits;
  const int per_slab = (DQ ? w.qt * chunks(p.D) : 0) + (DKV ? w.qt * (chunks(p.D) + chunks(p.V)) : 0);
  constexpr int kB = RELBIAS ? kRelBias : kNoBias;
  void (*sdp)(Params<E>, Pairs) = w.splits > 1 ? sdp_kernel<kB, false, true, E> : sdp_kernel<kB, false, false, E>;
  void (*sums)(Params<E>, Pairs) = sdp_sums_kernel<kB, false, E>;
  void (*grad)(Params<E>, Pairs) = grad_kernel<DQ, DKV, false, E, DQT>;
  err = cudaFuncSetAttribute(sdp, cudaFuncAttributeMaxDynamicSharedMemorySize, sdp_smem_bytes(elem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(grad, cudaFuncAttributeMaxDynamicSharedMemorySize, grad_smem_bytes(elem));
  if (err != cudaSuccess) return err;
  const int slabs_all = p.B * p.H;
  for (int slab0 = 0; slab0 < slabs_all; slab0 += p.group_slabs) {
    w.slab0 = slab0;
    const int slabs = min(p.group_slabs, slabs_all - slab0);
    const long long pairs = (long long)slabs * w.qt * w.qt;
    const long long grid[4] = {pairs * w.splits, pairs, (long long)slabs * per_slab, (long long)slabs * w.qt};
    for (long long g : grid)
      if (g > 0x7fffffffLL) return cudaErrorInvalidValue;
    sdp<<<(unsigned)grid[0], kBwdThreads, sdp_smem_bytes(elem), stream>>>(p, w);
    if (w.splits > 1) sums<<<(unsigned)grid[1], kBwdThreads, 0, stream>>>(p, w);
    grad<<<(unsigned)grid[2], kBwdThreads, grad_smem_bytes(elem), stream>>>(p, w);
    if constexpr (RELBIAS) tables_kernel<DET, E><<<(unsigned)grid[3], kBwdThreads, tables_smem_bytes(), stream>>>(p, w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The per-pair forward (route kWideChunks) on the plan's scratch: for each
// group of p.group_slabs (batch row, head) slabs in turn, the S pass (split
// in p.splits, then the splits' sums, where the plan splits it) and the P V
// pass, a block per (query tile, V chunk, slab). bfloat16 reads rows in
// 16-byte pieces of 8 where the pointer, the strides and the width allow
// (float32: the caller's `vec_*`, pieces of 4). The scratch: as `Pairs`
// lays it out, with kFwdMats tiles a pair.
template <int BIAS, typename E>
cudaError_t launch_fwd_pairs(Params<E> p, cudaStream_t stream) {
  if (p.scratch == nullptr || p.group_slabs < 1 || p.splits < 1) return cudaErrorInvalidValue;
  if constexpr (!std::is_same<E, float>::value) {
    p.vec_q = vec8(p.q, p.q_sb, p.q_sn, p.q_sh, p.D);
    p.vec_k = vec8(p.k, p.k_sb, p.k_sn, p.k_sh, p.D);
    p.vec_v = vec8(p.v, p.v_sb, p.v_sn, p.v_sh, p.V);
  }
  const int elem = (int)sizeof(E);
  Pairs w;
  w.scratch = p.scratch;
  w.qt = (p.N + kPT - 1) / kPT;
  w.tiles = (long long)p.group_slabs * w.qt * w.qt;
  w.splits = p.splits;
  w.mats = kFwdMats;
  w.per = (sdp_steps(p.D, p.V, true) + p.splits - 1) / p.splits;
  void (*sdp)(Params<E>, Pairs) = w.splits > 1 ? sdp_kernel<BIAS, true, true, E> : sdp_kernel<BIAS, true, false, E>;
  void (*sums)(Params<E>, Pairs) = sdp_sums_kernel<BIAS, true, E>;
  void (*pv)(Params<E>, Pairs) = grad_kernel<true, false, true, E, E>;
  cudaError_t err = cudaFuncSetAttribute(sdp, cudaFuncAttributeMaxDynamicSharedMemorySize, sdp_smem_bytes(elem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(pv, cudaFuncAttributeMaxDynamicSharedMemorySize, grad_smem_bytes(elem));
  if (err != cudaSuccess) return err;
  const int slabs_all = p.B * p.H;
  for (int slab0 = 0; slab0 < slabs_all; slab0 += p.group_slabs) {
    w.slab0 = slab0;
    const int slabs = min(p.group_slabs, slabs_all - slab0);
    const long long pairs = (long long)slabs * w.qt * w.qt;
    const long long grid[3] = {pairs * w.splits, pairs, (long long)slabs * w.qt * chunks(p.V)};
    for (long long g : grid)
      if (g > 0x7fffffffLL) return cudaErrorInvalidValue;
    sdp<<<(unsigned)grid[0], kBwdThreads, sdp_smem_bytes(elem), stream>>>(p, w);
    if (w.splits > 1) sums<<<(unsigned)grid[1], kBwdThreads, 0, stream>>>(p, w);
    pv<<<(unsigned)grid[2], kBwdThreads, grad_smem_bytes(elem), stream>>>(p, w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
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
