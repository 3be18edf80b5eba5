// K7: fused HSTU attention backward with the relative position and time bias
// for Hopper (sm_90a), float32 in and out: dq, dk, dv and the gradients of
// both bias tables in one pass over the live tile pairs. Replaces
// `_bwd_kernel_relbias` (called from `_relbias_bwd`) of
// generative_recommenders_tpu/ops/pallas/hstu_attention_relbias.py.
//
// Per head, with S recomputed from Q and K (the forward saves only q, k, v):
//
//   S = alpha Q K^T + bias   sig = sigmoid(S)   P = S sig mask
//   dV = P^T dO / norm       dS = (dO V^T / norm) * sig (1 + S (1 - sig)) * mask
//   dK = alpha dS^T Q        dQ = alpha dS K
//   dts_w[t]  = sum of dS over heads and the live elements of bucket t
//   dpos_w[p] = sum of dS over heads and the diagonal col - row + Nm - 1 = p
//
// with the bias, `ts_bucket` and `pos_index` of hstu_attention.cuh and the
// mask `valid_elem` with the length guard on, so rows and columns at or past
// a row's length get exact zero gradients.
//
// Bound on the H100: at the research shape (D = V = 32) the five S-sized
// products are 320 multiply-adds per live element and head against 16 bytes
// per live row and head; held to the tensor cores' 3xTF32 rate (a third of
// dense TF32) the operations take about as long as the bytes (PERF.md). The
// design:
// * Tensor cores with float32 accuracy. The five products run as
//   `mma.sync.m16n8k8` TF32 with the 3xTF32 split: every operand x is cut into
//   big = tf32(x) and small = x - big, and a product is
//   small big + big small + big big, summed in float32. Plain TF32 keeps
//   three digits and would not hold the 2e-5 tolerances. Fragments are read
//   from shared-memory tiles whose pitch (8 more than a multiple of 32
//   floats) keeps all but one of the fragment loads free of bank conflicts,
//   along the rows and transposed; P and dS cross the block through shared
//   memory, read transposed by dV and dK. `wgmma` was not taken: it
//   reads TF32 operands K-major only, so two of the five products would need
//   transposed copies of Q, dO and K, and 3xTF32 needs every operand twice
//   (big and small): more shared memory than a block has beside the resident
//   K and V of a head group. What that costs: the tensor cores wait for
//   fragments. Replacing every mma.sync by plain adds leaves the kernel's
//   time where it was; the loads of fragments from shared memory and their
//   splitting set the pace (PERF.md has the measurements).
// * The bias once per (row, column), not once per head. A block of 16 warps
//   owns a 64-column key tile of one batch row and a group of HG heads
//   (4 at width 32, 2 at width 64, 1 at 128; H need not be a multiple). K
//   and V of the group stay in shared memory and dK / dV in registers for the
//   whole walk over the live 64-row query tiles. Per tile pair the mask, `pos_index`,
//   `ts_bucket` (one logf) and both table reads are computed once and kept in
//   registers; per head only x = alpha s + bias, the sigmoid and dS follow,
//   and dS is summed over the group's heads in registers before the table
//   sums.
// * The table sums use no shared-memory atomics on single elements (a
//   float32 atomicAdd on shared memory is a compare-and-swap loop, and a
//   block's elements meet on few entries). dts_w: per element slot a warp
//   takes its distinct buckets in turn (often one, away from the diagonal),
//   sums each by shuffles, and one lane adds the sum to the warp's own copy
//   of the table. dpos_w: the head sums go to shared memory as a 64 x 64
//   tile and each diagonal is summed by four threads. At its end the block
//   adds the entries it touched to the zeroed global dpos_w and dts_w with
//   atomicAdd. The TPU kernel's lane gathers, 128-wide table rows and
//   diagonal shears are not ported.
// * A warp whose 16 x 16 part of S holds no live element (above the
//   diagonal, past the length, outside a window) skips its products and its
//   sigmoids, and on the diagonal tile pair of a causal walk the sums of dV,
//   dK and dQ skip the steps that hold only masked elements. Blocks are
//   numbered so that the long walks (a row's first key tiles) start first.
// * Loads in flight: the Q and dO tiles of the next (query tile, head) step
//   arrive by `cp.async` into the second of two buffers while this step's
//   products run; 1 / norm is applied to dP and dV on use, not in a pass.
// * dQ leaves as atomicAdd into the zeroed buffer, one 64 x D tile per (tile
//   pair, head), four floats of a row at once where D is a multiple of 4
//   (a lane pair trades halves of its two rows first): with 64-column key
//   tiles a dq row is added to from at most N / 64 blocks. dk and dv use no
//   atomics and give the same bits on every run; dq and the table gradients
//   arrive in an order that changes from run to run.
// * A long table (LONG: both tables, their sums and the per-warp copies do not
//   fit the block's shared memory beside the tiles) is read, not staged: a
//   tile pair's bias reads a window of 127 consecutive entries of pos_w
//   through the L1 cache, and each step's diagonal sums (that window of
//   dpos_w) go to the zeroed global dpos_w with atomicAdd at the step's end
//   (K7-det: to the block's row of `partial`, one thread per entry, in step
//   order). dts_w's per-warp copies keep the buckets a float32 time gap
//   reaches (`hstu_wide::kTsSlots`), so NB does not decide what fits.
// * Heads of 65 to 128 (W = 128, `Tiling<128>`): one head a block, whose K, V
//   and dK / dV in registers (8 warps 16 key rows x 64 columns of dV, 8 of
//   dK) take what the head group took at narrower widths. Two (Q, dO) stages
//   of 64 rows at a pitch of 136 do not fit beside K and V (264 KB with the
//   P, dS and head-sum tiles), so the walk takes its 64-row query tiles 32
//   rows a step, the 16 warps as 2 x 8 over the step's 32 x 64 part of S,
//   and keeps two stages (154 KB of tiles); with one head, dS is its own head
//   sum and the diagonal sums read the dS tile. One 64-row stage, its next
//   tiles requested once every warp is past dV and dK (`ST = 1`), took 13%
//   longer (PERF.md). S and dP are computed once per tile pair, as at every
//   narrower width and in the wide backward.
// Head widths are padded with zero columns to W = 32, 64 or 128; wider heads
// take the wide backward (hstu_attention_wide.cuh): K7 its dkv pass with dQ
// added into the zeroed float32 dq and the table sums with atomics, K7-det
// its dq pass, then its dkv pass with each block's table sums in a row of
// its own.
//
// `hstu_mha_relbias_bwd_bf16` (K7-bf16) computes the same function on
// bfloat16 q, k, v and dO, with the TPU kernel's rounding points, on a body of
// its own on the bfloat16 tensor cores (hstu_attention_relbias_bwd_bf16.cuh,
// included before its entry points at the end of this file): a
// pre-scaling pass forms bfloat16(alpha q) and bfloat16(dO / norm), the
// tiles stay bfloat16 and arrive by `cp.async`, and the five products are
// `mma.sync.m16n8k16`. Its dq is summed in a zeroed float32 buffer, as in
// float32, and a second kernel writes it as bfloat16. This body is float32
// only.
//
// K7-det (`hstu_mha_relbias_bwd_det`, and `_bf16` on bfloat16 at the same
// rounding points) computes the same function and sums every output in one
// fixed order, so that it gives the same bits on every run, as the TPU
// kernel does by keeping dq and both table sums in VMEM over a sequential
// grid. A sum across blocks needs atomics or a second pass; the atomics are
// what change the order, so it takes one pass over the tile pairs and a
// second launch for the sums:
// * this kernel with DET set: dk and dv as in K7; dQ = dS K of each (query
//   tile, head) step, as K7 computes it, stored (not added) to the tile
//   pair's own 64 x D slot of a float32 `dq_partial` buffer [B, pairs, 64,
//   H, D]: one slot per (batch row, query tile, key tile) that the walk
//   visits (`det_slot`: the pairs on and below the diagonal of a causal walk
//   without contextual rows, else every pair), rows at or past the length
//   left unwritten; each block's table sums written (not added) to its own
//   row of a float32 [blocks, (2 Nm - 1) + (NB + 1)] buffer `partial`, zeros
//   where it holds none; diagonals clipped to one entry (N > Nm) summed by
//   one thread in order;
// * `det_sums_kernel`: each dq element the sum of its slots over the key
//   tiles in ascending order, rounded once to q's type; the blocks' rows of
//   `partial` added entry by entry in block order.
// Bound: K7's (the same function; on bfloat16 K7-bf16's, its operations at
// the card's bfloat16 rate, 989 TFLOP/s); what K7-det takes beyond K7's time
// is the cost of the fixed order: the slots' 64 x D x 4 bytes per live tile
// pair and head written once and read once, where K7 adds into an
// L2-resident dq.
#include <cstdint>
#include <type_traits>

#include "hstu_attention.cuh"
#include "hstu_attention_wide.cuh"
#include "tf32_mma.cuh"

namespace hstu_relbias_bwd {

using namespace hstu_tf32;

constexpr int kThreads = 512;  // 16 warps as a 4 x 4 grid
constexpr int kWarps = kThreads / 32;
constexpr int kT = 64;         // query rows and key columns per tile
constexpr int kPad = 8;        // every tile's pitch is 8 more than its width
constexpr int kSP = kT + kPad; // pitch of the P and dS tiles
constexpr unsigned kFull = 0xffffffffu;

// The float32 body's tiling per padded width, mirrored by `_TILING_F32` in
// ops/cuda/hstu_attention_relbias.py: HG heads a block, the walk's 64-row
// query tiles taken QT rows a step, ST (Q, dO) stages (2: the next step's
// tiles arrive while this step's products run; 1: while its dQ and table
// sums run)
template <int W> struct Tiling;
template <> struct Tiling<32> { static constexpr int HG = 4, QT = 64, ST = 2; };
template <> struct Tiling<64> { static constexpr int HG = 2, QT = 64, ST = 2; };
template <> struct Tiling<128> { static constexpr int HG = 1, QT = 32, ST = 2; };

// the float32 body's heads a block at widths D and V
inline int head_group_f32(int D, int V) {
  const int w = D > V ? D : V;
  return w <= 32 ? Tiling<32>::HG : w <= 64 ? Tiling<64>::HG : Tiling<128>::HG;
}

// E: float, or __nv_bfloat16 for the bfloat16 body. The pointers keep
// their element type: with untyped (void) pointers cast in the kernel, ptxas
// spilled 400 bytes instead of 280 in the float32 width-32 instance.
template <typename E>
struct Params {
  const E* q;
  const E* k;
  const E* v;
  const E* dout;
  float* dq;  // contiguous [B, N, H, D], a zeroed float32 accumulation buffer
  E* dk;      // contiguous [B, N, H, D]
  E* dv;      // contiguous [B, N, H, V]
  const int* lengths;      // int32 [B]
  const int* num_targets;  // int32 [B] or null (no targets)
  const float* ts;     // float32 [B, N] timestamps, contiguous
  const float* pos_w;  // float32 [2 Nm - 1]
  const float* ts_w;   // float32 [NB + 1]
  float* dpos;         // float32 [2 Nm - 1], zeroed
  float* dts;          // float32 [NB + 1], zeroed
  int B, N, H, D, V;
  long long q_sb, q_sn, q_sh;
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  long long do_sb, do_sn, do_sh;
  float alpha, inv_norm;
  int causal, max_attn_len, contextual_seq_len, min_full_attn_seq_len;
  int Nm, NB;
  int vec_q, vec_k, vec_v, vec_do;  // rows readable in 16-byte pieces
  // DET: float32 [blocks, (2 Nm - 1) + (NB + 1)], each block's table sums,
  // and float32 [B, pairs, 64, H, D], each visited tile pair's dQ (dq is
  // null then)
  float* partial = nullptr;
  float* dq_partial = nullptr;
  // the bfloat16 body only: the wrapper's buffers for bfloat16(alpha q)
  // (null where alpha is 1) and bfloat16(dO / norm), contiguous
  E* qs = nullptr;
  E* dos = nullptr;
  // the per-pair wide backward (route kWideChunks): its float32 scratch,
  // the slabs of a group and the S / dP pass's splits, as planned
  float* scratch = nullptr;
  int group_slabs = 0, splits = 0;
};

// K7-det's slot of the tile pair (query tile qt, key tile kt) among a batch
// row's: the walk visits the pairs with kt <= qt where a causal mask has no
// contextual rows (`lower_only`), else all tiles x tiles; a query tile's
// slots are consecutive in kt. Mirrored by `_det_slot` in
// ops/cuda/hstu_attention_relbias.py.
__host__ __device__ __forceinline__ long long det_slot(int qt, int kt, int tiles, bool lower_only) {
  return lower_only ? (long long)qt * (qt + 1) / 2 + kt : (long long)qt * tiles + kt;
}
__host__ __device__ __forceinline__ long long det_pairs(int tiles, bool lower_only) {
  return lower_only ? (long long)tiles * (tiles + 1) / 2 : (long long)tiles * tiles;
}

// K and V of HG heads, st (Q, dO) stages of qt rows, P, dS and (more than
// one head) dS summed over the heads, both tables, dpos_w's sums and one copy
// of dts_w's sums per warp.
__host__ __device__ constexpr long long smem_floats(int w, int hg, int qt, int st, long long n_pos, long long n_ts) {
  return 2LL * hg * kT * (w + kPad) + 2LL * st * qt * (w + kPad) + (hg > 1 ? 3 : 2) * qt * kSP + 2 * n_pos +
         (1 + kWarps) * n_ts;
}
// LONG: the tiles and one copy per warp of dts_w's reachable buckets
__host__ __device__ constexpr long long smem_floats_long(int w, int hg, int qt, int st, int n_ts) {
  return smem_floats(w, hg, qt, st, 0, 0) + kWarps * (n_ts < hstu_wide::kTsSlots ? n_ts : hstu_wide::kTsSlots);
}

// Rows [r0, r0 + R) of one head of a strided [.., N, H, w] tensor into a
// [R][W + 8] shared tile, asynchronously; zero at rows >= lim and in the pad
// columns [w, W). Copied as it is: 1 / norm is applied to dP in float32.
template <int W, int R = kT>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long sn,
                                          int r0, int lim, int w, bool vec) {
  constexpr int P = W + kPad;
  if (vec) {
    constexpr int C4 = W / 4;
    for (int idx = threadIdx.x; idx < R * C4; idx += kThreads) {
      const int r = idx / C4, c = (idx % C4) * 4;
      const bool ok = r0 + r < lim && c < w;
      cp_async16(dst + r * P + c, ok ? src + (long long)(r0 + r) * sn + c : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < R * W; idx += kThreads) {
      const int r = idx / W, c = idx % W;
      const bool ok = r0 + r < lim && c < w;
      cp_async4(dst + r * P + c, ok ? src + (long long)(r0 + r) * sn + c : src, ok);
    }
  }
}

// K7-det's last launch, 1024 threads a block. The first B * tiles * chunks
// blocks: dq, each element the sum of its slots of `dq_partial` over the
// key tiles in ascending order, in float32, written once in q's type (zeros
// at rows past the length); a block takes 4096 floats (1024 where H D is not
// a multiple of 4) of a query tile's 64 x H x D. The blocks after: the
// blocks' rows of `partial` [rows][n] added entry by entry in block order, 32
// entries a block: each of 32 slices sums the rows slice, slice + 32, ... in
// turn, then one thread an entry adds the 32 slices in order. Entry e <
// n_pos goes to dpos[e], the rest to dts[e - n_pos]. tiles = 0: the tables
// alone (the wide bodies' K7-det).
template <typename E>
struct SumParams {
  const float* dq_partial;  // [B, pairs, 64, H, D]
  E* dq;                    // [B, N, H, D]
  const int* lengths;
  int B, N, H, D, tiles, chunks, lower_only;
  const float* partial;  // [rows, n]
  int rows, n, n_pos;
  float* dpos;
  float* dts;
};

template <typename E>
__global__ void __launch_bounds__(1024) det_sums_kernel(SumParams<E> s) {
  const int dq_blocks = s.B * s.tiles * s.chunks;
  if ((int)blockIdx.x < dq_blocks) {
    const int chunk = blockIdx.x % s.chunks, qt = blockIdx.x / s.chunks % s.tiles;
    const int b = blockIdx.x / (s.chunks * s.tiles);
    const long long hd = (long long)s.H * s.D;
    const int row0 = qt * kT;
    const int length = min(s.lengths[b], s.N);
    const int live = max(0, min(kT, length - row0));  // the tile's rows below the length
    // the key tiles whose walk visits this query tile, in ascending order
    const int kts = live == 0 ? 0 : (s.lower_only ? qt + 1 : (length + kT - 1) / kT);
    const float* src = s.dq_partial + ((long long)b * det_pairs(s.tiles, s.lower_only) +
                                       det_slot(qt, 0, s.tiles, s.lower_only)) * kT * hd;
    E* dst = s.dq + ((long long)b * s.N + row0) * hd;
    const bool vec = hd % 4 == 0;
    const long long i = ((long long)chunk * 1024 + threadIdx.x) * (vec ? 4 : 1);
    if (i >= min(kT, s.N - row0) * hd) return;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < live * hd) {
      for (int kt = 0; kt < kts; ++kt) {
        const float* sp = src + (long long)kt * kT * hd + i;
        if (vec) {
          const float4 r = __ldcs(reinterpret_cast<const float4*>(sp));
          x.x += r.x; x.y += r.y; x.z += r.z; x.w += r.w;
        } else {
          x.x += __ldcs(sp);
        }
      }
    }
    if (!vec) {
      dst[i] = E(x.x);
    } else if constexpr (std::is_same<E, float>::value) {
      *reinterpret_cast<float4*>(dst + i) = x;
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y), hi = __floats2bfloat162_rn(x.z, x.w);
      *reinterpret_cast<uint2*>(dst + i) =
          make_uint2(*reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
    }
    return;
  }
  __shared__ float sums[32][33];
  const int lane = threadIdx.x & 31, slice = threadIdx.x >> 5;
  const int e = ((int)blockIdx.x - dq_blocks) * 32 + lane;
  float sum = 0.f;
  if (e < s.n)
    for (int r = slice; r < s.rows; r += 32) sum += s.partial[(long long)r * s.n + e];
  sums[slice][lane] = sum;
  __syncthreads();
  if (slice == 0 && e < s.n) {
    float total = 0.f;
    for (int i = 0; i < 32; ++i) total += sums[i][lane];
    if (e < s.n_pos)
      s.dpos[e] = total;
    else
      s.dts[e - s.n_pos] = total;
  }
}

// W: the padded head width (32, 64 or 128), its tiling `Tiling<W>`; DET:
// K7-det's pass, dQ stored to its tile pair's slot of `dq_partial` and the
// table sums to the block's row of `partial`; LONG: the tables read from
// device memory and dpos_w's sums flushed per step.
template <int W, bool DET, bool LONG = false>
__global__ void __launch_bounds__(kThreads, 1) relbias_bwd_kernel(Params<float> p) {
  constexpr int HG = Tiling<W>::HG, QT = Tiling<W>::QT, ST = Tiling<W>::ST;
  // alpha and 1 / norm: applied to S, dK, dP and dV on use (dq takes alpha
  // as it is written)
  const float s_alpha = p.alpha, dp_scale = p.inv_norm;
  constexpr int P = W + kPad;  // pitch of the Q, K, V and dO tiles
  // the 16 warps over a step's QT x 64 part of S: WR rows of warps, WC
  // columns, each warp 16 rows x 8 JN columns
  constexpr int WR = QT / 16, WC = kWarps / WR, JN = kT / WC / 8;
  constexpr int NE = 4 * JN;       // the elements of S a thread holds
  constexpr int NA = W / 16;       // 8-wide output tiles per warp in dK or dV
  constexpr int NQ = W / 8 / WC;   // and in dQ
  constexpr int KS = W / 8;        // k-steps over a head's width
  static_assert(kT % QT == 0 && WR * WC == kWarps && JN >= 1 && NQ >= 1, "a step's tiling");
  // one head: dS is its own head sum, and the diagonal sums read the dS tile
  constexpr bool kOwnTs = HG > 1;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                    // [HG][64][P]
  float* Vs = Ks + HG * kT * P;        // [HG][64][P]
  float* stages = Vs + HG * kT * P;    // ST x { Q [QT][P], dO [QT][P] }
  float* Ps = stages + ST * 2 * QT * P;  // [QT][72]
  float* dSs = Ps + QT * kSP;          // [QT][72]
  float* Ts = kOwnTs ? dSs + QT * kSP : dSs;  // [QT][72]: dS summed over the heads
  float* tables = Ts + QT * kSP;
  const int n_pos = 2 * p.Nm - 1, n_ts = p.NB + 1;
  // LONG: the buckets a float32 time gap reaches, the last slot bucket NB
  const int n_slots = LONG ? min(n_ts, hstu_wide::kTsSlots) : n_ts;
  float* pos_s = tables;               // pos_w [2 Nm - 1]
  float* ts_s = pos_s + n_pos;         // ts_w [NB + 1]
  float* dpos_s = ts_s + n_ts;         // dpos_w's sums [2 Nm - 1]
  // dts_w's sums, one copy per warp (LONG: right after the tiles)
  float* dts_s = LONG ? tables : dpos_s + n_pos;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp / WC, wc = warp % WC;  // the warp's place in the WR x WC grid
  // warps 0..7 sum dV, warps 8..15 dK: key rows am 16 .. + 16 of the tile,
  // output columns an .. + W / 2
  const bool dv_warp = warp < kWarps / 2;
  const int am = (warp & 7) >> 1, an = (warp & 1) * (W / 2);
  // Blocks start in the order of their index. A key tile's walk is the
  // longer the nearer the tile is to the row's start, so the index counts the
  // key tile last: every row's first tile starts before any row's second,
  // and the short walks fill the end of the launch.
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
    const float* qb = p.q + b * p.q_sb + h0 * p.q_sh;
    const float* kb = p.k + b * p.k_sb + h0 * p.k_sh;
    const float* vb = p.v + b * p.v_sb + h0 * p.v_sh;
    const float* ob = p.dout + b * p.do_sb + h0 * p.do_sh;
    const float* tsb = p.ts + (long long)b * p.N;
    for (int hh = 0; hh < nh; ++hh) {
      load_tile<W>(Ks + hh * kT * P, kb + hh * p.k_sh, p.k_sn, col0, length, p.D, p.vec_k != 0);
      load_tile<W>(Vs + hh * kT * P, vb + hh * p.v_sh, p.v_sn, col0, length, p.V, p.vec_v != 0);
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
    const int col_steps = (cols + 7) / 8;
    // causal without contextual rows: a row sees no column past itself, so
    // earlier query tiles see none of this key tile and the walk starts at
    // its own tile (contextual row 0 sees every column below the target
    // boundary, so the skips are off then)
    const bool lower_only = p.causal != 0 && p.contextual_seq_len == 0;
    const int row_first = lower_only ? col0 : 0;
    // DET: the batch row's dQ slots, and the key tile's among them
    const int tiles = (p.N + kT - 1) / kT;
    float* dq_slots = DET ? p.dq_partial + (long long)b * det_pairs(tiles, lower_only) * kT * p.H * p.D : nullptr;
    // no targets and no window either (the research models): the mask is
    // col <= row below the length
    const bool plain_causal = lower_only && nt == 0 && p.max_attn_len == 0;
    // the step's Q and dO tiles: query rows r0 .. + QT of head hh into stage `st`
    auto load_step = [&](int r0, int hh, int st) {
      float* Q = stages + st * 2 * QT * P;
      load_tile<W, QT>(Q, qb + hh * p.q_sh, p.q_sn, r0, length, p.D, p.vec_q != 0);
      load_tile<W, QT>(Q + QT * P, ob + hh * p.do_sh, p.do_sn, r0, length, p.V, p.vec_do != 0);
    };
    // the step after the one at (r0, hh): its query rows and head
    auto next_step = [&](int r0, int hh, int& nrow, int& nhh) {
      nrow = r0;
      nhh = hh + 1;
      if (nhh >= nh) {
        nhh = 0;
        nrow = r0 + QT;
      }
    };
    load_step(row_first, 0, 0);
    cp_async_commit();
    __syncthreads();  // the tables are in place

    // the key-side timestamps of the thread's columns
    float tk[2 * JN];
#pragma unroll
    for (int j = 0; j < JN; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = col0 + wc * (8 * JN) + j * 8 + 2 * t + c;
        tk[j * 2 + c] = col < p.N ? tsb[col] : 0.f;
      }

    int step = 0;
    for (int row0 = row_first; row0 < length; row0 += QT) {
      const int row_steps = (min(QT, length - row0) + 7) / 8;
      // on the diagonal tile pair: the first query rows that see the warp's
      // key rows, and the last key columns that the warp's query rows see
      const int row_step_first = lower_only ? max(col0 + am * 16 - row0, 0) / 8 : 0;
      const int my_col_steps =
          lower_only ? min(col_steps, (row0 + wr * 16 + 15 - col0) / 8 + 1) : col_steps;
      // mask, bias and bucket of the thread's NE elements of the QT x 64
      // step, once for every head: element e = 4 j + 2 i + c is row
      // wr 16 + g + 8 i, column wc 8 JN + 8 j + 2 t + c
      float bias[NE], dssum[NE];
      unsigned buckets[NE / 2];  // two 16-bit bucket indices each
      unsigned ok_bits = 0;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + wr * 16 + g + 8 * i;
        // row r reads the next position's timestamp (the last position's at
        // the last row), whether or not it lies past the row's length
        const float tq = row < p.N ? tsb[min(row + 1, p.N - 1)] : 0.f;
#pragma unroll
        for (int j = 0; j < JN; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * i + c;
            const int col = col0 + wc * (8 * JN) + j * 8 + 2 * t + c;
            const bool ok =
                row < length && col < length &&
                (plain_causal
                     ? col <= row
                     : hstu::valid_elem(row, col, length, nt, p.causal != 0, p.max_attn_len,
                                        p.contextual_seq_len, p.min_full_attn_seq_len,
                                        /*guard=*/true));
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
      // the warp's part of S holds no live element (above the diagonal, past
      // the length, outside a window): no products, no sigmoid, zeros to P
      // and dS
      const bool dead = __all_sync(kFull, ok_bits == 0);

#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        if (hh < nh) {
          float* Qs = stages + (ST == 2 ? step & 1 : 0) * 2 * QT * P;
          float* dOs = Qs + QT * P;
          const float* Kh = Ks + hh * kT * P;
          const float* Vh = Vs + hh * kT * P;
          cp_async_wait_all();
          // this step's Q and dO are in place, and every warp is done with
          // the previous step's tiles
          __syncthreads();
          if constexpr (ST == 2) {  // the next step's Q and dO, into the other stage
            int nrow, nhh;
            next_step(row0, hh, nrow, nhh);
            if (nrow < length) load_step(nrow, nhh, (step + 1) & 1);
            cp_async_commit();
          }

          // S = Q K^T and dP = dO V^T: the warp's 16 x 8 JN part
          float s[JN][4], dp[JN][4];
#pragma unroll
          for (int j = 0; j < JN; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
          if (!dead) {
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
              const FragA a = load_a(Qs, P, wr * 16, ks * 8);
#pragma unroll
              for (int j = 0; j < JN; ++j)
                mma3(s[j], a, load_b_nk(Kh, P, wc * (8 * JN) + j * 8, ks * 8));
            }
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
              const FragA a = load_a(dOs, P, wr * 16, ks * 8);
#pragma unroll
              for (int j = 0; j < JN; ++j)
                mma3(dp[j], a, load_b_nk(Vh, P, wc * (8 * JN) + j * 8, ks * 8));
            }
          }
#pragma unroll
          for (int j = 0; j < JN; ++j) {
            float pv[4], ds[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int e = 4 * j + c;
              pv[c] = ds[c] = 0.f;
              if ((ok_bits >> e) & 1u) {
                const float x = fmaf(s[j][c], s_alpha, bias[e]);
                const float sig = __fdividef(1.f, 1.f + __expf(-x));
                pv[c] = x * sig;
                ds[c] = dp[j][c] * dp_scale * sig * (1.f + x * (1.f - sig));
                dssum[e] += ds[c];
              }
            }
            const int at = (wr * 16 + g) * kSP + wc * (8 * JN) + j * 8 + 2 * t;
            *reinterpret_cast<float2*>(Ps + at) = make_float2(pv[0], pv[1]);
            *reinterpret_cast<float2*>(Ps + at + 8 * kSP) = make_float2(pv[2], pv[3]);
            *reinterpret_cast<float2*>(dSs + at) = make_float2(ds[0], ds[1]);
            *reinterpret_cast<float2*>(dSs + at + 8 * kSP) = make_float2(ds[2], ds[3]);
          }
          __syncthreads();  // P and dS are whole

          {  // dV += P^T dO or dK += dS^T Q, summed over the live rows
            const float* A = dv_warp ? Ps : dSs;
            const float* Bm = dv_warp ? dOs : Qs;
            // the tile pair's share in registers of its own, added to the
            // walk's sum by a float32 add: the tensor cores' accumulator cuts
            // the aligned bits off, and over a walk of N / 8 steps that
            // showed as 4e-6 of dk's and dv's max against 8e-7 this way
            float part[NA][4];
#pragma unroll
            for (int j = 0; j < NA; ++j)
#pragma unroll
              for (int c = 0; c < 4; ++c) part[j][c] = 0.f;
            for (int ks = row_step_first; ks < row_steps; ++ks) {
              const FragA a = load_a_t(A, kSP, am * 16, ks * 8);
#pragma unroll
              for (int j = 0; j < NA; ++j)
                mma3(part[j], a, load_b_kn(Bm, P, ks * 8, an + j * 8));
            }
#pragma unroll
            for (int j = 0; j < NA; ++j)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[hh][j][c] += part[j][c];
          }
          if constexpr (ST == 1) {
            // every warp is past Q and dO: the next step's tiles, into the
            // one stage, while dQ and the table sums run
            __syncthreads();
            int nrow, nhh;
            next_step(row0, hh, nrow, nhh);
            if (nrow < length) load_step(nrow, nhh, 0);
            cp_async_commit();
          }
          {
            // dQ = dS K: the warp's query rows wr 16 .. + 16 and output columns
            // wc W / WC .. + W / WC, summed over the live columns
            float dq[NQ][4];
#pragma unroll
            for (int j = 0; j < NQ; ++j)
#pragma unroll
              for (int c = 0; c < 4; ++c) dq[j][c] = 0.f;
            for (int ks = 0; ks < my_col_steps; ++ks) {
              const FragA a = load_a(dSs, kSP, wr * 16, ks * 8);
#pragma unroll
              for (int j = 0; j < NQ; ++j)
                mma3(dq[j], a, load_b_kn<true>(Kh, P, ks * 8, wc * (W / WC) + j * 8));
            }
            // dead rows keep the buffer's zeros (K7-det: are not written).
            // Where D is a multiple of 4 a lane pair trades halves, so that
            // each lane adds four floats of one row at once: the even lane row
            // g, the odd lane row g + 8. K7 adds to dq's rows with atomics;
            // K7-det stores the tile pair's rows to its slot
            const bool odd = (t & 1) != 0;
            float* dqh = p.dq + ((long long)b * p.N * p.H + h0 + hh) * p.D;
            // K7-det: the slot's row of query row `row`, less the start of
            // its 64-row query tile
            const long long slot_row =
                DET ? det_slot(row0 / kT, col0 / kT, tiles, lower_only) * kT - row0 / kT * kT : 0;
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
                const int d = wc * (W / WC) + j * 8 + 2 * (t & ~1);
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
                  const int d = wc * (W / WC) + j * 8 + 2 * t + c % 2;
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
      // table sums. dts_w: per element slot the warp takes its distinct
      // buckets in turn (often one, away from the diagonal), sums each by
      // shuffles, and one lane adds the sum to the warp's own copy of the
      // table: no atomics. dpos_w: the sums go to shared memory as a tile,
      // and each diagonal is then summed by four threads.
#pragma unroll
      for (int e = 0; e < NE; ++e) {
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
      if constexpr (kOwnTs) {  // (one head: the dS tile holds these sums already)
#pragma unroll
        for (int j = 0; j < JN; ++j) {
          const int at = (wr * 16 + g) * kSP + wc * (8 * JN) + j * 8 + 2 * t;
          *reinterpret_cast<float2*>(Ts + at) = make_float2(dssum[4 * j], dssum[4 * j + 1]);
          *reinterpret_cast<float2*>(Ts + at + 8 * kSP) =
              make_float2(dssum[4 * j + 2], dssum[4 * j + 3]);
        }
      }
      __syncthreads();  // the next write of Ts follows the next step's barrier
      {
        // diagonal dd holds the elements with col - row = dd - (QT - 1)
        const int dd = threadIdx.x >> 2, part = threadIdx.x & 3;
        float sum = 0.f;
        for (int r = part; r < QT; r += 4) {
          const int c = r + dd - (QT - 1);
          if (c >= 0 && c < kT) sum += Ts[r * kSP + c];
        }
        sum += __shfl_xor_sync(kFull, sum, 1);
        sum += __shfl_xor_sync(kFull, sum, 2);
        if constexpr (DET) {
          if (part == 0) Ps[dd] = sum;  // P is free: every warp is past its products
        } else {
          // diagonals clipped to one entry (N > Nm) meet here: an atomic
          // (LONG: the step's window of dpos_w, straight to device memory)
          if (part == 0 && sum != 0.f)
            atomicAdd((LONG ? p.dpos : dpos_s) + hstu::pos_index(row0 + QT - 1, col0 + dd, p.Nm), sum);
        }
      }
      if constexpr (DET) {
        // each run of diagonals that meet on one entry (one diagonal, or
        // those clipped where N > Nm) summed in order by one thread
        __syncthreads();
        const int dd = threadIdx.x, last = row0 + QT - 1;
        const int idx = hstu::pos_index(last, col0 + dd, p.Nm);
        if (dd < QT + kT - 1 && (dd == 0 || hstu::pos_index(last, col0 + dd - 1, p.Nm) != idx)) {
          float sum = 0.f;
          for (int e = dd; e < QT + kT - 1 && hstu::pos_index(last, col0 + e, p.Nm) == idx; ++e) sum += Ps[e];
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
        // the block's live elements lie at rows < length and columns
        // [col0, col0 + cols): their diagonals span the window [lo, hi]
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
  float* out = dv_warp ? p.dv : p.dk;
  const int width = dv_warp ? p.V : p.D;
  const float scale = dv_warp ? dp_scale : s_alpha;
#pragma unroll
  for (int hh = 0; hh < HG; ++hh) {
    if (hh >= nh) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int col = col0 + am * 16 + g + 8 * i;
      if (col >= p.N) continue;
      float* dst = out + (((long long)b * p.N + col) * p.H + h0 + hh) * width;
#pragma unroll
      for (int j = 0; j < NA; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int d = an + j * 8 + 2 * t + c;
          if (d < width) dst[d] = scale * acc[hh][j][2 * i + c];
        }
      }
    }
  }
}

template <int W, bool DET, bool LONG = false>
cudaError_t launch_w(const Params<float>& p, cudaStream_t stream) {
  constexpr int HG = Tiling<W>::HG, QT = Tiling<W>::QT, ST = Tiling<W>::ST;
  const long long smem = 4 * (LONG ? smem_floats_long(W, HG, QT, ST, p.NB + 1)
                                   : smem_floats(W, HG, QT, ST, 2LL * p.Nm - 1, p.NB + 1LL));
  if (smem > hstu_wide::kMaxShared) return cudaErrorInvalidValue;
  auto kernel = relbias_bwd_kernel<W, DET, LONG>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.N + kT - 1) / kT, (p.H + HG - 1) / HG, p.B);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  kernel<<<grid, kThreads, (size_t)smem, stream>>>(p);
  return cudaGetLastError();
}

// The wide bodies' parameters (hstu_attention_wide.cuh): dq as the caller sets it
template <typename E>
hstu_wide::Params<E> wide_params(const Params<E>& p, void* dq) {
  hstu_wide::Params<E> w = hstu_wide::from<E>(p);
  w.dout = p.dout;
  w.dq = dq;
  w.dk = p.dk;
  w.dv = p.dv;
  w.do_sb = p.do_sb;
  w.do_sn = p.do_sn;
  w.do_sh = p.do_sh;
  w.vec_do = p.vec_do;
  w.ts = p.ts;
  w.pos_w = p.pos_w;
  w.ts_w = p.ts_w;
  w.Nm = p.Nm;
  w.NB = p.NB;
  w.dpos = p.dpos;
  w.dts = p.dts;
  w.partial = p.partial;
  w.qs = p.qs;
  w.dos = p.dos;
  w.scratch = p.scratch;
  w.group_slabs = p.group_slabs;
  w.splits = p.splits;
  return w;
}

// The bfloat16 body (hstu_attention_relbias_bwd_bf16.cuh): its pre-scaling
// pass, then the body on `route`; and the heads a block of it takes
template <bool DET>
int launch_bf16(const Params<__nv_bfloat16>& p, int route, cudaStream_t s);
int head_group_bf16(int D, int V);

// This body on float32, the bfloat16 body on bfloat16 (kNarrow: the tables
// staged; kRead: LONG; D and V up to 128), or with kWide (K7 alone) the wide
// backward's dkv pass with dQ (FUSED) and the tables; with kWideChunks the
// per-pair wide backward on the wrapper's scratch, dQ written whole into the
// float32 dq, the tables added with atomics.
template <typename E, bool DET = false>
int launch(const Params<E>& p, int route, void* stream) {
  if (p.B == 0 || p.N == 0 || p.H == 0) return 0;
  if (p.D < 1 || p.V < 1 || p.Nm < 1 || p.NB < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!DET && route == hstu::kWide) {  // one pass, dQ added into the zeroed float32 dq
    hstu_wide::Params<E> w = wide_params(p, p.dq);
    const cudaError_t err = hstu_wide::prescale(w, s);
    if (err != cudaSuccess) return (int)err;
    return (int)hstu_wide::launch_bwd<hstu_wide::kDkvPass, true, false, true, E>(w, s);
  }
  if (!DET && route == hstu::kWideChunks)
    return (int)hstu_wide::launch_pairs<true, false, true, true, E, float>(wide_params(p, p.dq), s);
  if (p.D > 128 || p.V > 128 || (route != hstu::kNarrow && route != hstu::kRead))
    return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same<E, float>::value) {
    const bool read = route == hstu::kRead;
    if (p.D <= 32 && p.V <= 32) return (int)(read ? launch_w<32, DET, true>(p, s) : launch_w<32, DET>(p, s));
    if (p.D <= 64 && p.V <= 64) return (int)(read ? launch_w<64, DET, true>(p, s) : launch_w<64, DET>(p, s));
    return (int)(read ? launch_w<128, DET, true>(p, s) : launch_w<128, DET>(p, s));
  } else {
    return launch_bf16<DET>(p, route, s);
  }
}

// K7-det: this kernel with DET (on `route`), then `det_sums_kernel`: dq from
// the tile pairs' slots, summed over the key tiles in ascending order, and
// the blocks' table rows in block order; with kWide, the wide backward (its
// relative-bias dq pass, then its dkv pass with the table rows), their rows
// summed in order by the same kernel; with kWideChunks the per-pair wide
// backward on the wrapper's scratch, dq written whole, the table rows one per
// key tile, head and batch row (`hstu_wide::pairs_table_rows`), the same.
// dq: [B, N, H, D] of q's type, written whole; partial: float32 [blocks,
// (2 Nm - 1) + (NB + 1)] with blocks = ceil(N / 64) * ceil(H / HG) * B
// (kWide: one row per block of the dkv pass, `hstu_wide::bwd_table_rows`);
// dq_partial: float32 [B, det_pairs, 64, H, D] (unused by the wide routes);
// dpos and dts are written, not added to.
template <typename E>
int launch_det(const Params<E>& p, E* dq, int route, void* stream) {
  if (p.B == 0 || p.N == 0 || p.H == 0) return 0;
  if (p.D < 1 || p.V < 1 || p.Nm < 1 || p.NB < 0) return (int)cudaErrorInvalidValue;
  const int n_pos = 2 * p.Nm - 1, n = n_pos + p.NB + 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (p.N + kT - 1) / kT;
  const bool lower_only = p.causal != 0 && p.contextual_seq_len == 0;
  // one block per 4096 floats (1024 unvectorized) of a query tile's 64 x H x D
  const long long hd = (long long)p.H * p.D;
  const int chunks = (int)((kT * hd + (hd % 4 == 0 ? 4096 : 1024) - 1) / (hd % 4 == 0 ? 4096 : 1024));
  SumParams<E> sp{p.dq_partial, dq, p.lengths, p.B, p.N, p.H, p.D, tiles, chunks, lower_only,
                  p.partial, 0, n, n_pos, p.dpos, p.dts};
  if (route == hstu::kWide) {
    hstu_wide::Params<E> w = wide_params(p, dq);
    cudaError_t err = hstu_wide::prescale(w, s);
    if (err != cudaSuccess) return (int)err;
    err = hstu_wide::launch_bwd<hstu_wide::kDqPass, true, false, false, E>(w, s);
    if (err != cudaSuccess) return (int)err;
    err = hstu_wide::launch_bwd<hstu_wide::kDkvPass, true, true, false, E>(w, s);
    if (err != cudaSuccess) return (int)err;
    sp.tiles = 0;  // the tables alone
    sp.rows = (int)hstu_wide::bwd_table_rows(p.B, p.N, p.H, p.D, p.V);
  } else if (route == hstu::kWideChunks) {
    const cudaError_t err = hstu_wide::launch_pairs<true, true, true, true, E, E>(wide_params(p, dq), s);
    if (err != cudaSuccess) return (int)err;
    sp.tiles = 0;
    sp.rows = (int)hstu_wide::pairs_table_rows(p.B, p.N, p.H);
  } else {
    if (p.dq_partial == nullptr) return (int)cudaErrorInvalidValue;
    const int err = launch<E, /*DET=*/true>(p, route, stream);
    if (err != 0) return err;
    const int hg = std::is_same<E, float>::value ? head_group_f32(p.D, p.V) : head_group_bf16(p.D, p.V);
    sp.rows = (int)((long long)tiles * ((p.H + hg - 1) / hg) * p.B);
  }
  const long long blocks = (long long)sp.B * sp.tiles * sp.chunks + (n + 31) / 32;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  det_sums_kernel<E><<<(unsigned)blocks, 1024, 0, s>>>(sp);
  return (int)cudaGetLastError();
}

}  // namespace hstu_relbias_bwd

// Launches on `stream` the body `route` names (hstu::Route, the Python
// plan's choice); returns the launch's cudaGetLastError(). D and V up to 128
// take this kernel, its tables staged (kNarrow) or read (kRead: LONG); kWide
// the wide bodies on clusters, kWideChunks the per-pair wide backward. The
// Python wrapper decides the `vec_*` flags.
// scratch, group_slabs, splits: route kWideChunks's float32 scratch and its
// plan (`_wide_bwd_plan`); null and 0 on every other route.
extern "C" int hstu_mha_relbias_bwd(
    const float* q, const float* k, const float* v, const float* dout,
    float* dq, float* dk, float* dv, const int* lengths,
    const int* num_targets, const float* ts, const float* pos_w,
    const float* ts_w, float* dpos, float* dts,
    int B, int N, int H, int D, int V,
    long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn,
    long long v_sh, long long do_sb, long long do_sn, long long do_sh,
    float alpha, float inv_norm, int causal, int max_attn_len,
    int contextual_seq_len, int min_full_attn_seq_len, int Nm, int NB,
    float* scratch, int group_slabs, int splits,
    int vec_q, int vec_k, int vec_v, int vec_do, int route, void* stream) {
  hstu_relbias_bwd::Params<float> p{
      q, k, v, dout, dq, dk, dv, lengths, num_targets, ts, pos_w, ts_w, dpos, dts,
      B, N, H, D, V, q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh,
      do_sb, do_sn, do_sh, alpha, inv_norm, causal, max_attn_len,
      contextual_seq_len, min_full_attn_seq_len, Nm, NB, vec_q, vec_k, vec_v, vec_do};
  p.scratch = scratch;
  p.group_slabs = group_slabs;
  p.splits = splits;
  return hstu_relbias_bwd::launch<float>(p, route, stream);
}

// K7-det on float32: dq, dk and dv written whole; partial and dq_partial
// float32 scratch buffers (`launch_det`); dpos and dts written whole;
// `route` this kernel's body. The same bits on every run.
extern "C" int hstu_mha_relbias_bwd_det(
    const float* q, const float* k, const float* v, const float* dout,
    float* dq, float* dk, float* dv, const int* lengths,
    const int* num_targets, const float* ts, const float* pos_w,
    const float* ts_w, float* dpos, float* dts, float* partial, float* dq_partial,
    int B, int N, int H, int D, int V,
    long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn,
    long long v_sh, long long do_sb, long long do_sn, long long do_sh,
    float alpha, float inv_norm, int causal, int max_attn_len,
    int contextual_seq_len, int min_full_attn_seq_len, int Nm, int NB,
    float* scratch, int group_slabs, int splits,
    int vec_q, int vec_k, int vec_v, int vec_do, int route, void* stream) {
  hstu_relbias_bwd::Params<float> p{
      q, k, v, dout, nullptr, dk, dv, lengths, num_targets, ts, pos_w, ts_w, dpos, dts,
      B, N, H, D, V, q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh,
      do_sb, do_sn, do_sh, alpha, inv_norm, causal, max_attn_len,
      contextual_seq_len, min_full_attn_seq_len, Nm, NB, vec_q, vec_k, vec_v, vec_do, partial, dq_partial};
  p.scratch = scratch;
  p.group_slabs = group_slabs;
  p.splits = splits;
  return hstu_relbias_bwd::launch_det<float>(p, dq, route, stream);
}

#include "hstu_attention_relbias_bwd_bf16.cuh"

// The bfloat16 kernel: q, k, v, dout, dk and dv bfloat16; qs and dos
// contiguous [B, N, H, D] and [B, N, H, V] bfloat16 buffers for
// bfloat16(alpha q) (null where alpha is 1) and bfloat16(dO / norm); dq32 a
// zeroed float32 [B, N, H, D] buffer for dq's sums, which a last launch
// writes into dq as bfloat16; the tables, the timestamps and their gradients
// float32. vec_*: rows readable in 16-byte pieces.
extern "C" int hstu_mha_relbias_bwd_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const __nv_bfloat16* dout, __nv_bfloat16* qs, __nv_bfloat16* dos, float* dq32, __nv_bfloat16* dq,
    __nv_bfloat16* dk, __nv_bfloat16* dv, const int* lengths, const int* num_targets, const float* ts,
    const float* pos_w, const float* ts_w, float* dpos, float* dts,
    int B, int N, int H, int D, int V,
    long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn,
    long long v_sh, long long do_sb, long long do_sn, long long do_sh,
    float alpha, float inv_norm, int causal, int max_attn_len,
    int contextual_seq_len, int min_full_attn_seq_len, int Nm, int NB,
    float* scratch, int group_slabs, int splits,
    int vec_q, int vec_k, int vec_v, int vec_do, int route, void* stream) {
  hstu_relbias_bwd::Params<__nv_bfloat16> p{
      q, k, v, dout, dq32, dk, dv, lengths, num_targets, ts, pos_w, ts_w, dpos, dts,
      B, N, H, D, V, q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh,
      do_sb, do_sn, do_sh, alpha, inv_norm, causal, max_attn_len,
      contextual_seq_len, min_full_attn_seq_len, Nm, NB, vec_q, vec_k, vec_v, vec_do};
  p.scratch = scratch;
  p.group_slabs = group_slabs;
  p.splits = splits;
  p.qs = qs;
  p.dos = dos;
  const int err = hstu_relbias_bwd::launch<__nv_bfloat16>(p, route, stream);
  if (err != 0) return err;
  return (int)hstu_tf32::to_bf16(dq32, dq, (long long)B * N * H * D, static_cast<cudaStream_t>(stream));
}

// K7-det on bfloat16 q, k, v, dout, dq, dk and dv (K7-bf16's rounding
// points; dq's slots float32, each element's sum rounded once); qs and dos as
// K7-bf16's.
extern "C" int hstu_mha_relbias_bwd_det_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const __nv_bfloat16* dout, __nv_bfloat16* qs, __nv_bfloat16* dos, __nv_bfloat16* dq, __nv_bfloat16* dk,
    __nv_bfloat16* dv, const int* lengths, const int* num_targets, const float* ts, const float* pos_w,
    const float* ts_w, float* dpos, float* dts, float* partial, float* dq_partial,
    int B, int N, int H, int D, int V,
    long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn,
    long long v_sh, long long do_sb, long long do_sn, long long do_sh,
    float alpha, float inv_norm, int causal, int max_attn_len,
    int contextual_seq_len, int min_full_attn_seq_len, int Nm, int NB,
    float* scratch, int group_slabs, int splits,
    int vec_q, int vec_k, int vec_v, int vec_do, int route, void* stream) {
  hstu_relbias_bwd::Params<__nv_bfloat16> p{
      q, k, v, dout, nullptr, dk, dv, lengths, num_targets, ts, pos_w, ts_w, dpos, dts,
      B, N, H, D, V, q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh,
      do_sb, do_sn, do_sh, alpha, inv_norm, causal, max_attn_len,
      contextual_seq_len, min_full_attn_seq_len, Nm, NB, vec_q, vec_k, vec_v, vec_do, partial, dq_partial};
  p.scratch = scratch;
  p.group_slabs = group_slabs;
  p.splits = splits;
  p.qs = qs;
  p.dos = dos;
  return hstu_relbias_bwd::launch_det<__nv_bfloat16>(p, dq, route, stream);
}
