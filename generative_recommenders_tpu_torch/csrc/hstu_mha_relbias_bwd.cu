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
//   (4 at width 32, 2 at width 64; H need not be a multiple). K and V of the
//   group stay in shared memory and dK / dV in registers for the whole walk
//   over the live 64-row query tiles. Per tile pair the mask, `pos_index`,
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
// Head widths are padded with zero columns to W = 32 or 64; larger heads are
// refused (the Python wrapper raises; no research preset has them).
//
// `hstu_mha_relbias_bwd_bf16` is the same kernel on bfloat16 q, k, v and dO,
// with the TPU kernel's rounding points: dO enters as bfloat16(dO / norm),
// S, dP and dS are float32, P and dS are rounded to bfloat16 before the
// products dV = P^T dO, dK = dS^T Q and dQ = dS K, and the table gradients
// come from the float32 dS summed over the heads. Its tiles are converted to
// float32 on their way into shared memory (synchronously), and its products
// are one exact TF32 `mma` each (tf32_mma.cuh). dk and dv are written as
// bfloat16; dq is summed in a zeroed float32 buffer, as in float32, and a
// second kernel writes it as bfloat16. alpha must be 1 (the research model's;
// the TPU kernel rounds alpha q to bfloat16, which this kernel does not).
//
// K7-det (`hstu_mha_relbias_bwd_det`, and `_bf16` on bfloat16 at the same
// rounding points) computes the same function and sums every output in one
// fixed order, so that it gives the same bits on every run, as the TPU
// kernel does by keeping dq and both table sums in VMEM over a sequential
// grid. A sum across blocks needs atomics or a second pass; the atomics are
// what change the order, so it takes passes:
// * dq: K3's body (hstu_attention_bwd_dq.cuh) with the relative bias, one
//   block per (64-row query tile, head, batch row), Q and dO resident, dQ in
//   registers over a walk of the key tiles in order. It recomputes S and dP,
//   which this kernel computes too: three products more per live tile pair.
// * dk, dv and the tables: this kernel with DET set, which computes no dQ.
//   Each block writes the table entries it holds (zeros elsewhere) to its
//   own row of a float32 [blocks, (2 Nm - 1) + (NB + 1)] buffer instead of
//   adding them with atomics; diagonals clipped to one entry (N > Nm) are
//   summed by one thread in order.
// * a third kernel adds the blocks' rows entry by entry in block order.
// Bound: K7's (the same function; on bfloat16 K7-bf16's, its operations at
// the card's bfloat16 rate, 989 TFLOP/s); what K7-det takes beyond K7's time
// is the cost of the fixed order.
#include <cstdint>
#include <type_traits>

#include "hstu_attention.cuh"
#include "hstu_attention_bwd_dq.cuh"
#include "tf32_mma.cuh"

namespace hstu_relbias_bwd {

using namespace hstu_tf32;

constexpr int kThreads = 512;  // 16 warps as a 4 x 4 grid
constexpr int kWarps = kThreads / 32;
constexpr int kT = 64;         // query rows and key columns per tile
constexpr int kPad = 8;        // every tile's pitch is 8 more than its width
constexpr int kSP = kT + kPad; // pitch of the P and dS tiles
constexpr unsigned kFull = 0xffffffffu;

// E: float, or __nv_bfloat16 for the bfloat16 kernel. The pointers keep
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
  // DET: float32 [blocks, (2 Nm - 1) + (NB + 1)], each block's table sums
  // (dq is null then)
  float* partial = nullptr;
};

// K and V of HG heads, two (Q, dO) buffers, P, dS and dS summed over heads,
// both tables, dpos_w's sums and one copy of dts_w's sums per warp.
__host__ __device__ constexpr int smem_floats(int w, int hg, int n_pos, int n_ts) {
  return 2 * hg * kT * (w + kPad) + 4 * kT * (w + kPad) + 3 * kT * kSP + 2 * n_pos +
         (1 + kWarps) * n_ts;
}

// Rows [r0, r0 + 64) of one head of a strided [.., N, H, w] tensor into a
// [64][W + 8] shared tile, asynchronously; zero at rows >= lim and in the pad
// columns [w, W). A float32 tile is copied as it is: 1 / norm is applied to
// dP in float32, so this overload takes no scale.
template <int W>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long sn,
                                          int r0, int lim, int w, bool vec) {
  constexpr int P = W + kPad;
  if (vec) {
    constexpr int C4 = W / 4;
    for (int idx = threadIdx.x; idx < kT * C4; idx += kThreads) {
      const int r = idx / C4, c = (idx % C4) * 4;
      const bool ok = r0 + r < lim && c < w;
      cp_async16(dst + r * P + c, ok ? src + (long long)(r0 + r) * sn + c : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < kT * W; idx += kThreads) {
      const int r = idx / W, c = idx % W;
      const bool ok = r0 + r < lim && c < w;
      cp_async4(dst + r * P + c, ok ? src + (long long)(r0 + r) * sn + c : src, ok);
    }
  }
}

// The same of a bfloat16 tensor, converted to float32 (synchronously), and
// where scale != 1 multiplied by it and rounded to bfloat16 again: the TPU
// kernel's bfloat16 product dO / norm.
template <int W>
__device__ __forceinline__ void load_tile(float* dst, const __nv_bfloat16* src, long long sn,
                                          int r0, int lim, int w, bool vec, float scale = 1.f) {
  hstu_tf32::load_tile<W, W + kPad, kT, kThreads>(dst, src, sn, r0, lim, w, vec, scale);
}

// K7-det's table gradients: the blocks' rows of `partial` [blocks][n] added
// entry by entry in block order. A block of 1024 threads takes 32 entries:
// each of 32 slices sums the rows slice, slice + 32, ... in turn, then one
// thread an entry adds the 32 slices in order. Entry e < n_pos goes to
// dpos[e], the rest to dts[e - n_pos].
__global__ void __launch_bounds__(1024) sum_partials_kernel(const float* partial, int blocks, int n,
                                                            int n_pos, float* dpos, float* dts) {
  __shared__ float sums[32][33];
  const int lane = threadIdx.x & 31, slice = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  float sum = 0.f;
  if (e < n)
    for (int b = slice; b < blocks; b += 32) sum += partial[(long long)b * n + e];
  sums[slice][lane] = sum;
  __syncthreads();
  if (slice == 0 && e < n) {
    float total = 0.f;
    for (int i = 0; i < 32; ++i) total += sums[i][lane];
    if (e < n_pos)
      dpos[e] = total;
    else
      dts[e - n_pos] = total;
  }
}

// W: the padded head width (32 or 64); HG: heads per block; E: the type of
// q, k, v, dO, dk and dv (float, or __nv_bfloat16); DET: K7-det's second
// pass, no dQ and the table sums to the block's row of `partial`.
template <int W, int HG, typename E, bool DET>
__global__ void __launch_bounds__(kThreads, 1) relbias_bwd_kernel(Params<E> p) {
  constexpr bool kBf16 = !std::is_same<E, float>::value;
  // 1 / norm: applied to dP and dV on use in float32; in bfloat16 folded into
  // dO's tiles, rounded, as the TPU kernel rounds dO / norm
  const float dp_scale = kBf16 ? 1.f : p.inv_norm;
  const float do_scale = kBf16 ? round_bf16(p.inv_norm) : 1.f;
  constexpr int P = W + kPad;  // pitch of the Q, K, V and dO tiles
  constexpr int NA = W / 16;  // 8-wide output tiles per warp in dK or dV
  constexpr int NQ = W / 32;  // and in dQ
  constexpr int KS = W / 8;   // k-steps over a head's width
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                    // [HG][64][P]
  float* Vs = Ks + HG * kT * P;        // [HG][64][P]
  float* stages = Vs + HG * kT * P;    // 2 x { Q [64][P], dO [64][P] }
  float* Ps = stages + 4 * kT * P;     // [64][72]
  float* dSs = Ps + kT * kSP;          // [64][72]
  float* Ts = dSs + kT * kSP;          // [64][72]: dS summed over the heads
  const int n_pos = 2 * p.Nm - 1, n_ts = p.NB + 1;
  float* pos_s = Ts + kT * kSP;        // pos_w [2 Nm - 1]
  float* ts_s = pos_s + n_pos;         // ts_w [NB + 1]
  float* dpos_s = ts_s + n_ts;         // dpos_w's sums [2 Nm - 1]
  float* dts_s = dpos_s + n_pos;       // dts_w's sums, one copy per warp

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp >> 2, wc = warp & 3;  // the warp's place in the 4 x 4 grid
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

  float acc[HG][NA][4];
#pragma unroll
  for (int hh = 0; hh < HG; ++hh)
#pragma unroll
    for (int j = 0; j < NA; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[hh][j][c] = 0.f;

  if (col0 < length) {
    const E* qb = p.q + b * p.q_sb + h0 * p.q_sh;
    const E* kb = p.k + b * p.k_sb + h0 * p.k_sh;
    const E* vb = p.v + b * p.v_sb + h0 * p.v_sh;
    const E* ob = p.dout + b * p.do_sb + h0 * p.do_sh;
    const float* tsb = p.ts + (long long)b * p.N;
    for (int hh = 0; hh < nh; ++hh) {
      load_tile<W>(Ks + hh * kT * P, kb + hh * p.k_sh, p.k_sn, col0, length, p.D, p.vec_k != 0);
      load_tile<W>(Vs + hh * kT * P, vb + hh * p.v_sh, p.v_sn, col0, length, p.V, p.vec_v != 0);
    }
    for (int idx = threadIdx.x; idx < n_pos; idx += kThreads) {
      pos_s[idx] = p.pos_w[idx];
      dpos_s[idx] = 0.f;
    }
    for (int idx = threadIdx.x; idx < n_ts; idx += kThreads) ts_s[idx] = p.ts_w[idx];
    for (int idx = threadIdx.x; idx < kWarps * n_ts; idx += kThreads) dts_s[idx] = 0.f;
    float* my_dts = dts_s + warp * n_ts;
    const int cols = min(kT, length - col0);
    const int col_steps = (cols + 7) / 8;
    // causal without contextual rows: a row sees no column past itself, so
    // earlier query tiles see none of this key tile and the walk starts at
    // its own tile (contextual row 0 sees every column below the target
    // boundary, so the skips are off then)
    const bool lower_only = p.causal != 0 && p.contextual_seq_len == 0;
    const int row_first = lower_only ? col0 : 0;
    // no targets and no window either (the research models): the mask is
    // col <= row below the length
    const bool plain_causal = lower_only && nt == 0 && p.max_attn_len == 0;
    load_tile<W>(stages, qb, p.q_sn, row_first, length, p.D, p.vec_q != 0);
    if constexpr (kBf16)  // dO / norm, rounded to bfloat16
      load_tile<W>(stages + kT * P, ob, p.do_sn, row_first, length, p.V, p.vec_do != 0, do_scale);
    else
      load_tile<W>(stages + kT * P, ob, p.do_sn, row_first, length, p.V, p.vec_do != 0);
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
      const int row_steps = (min(kT, length - row0) + 7) / 8;
      // on the diagonal tile pair: the first query rows that see the warp's
      // key rows, and the last key columns that the warp's query rows see
      const int row_step_first = lower_only ? max(col0 + am * 16 - row0, 0) / 8 : 0;
      const int my_col_steps =
          lower_only ? min(col_steps, (row0 + wr * 16 + 15 - col0) / 8 + 1) : col_steps;
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
                (plain_causal
                     ? col <= row
                     : hstu::valid_elem(row, col, length, nt, p.causal != 0, p.max_attn_len,
                                        p.contextual_seq_len, p.min_full_attn_seq_len,
                                        /*guard=*/true));
            const int bucket = hstu::ts_bucket(tq, tk[j * 2 + c], p.NB);
            bias[e] = pos_s[hstu::pos_index(row, col, p.Nm)] + ts_s[bucket];
            dssum[e] = 0.f;
            ok_bits |= (ok ? 1u : 0u) << e;
            if (e % 2 == 0) buckets[e / 2] = (unsigned)bucket;
            else buckets[e / 2] |= (unsigned)bucket << 16;
          }
      }
      // the warp's 16 x 16 tile of S holds no live element (above the
      // diagonal, past the length, outside a window): no products, no
      // sigmoid, zeros to P and dS
      const bool dead = __all_sync(kFull, ok_bits == 0);

#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        if (hh < nh) {
          float* Qs = stages + (step & 1) * 2 * kT * P;
          float* dOs = Qs + kT * P;
          const float* Kh = Ks + hh * kT * P;
          const float* Vh = Vs + hh * kT * P;
          cp_async_wait_all();
          // this step's Q and dO are in place, and every warp is done with
          // the previous step's tiles
          __syncthreads();
          {  // the next step's Q and dO, into the other buffer
            int nrow = row0, nhh = hh + 1;
            if (nhh >= nh) {
              nhh = 0;
              nrow = row0 + kT;
            }
            if (nrow < length) {
              float* nQ = stages + ((step + 1) & 1) * 2 * kT * P;
              load_tile<W>(nQ, qb + nhh * p.q_sh, p.q_sn, nrow, length, p.D, p.vec_q != 0);
              if constexpr (kBf16)
                load_tile<W>(nQ + kT * P, ob + nhh * p.do_sh, p.do_sn, nrow, length, p.V,
                             p.vec_do != 0, do_scale);
              else
                load_tile<W>(nQ + kT * P, ob + nhh * p.do_sh, p.do_sn, nrow, length, p.V,
                             p.vec_do != 0);
            }
            cp_async_commit();
          }

          // S = Q K^T and dP = dO V^T: the warp's 16 x 16 tile
          float s[2][4], dp[2][4];
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
          if (!dead) {
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
              const FragA a = load_a(Qs, P, wr * 16, ks * 8);
#pragma unroll
              for (int j = 0; j < 2; ++j)
                mma<kBf16>(s[j], a, load_b_nk(Kh, P, wc * 16 + j * 8, ks * 8));
            }
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
              const FragA a = load_a(dOs, P, wr * 16, ks * 8);
#pragma unroll
              for (int j = 0; j < 2; ++j)
                mma<kBf16>(dp[j], a, load_b_nk(Vh, P, wc * 16 + j * 8, ks * 8));
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
                const float x = fmaf(s[j][c], p.alpha, bias[e]);
                const float sig = __fdividef(1.f, 1.f + __expf(-x));
                pv[c] = x * sig;
                ds[c] = dp[j][c] * dp_scale * sig * (1.f + x * (1.f - sig));
                dssum[e] += ds[c];
              }
            }
            if constexpr (kBf16) {  // the products take P and dS in bfloat16
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                pv[c] = round_bf16(pv[c]);
                ds[c] = round_bf16(ds[c]);
              }
            }
            const int at = (wr * 16 + g) * kSP + wc * 16 + j * 8 + 2 * t;
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
                mma<kBf16>(part[j], a, load_b_kn(Bm, P, ks * 8, an + j * 8));
            }
#pragma unroll
            for (int j = 0; j < NA; ++j)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[hh][j][c] += part[j][c];
          }
          if constexpr (!DET) {  // K7-det's dq is the first pass's
            // dQ = dS K: the warp's query rows wr 16 .. + 16 and output columns
            // wc W / 4 .. + W / 4, summed over the live columns
            float dq[NQ][4];
#pragma unroll
            for (int j = 0; j < NQ; ++j)
#pragma unroll
              for (int c = 0; c < 4; ++c) dq[j][c] = 0.f;
            for (int ks = 0; ks < my_col_steps; ++ks) {
              const FragA a = load_a(dSs, kSP, wr * 16, ks * 8);
#pragma unroll
              for (int j = 0; j < NQ; ++j)
                mma<kBf16>(dq[j], a, load_b_kn<true>(Kh, P, ks * 8, wc * (W / 4) + j * 8));
            }
            // dead rows keep the buffer's zeros. Where D is a multiple of 4 a
            // lane pair trades halves, so that each lane adds four floats of
            // one row at once: the even lane row g, the odd lane row g + 8
            const bool odd = (t & 1) != 0;
            float* dqh = p.dq + ((long long)b * p.N * p.H + h0 + hh) * p.D;
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
                  atomicAdd(reinterpret_cast<float4*>(dqh + (long long)row * p.H * p.D + d),
                            make_float4(p.alpha * x.x, p.alpha * x.y, p.alpha * x.z, p.alpha * x.w));
                }
              } else {
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                  const int row = row0 + wr * 16 + g + 8 * (c / 2);
                  const int d = wc * (W / 4) + j * 8 + 2 * t + c % 2;
                  if (row < length && d < p.D)
                    atomicAdd(dqh + (long long)row * p.H * p.D + d, p.alpha * dq[j][c]);
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
        *reinterpret_cast<float2*>(Ts + at + 8 * kSP) =
            make_float2(dssum[4 * j + 2], dssum[4 * j + 3]);
      }
      __syncthreads();  // the next write of Ts follows the next step's barrier
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
          if (part == 0) Ps[dd] = sum;  // P is free: every warp is past its products
        } else {
          // diagonals clipped to one entry (N > Nm) meet here: an atomic
          if (part == 0 && sum != 0.f)
            atomicAdd(dpos_s + hstu::pos_index(row0 + kT - 1, col0 + dd, p.Nm), sum);
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
          for (int e = dd; e < 2 * kT - 1 && hstu::pos_index(last, col0 + e, p.Nm) == idx; ++e) sum += Ps[e];
          dpos_s[idx] += sum;
        }
      }
    }

    __syncthreads();
    if constexpr (DET) {  // the block's row of `partial`: every entry, zeros where untouched
      float* row = p.partial + (long long)block * (n_pos + n_ts);
      for (int idx = threadIdx.x; idx < n_pos; idx += kThreads) row[idx] = dpos_s[idx];
      for (int idx = threadIdx.x; idx < n_ts; idx += kThreads) {
        float sum = 0.f;
        for (int w = 0; w < kWarps; ++w) sum += dts_s[w * n_ts + idx];
        row[n_pos + idx] = sum;
      }
    } else {
      // the block's live elements lie at rows < length and columns
      // [col0, col0 + cols): their diagonals span the window [lo, hi]
      const int lo = hstu::pos_index(length - 1, col0, p.Nm);
      const int hi = hstu::pos_index(0, col0 + cols - 1, p.Nm);
      for (int idx = lo + threadIdx.x; idx <= hi; idx += kThreads) {
        const float sum = dpos_s[idx];
        if (sum != 0.f) atomicAdd(p.dpos + idx, sum);
      }
      for (int idx = threadIdx.x; idx < n_ts; idx += kThreads) {
        float sum = 0.f;
        for (int w = 0; w < kWarps; ++w) sum += dts_s[w * n_ts + idx];
        if (sum != 0.f) atomicAdd(p.dts + idx, sum);
      }
    }
  } else if constexpr (DET) {  // a dead key tile's row of `partial` holds zeros
    const int n = 2 * p.Nm - 1 + p.NB + 1;
    for (int idx = threadIdx.x; idx < n; idx += kThreads) p.partial[(long long)block * n + idx] = 0.f;
  }

  // every element of dk and dv is written: zeros where the tile is dead
  E* out = dv_warp ? p.dv : p.dk;
  const int width = dv_warp ? p.V : p.D;
  const float scale = dv_warp ? dp_scale : p.alpha;
#pragma unroll
  for (int hh = 0; hh < HG; ++hh) {
    if (hh >= nh) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int col = col0 + am * 16 + g + 8 * i;
      if (col >= p.N) continue;
      E* dst = out + (((long long)b * p.N + col) * p.H + h0 + hh) * width;
#pragma unroll
      for (int j = 0; j < NA; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int d = an + j * 8 + 2 * t + c;
          if (d < width) dst[d] = E(scale * acc[hh][j][2 * i + c]);
        }
      }
    }
  }
}

template <int W, int HG, typename E, bool DET>
cudaError_t launch_w(const Params<E>& p, cudaStream_t stream) {
  const int smem = smem_floats(W, HG, 2 * p.Nm - 1, p.NB + 1) * (int)sizeof(float);
  auto kernel = relbias_bwd_kernel<W, HG, E, DET>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.N + kT - 1) / kT, (p.H + HG - 1) / HG, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename E, bool DET = false>
int launch(const Params<E>& p, void* stream) {
  if (p.B == 0 || p.N == 0 || p.H == 0) return 0;
  if (p.D < 1 || p.V < 1 || p.D > 64 || p.V > 64 || p.Nm < 1 || p.NB < 0 || p.NB > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.D <= 32 && p.V <= 32) return (int)launch_w<32, 4, E, DET>(p, s);
  return (int)launch_w<64, 2, E, DET>(p, s);
}

// K7-det: the dq pass, this kernel without dq (DET), then the sum of the
// blocks' table rows in block order. dq: [B, N, H, D] of q's type, written
// whole; partial: float32 [blocks, (2 Nm - 1) + (NB + 1)] with blocks =
// ceil(N / 64) * ceil(H / HG) * B; dpos and dts are written, not added to.
template <typename E>
int launch_det(const Params<E>& p, E* dq, void* stream) {
  if (p.B == 0 || p.N == 0 || p.H == 0) return 0;
  hstu_bwd_dq::Params<E> d{p.q, p.k, p.v, p.dout, dq, p.lengths, p.num_targets, p.B, p.N, p.H, p.D, p.V,
                           p.q_sb, p.q_sn, p.q_sh, p.k_sb, p.k_sn, p.k_sh, p.v_sb, p.v_sn, p.v_sh,
                           p.do_sb, p.do_sn, p.do_sh, p.alpha, p.inv_norm, p.causal, p.max_attn_len,
                           p.contextual_seq_len, p.min_full_attn_seq_len,
                           p.vec_q, p.vec_k, p.vec_v, p.vec_do, p.ts, p.pos_w, p.ts_w, p.Nm, p.NB};
  int err = hstu_bwd_dq::launch<E, /*RELBIAS=*/true>(d, stream);
  if (err != 0) return err;
  err = launch<E, /*DET=*/true>(p, stream);
  if (err != 0) return err;
  const int hg = p.D <= 32 && p.V <= 32 ? 4 : 2;
  const long long blocks = (long long)((p.N + kT - 1) / kT) * ((p.H + hg - 1) / hg) * p.B;
  const int n_pos = 2 * p.Nm - 1, n = n_pos + p.NB + 1;
  sum_partials_kernel<<<(n + 31) / 32, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      p.partial, (int)blocks, n, n_pos, p.dpos, p.dts);
  return (int)cudaGetLastError();
}

}  // namespace hstu_relbias_bwd

// Launches on `stream`; returns the launch's cudaGetLastError(). D and V are
// at most 64, NB under 65536, and the tiles and both tables with their
// gradients' sums fit the block's shared memory (the Python wrapper checks
// all three and decides the `vec_*` flags).
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
    int vec_q, int vec_k, int vec_v, int vec_do, void* stream) {
  hstu_relbias_bwd::Params<float> p{
      q, k, v, dout, dq, dk, dv, lengths, num_targets, ts, pos_w, ts_w, dpos, dts,
      B, N, H, D, V, q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh,
      do_sb, do_sn, do_sh, alpha, inv_norm, causal, max_attn_len,
      contextual_seq_len, min_full_attn_seq_len, Nm, NB, vec_q, vec_k, vec_v, vec_do};
  return hstu_relbias_bwd::launch<float>(p, stream);
}

// The bfloat16 kernel: q, k, v, dout, dk and dv bfloat16; dq32 a zeroed
// float32 [B, N, H, D] buffer for dq's sums, which a second launch writes
// into dq as bfloat16; the tables, the timestamps and their gradients
// float32. The `vec_*` flags: rows readable in 8-byte pieces.
extern "C" int hstu_mha_relbias_bwd_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const __nv_bfloat16* dout, float* dq32, __nv_bfloat16* dq, __nv_bfloat16* dk,
    __nv_bfloat16* dv, const int* lengths, const int* num_targets, const float* ts,
    const float* pos_w, const float* ts_w, float* dpos, float* dts,
    int B, int N, int H, int D, int V,
    long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn,
    long long v_sh, long long do_sb, long long do_sn, long long do_sh,
    float alpha, float inv_norm, int causal, int max_attn_len,
    int contextual_seq_len, int min_full_attn_seq_len, int Nm, int NB,
    int vec_q, int vec_k, int vec_v, int vec_do, void* stream) {
  if (alpha != 1.f) return (int)cudaErrorInvalidValue;
  hstu_relbias_bwd::Params<__nv_bfloat16> p{
      q, k, v, dout, dq32, dk, dv, lengths, num_targets, ts, pos_w, ts_w, dpos, dts,
      B, N, H, D, V, q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh,
      do_sb, do_sn, do_sh, alpha, inv_norm, causal, max_attn_len,
      contextual_seq_len, min_full_attn_seq_len, Nm, NB, vec_q, vec_k, vec_v, vec_do};
  const int err = hstu_relbias_bwd::launch<__nv_bfloat16>(p, stream);
  if (err != 0) return err;
  return (int)hstu_tf32::to_bf16(dq32, dq, (long long)B * N * H * D, static_cast<cudaStream_t>(stream));
}

// K7-det on float32: dq, dk and dv written whole; partial a float32
// [blocks, (2 Nm - 1) + (NB + 1)] scratch buffer (`launch_det`); dpos and dts
// written whole. The same bits on every run.
extern "C" int hstu_mha_relbias_bwd_det(
    const float* q, const float* k, const float* v, const float* dout,
    float* dq, float* dk, float* dv, const int* lengths,
    const int* num_targets, const float* ts, const float* pos_w,
    const float* ts_w, float* dpos, float* dts, float* partial,
    int B, int N, int H, int D, int V,
    long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn,
    long long v_sh, long long do_sb, long long do_sn, long long do_sh,
    float alpha, float inv_norm, int causal, int max_attn_len,
    int contextual_seq_len, int min_full_attn_seq_len, int Nm, int NB,
    int vec_q, int vec_k, int vec_v, int vec_do, void* stream) {
  hstu_relbias_bwd::Params<float> p{
      q, k, v, dout, nullptr, dk, dv, lengths, num_targets, ts, pos_w, ts_w, dpos, dts,
      B, N, H, D, V, q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh,
      do_sb, do_sn, do_sh, alpha, inv_norm, causal, max_attn_len,
      contextual_seq_len, min_full_attn_seq_len, Nm, NB, vec_q, vec_k, vec_v, vec_do, partial};
  return hstu_relbias_bwd::launch_det<float>(p, dq, stream);
}

// K7-det on bfloat16 q, k, v, dout, dq, dk and dv (K7-bf16's rounding
// points); alpha must be 1, as K7-bf16's.
extern "C" int hstu_mha_relbias_bwd_det_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const __nv_bfloat16* dout, __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv,
    const int* lengths, const int* num_targets, const float* ts, const float* pos_w,
    const float* ts_w, float* dpos, float* dts, float* partial,
    int B, int N, int H, int D, int V,
    long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn,
    long long v_sh, long long do_sb, long long do_sn, long long do_sh,
    float alpha, float inv_norm, int causal, int max_attn_len,
    int contextual_seq_len, int min_full_attn_seq_len, int Nm, int NB,
    int vec_q, int vec_k, int vec_v, int vec_do, void* stream) {
  if (alpha != 1.f) return (int)cudaErrorInvalidValue;
  hstu_relbias_bwd::Params<__nv_bfloat16> p{
      q, k, v, dout, nullptr, dk, dv, lengths, num_targets, ts, pos_w, ts_w, dpos, dts,
      B, N, H, D, V, q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh,
      do_sb, do_sn, do_sh, alpha, inv_norm, causal, max_attn_len,
      contextual_seq_len, min_full_attn_seq_len, Nm, NB, vec_q, vec_k, vec_v, vec_do, partial};
  return hstu_relbias_bwd::launch_det<__nv_bfloat16>(p, dq, stream);
}
