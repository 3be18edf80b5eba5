// The bfloat16 backward body of K2 and K4 (`hstu_mha_bwd_fused_bf16`,
// `hstu_mha_bwd_dkv_bf16`) on Hopper's bfloat16 tensor cores, up to D 256
// and V 128 (the wide bodies of hstu_attention_wide.cuh keep wider heads).
// The function and the rounding points are those of the TPU kernels on
// bfloat16 (`_bwd_fused_kernel_rkv`, `_bwd_dkv_kernel`):
//
//   Q = bf16(alpha q) (where alpha != 1)   dO = bf16(do bf16(1 / norm))
//   S = Q K^T   sig = sigmoid(S)   P = bf16(S sig mask)
//   dS = bf16((dO V^T) sig (1 + S (1 - sig)) mask)
//   dV = P^T dO   dK = dS^T Q   dQ = alpha dS K (K2 only)
//
// every product from bfloat16 operands into float32 sums; dk and dv written
// as bfloat16, K2's dq added into a float32 buffer (which the entry point
// writes as bfloat16). The design is the float32 body's
// (hstu_attention_bwd_dkv.cuh: a block per key tile, head and batch row
// keeps K and V resident and walks the live query tiles) on bfloat16:
// * Raw tiles streamed. `prescale_kernel` forms bfloat16(alpha q) and
//   bfloat16(dO / norm) once per call, into contiguous buffers that the
//   wrapper allocates; the walk then streams Q and dO tiles by 16-byte
//   `cp.async` into the second of two stages while this step's products run
//   (element by element where the rows cannot be read in pieces of 8).
// * The five (K2) or four (K4) products are `mma.sync.m16n8k16` on the
//   bfloat16 tensor cores, on `ldmatrix` fragments: S and dP from Q, K, dO
//   and V as stored; dV and dK with P^T and dS^T by `ldmatrix.trans`, and dO
//   and Q as their B operands by `ldmatrix.trans`; dQ with K by
//   `ldmatrix.trans`. P and dS cross the block as bfloat16 tiles, half the
//   float32 body's shared bytes.
// * dk and dv sum the walk in a fixed order with no atomics: the same bits on
//   every run; K2's dq is summed with atomics, as in the float32 body.
// Bound on the H100: 2 (2 D + 2 V) bytes per live row and head for q, k, v
// and dO and 2 (D + V) per element of dk and dv (K2: 2 D more for dq and 8 D
// for its float32 buffer), or 2 (3 D + 2 V) (K2) / 2 (2 D + 2 V) (K4)
// multiply-adds per live element and head at 989 TFLOP/s.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16_mma.cuh"
#include "hstu_attention.cuh"
#include "hstu_attention_bwd_dkv.cuh"

namespace hstu_bwd_dkv {

// Per padded width W of the bfloat16 body: query rows per step (BQ), key
// columns per block (BK), 8-column output tiles of dV / dK a warp sums side
// by side (NG), warps (NW), blocks an SM (MINB); each chosen by timing the
// alternatives (ops/cuda/variants.py, PERF.md).
template <int W> struct TilingBf16;
template <> struct TilingBf16<32> { static constexpr int BQ = 64, BK = 64, NG = 2, NW = 8, MINB = 2; };
template <> struct TilingBf16<64> { static constexpr int BQ = 128, BK = 64, NG = 4, NW = 16, MINB = 1; };
template <> struct TilingBf16<128> { static constexpr int BQ = 32, BK = 64, NG = 4, NW = 8, MINB = 2; };
template <> struct TilingBf16<256> { static constexpr int BQ = 32, BK = 64, NG = 4, NW = 8, MINB = 1; };

// K [BK][W + 8] and V [BK][WV + 8], resident; two stages of Q [BQ][W + 8] and
// dO [BQ][WV + 8]; P and dS [BQ][BK + 8], all bfloat16; the step's live flags
// of the 16-row groups of the query tile and the 8-column groups of the key
// tile.
template <int W>
__host__ __device__ constexpr int smem_bytes_bf16() {
  constexpr int WV = W < 128 ? W : 128, BQ = TilingBf16<W>::BQ, BK = TilingBf16<W>::BK;
  return 2 * ((BK + 2 * BQ) * (W + 8 + WV + 8) + 2 * BQ * (BK + 8)) + 4 * (BQ / 16 + BK / 8);
}

// W: the padded head width; FUSED: K2 (dQ too).
template <int W, bool FUSED>
__global__ void __launch_bounds__(32 * TilingBf16<W>::NW, TilingBf16<W>::MINB)
    dkv_bf16_kernel(Params<__nv_bfloat16> p) {
  using T = TilingBf16<W>;
  using bf16 = __nv_bfloat16;
  constexpr int BQ = T::BQ, BK = T::BK, NG = T::NG, NW = T::NW, kThr = 32 * NW;
  constexpr int WV = W < 128 ? W : 128;
  constexpr int PK = W + 8;   // pitch of the Q and K tiles, in elements
  constexpr int PV = WV + 8;  // of the dO and V tiles
  constexpr int PS = BK + 8;  // of P and dS
  constexpr int STAGE = BQ * (PK + PV);
  // S and dP: a warp owns 16 query rows and NA 8-column tiles of the key tile
  constexpr int CA = NW / (BQ / 16), NA = BK / 8 / CA;
  // dV and dK side by side, one [BK][WV + W] output: a warp owns 16 key rows
  // and GB groups of NG 8-column tiles
  constexpr int CB = NW / (BK / 16), NVT = WV / 8, GB = (NVT + W / 8) / NG / CB;
  // dQ: a warp owns S's 16 query rows and NQ 8-column tiles
  constexpr int NQ = W / 8 / CA;
  static_assert(NA >= 2 && NA % 2 == 0 && NA * CA * 8 == BK, "S's columns split evenly over the warps");
  static_assert(GB >= 1 && GB * NG * CB == NVT + W / 8 && NVT % NG == 0 && NG % 2 == 0,
                "dV's and dK's columns split evenly over the warps");
  static_assert(NQ >= 2 && NQ % 2 == 0 && NQ * CA * 8 == W, "dQ's columns split evenly over the warps");
  static_assert(smem_bytes_bf16<W>() <= kMaxShared, "the tiles fit a block's shared memory");

  extern __shared__ __align__(16) float dkv_bf16_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(dkv_bf16_smem);  // [BK][PK]
  bf16* Vs = Ks + BK * PK;                            // [BK][PV]
  bf16* stages = Vs + BK * PV;                        // 2 x { Q [BQ][PK], dO [BQ][PV] }
  bf16* Ps = stages + 2 * STAGE;                      // [BQ][PS]
  bf16* dSs = Ps + BQ * PS;                           // [BQ][PS]
  int* row_live = reinterpret_cast<int*>(dSs + BQ * PS);  // [BQ / 16]
  int* col_live = row_live + BQ / 16;                      // [BK / 8]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp / CA, wc = warp % CA;  // S, dP, dQ: query rows wr 16 .. + 16
  const int am = warp / CB, ac = warp % CB;  // dV, dK: key rows am 16 .. + 16
  // the index counts the key tile last: every row's first tile (the longest
  // walk) starts before any row's second
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
    const bf16* qb = p.q + b * p.q_sb + h * p.q_sh;
    const bf16* kb = p.k + b * p.k_sb + h * p.k_sh;
    const bf16* vb = p.v + b * p.v_sb + h * p.v_sh;
    const bf16* ob = p.dout + b * p.do_sb + h * p.do_sh;
    const bool causal = p.causal != 0;
    const int ctx = p.contextual_seq_len;
    // causal: the query tiles of the contextual rows, then those from the
    // key tile's own on
    const int ctx_end = causal ? (ctx + BQ - 1) / BQ * BQ : 0;
    auto skip_to_diagonal = [&](int r) { return causal && r >= ctx_end && r < col0 ? col0 : r; };
    // no contextual rows, targets or window: the mask is col <= row
    const bool plain_causal = causal && ctx == 0 && nt == 0 && p.max_attn_len == 0;
    const int col_steps = (min(BK, length - col0) + 15) / 16;  // 16-column steps of the key tile
    // the step's Q and dO tiles: query rows r0 .. + BQ into stage `st`
    auto load_step = [&](int r0, int st) {
      bf16* Q = stages + st * STAGE;
      hstu_bf16::load_rows<W, PK, BQ, kThr>(Q, qb, p.q_sn, r0, length, p.D, p.vec_q != 0);
      hstu_bf16::load_rows<WV, PV, BQ, kThr>(Q + BQ * PK, ob, p.do_sn, r0, length, p.V, p.vec_do != 0);
    };
    hstu_bf16::load_rows<W, PK, BK, kThr>(Ks, kb, p.k_sn, col0, length, p.D, p.vec_k != 0);
    hstu_bf16::load_rows<WV, PV, BK, kThr>(Vs, vb, p.v_sn, col0, length, p.V, p.vec_v != 0);
    int row0 = skip_to_diagonal(0);
    load_step(row0, 0);
    cp_async_commit();
    // both flag arrays; a flag holds step + 1 where the step has a live element there
    if (threadIdx.x < BQ / 16 + BK / 8) row_live[threadIdx.x] = 0;

    for (int step = 0; row0 < length; ++step) {
      const int next = skip_to_diagonal(row0 + BQ);
      const bf16* Qs = stages + (step & 1) * STAGE;
      const bf16* dOs = Qs + BQ * PK;
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
        // the warp's part holds no live element: no products, no sigmoid,
        // zeros to P and dS
        const bool dead = __all_sync(kFull, ok_bits == 0);
        float s[NA][4], dp[NA][4];
#pragma unroll
        for (int j = 0; j < NA; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
        if (!dead) {
#pragma unroll
          for (int ks = 0; ks < W / 16; ++ks) {
            uint32_t a[4];
            hstu_bf16::ldsm(a, hstu_bf16::a_at(Qs, PK, wr * 16, ks * 16));
#pragma unroll
            for (int j = 0; j < NA; j += 2) {
              uint32_t kf[4];
              hstu_bf16::ldsm(kf, hstu_bf16::b_nk_at(Ks, PK, (wc * NA + j) * 8, ks * 16));
              hstu_bf16::mma(s[j], a, kf[0], kf[1]);
              hstu_bf16::mma(s[j + 1], a, kf[2], kf[3]);
            }
          }
#pragma unroll
          for (int ks = 0; ks < WV / 16; ++ks) {
            uint32_t a[4];
            hstu_bf16::ldsm(a, hstu_bf16::a_at(dOs, PV, wr * 16, ks * 16));
#pragma unroll
            for (int j = 0; j < NA; j += 2) {
              uint32_t vf[4];
              hstu_bf16::ldsm(vf, hstu_bf16::b_nk_at(Vs, PV, (wc * NA + j) * 8, ks * 16));
              hstu_bf16::mma(dp[j], a, vf[0], vf[1]);
              hstu_bf16::mma(dp[j + 1], a, vf[2], vf[3]);
            }
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
              const float x = s[j][c];
              const float sig = __fdividef(1.f, 1.f + __expf(-x));
              pv[c] = x * sig;
              ds[c] = dp[j][c] * sig * (1.f + x * (1.f - sig));
            }
          }
          // the products take P and dS in bfloat16
          const int at = (wr * 16 + g) * PS + (wc * NA + j) * 8 + 2 * t;
          *reinterpret_cast<uint32_t*>(Ps + at) = hstu_bf16::pack(pv[0], pv[1]);
          *reinterpret_cast<uint32_t*>(Ps + at + 8 * PS) = hstu_bf16::pack(pv[2], pv[3]);
          *reinterpret_cast<uint32_t*>(dSs + at) = hstu_bf16::pack(ds[0], ds[1]);
          *reinterpret_cast<uint32_t*>(dSs + at + 8 * PS) = hstu_bf16::pack(ds[2], ds[3]);
          const bool any = __any_sync(kFull, ((ok_bits >> (4 * j)) & 0xfu) != 0);
          if (any && lane == 0) col_live[wc * NA + j] = live;
        }
      }
      __syncthreads();  // P, dS and the flags are whole

      // dV += P^T dO and dK += dS^T Q for the warp's key rows, if a live
      // element of the tile pair reaches them; on a causal walk the steps of
      // the contextual rows, then those from the warp's first key row on
      if (col_live[2 * am] == live || col_live[2 * am + 1] == live) {
        const int row_steps = (min(BQ, length - row0) + 15) / 16;
        int ctx_steps = row_steps, first = 0;
        if (causal) {
          ctx_steps = row0 < ctx ? (min(ctx - row0, BQ) + 15) / 16 : 0;
          first = max(col0 + am * 16 - row0, 0) / 16;
        }
        auto next_step = [&](int ks) { return ks >= ctx_steps && ks < first ? first : ks; };
#pragma unroll
        for (int gi = 0; gi < GB; ++gi) {
          const int tile = (ac * GB + gi) * NG;  // the group's first 8-column tile of [dV | dK]
          const bool is_dv = tile < NVT;
          const int n0 = 8 * (is_dv ? tile : tile - NVT);
          if (n0 >= (is_dv ? p.V : p.D)) continue;  // pad columns alone
          const bf16* A = is_dv ? Ps : dSs;
          const bf16* Bm = is_dv ? dOs : Qs;
          const int pitch = is_dv ? PV : PK;
          for (int ks = next_step(0); ks < row_steps; ks = next_step(ks + 1)) {
            uint32_t a[4];
            hstu_bf16::ldsm_t(a, hstu_bf16::a_t_at(A, PS, am * 16, ks * 16));
#pragma unroll
            for (int n = 0; n < NG; n += 2) {
              uint32_t bf[4];
              hstu_bf16::ldsm_t(bf, hstu_bf16::b_kn_at(Bm, pitch, ks * 16, n0 + n * 8));
              hstu_bf16::mma(acc[gi * NG + n], a, bf[0], bf[1]);
              hstu_bf16::mma(acc[gi * NG + n + 1], a, bf[2], bf[3]);
            }
          }
        }
      }

      // K2: dQ = dS K for the warp's query rows, if a live element reaches
      // them, and its NQ 8-column tiles; on a causal walk rows past the
      // contextual ones see no column past the warp's last row
      if (FUSED && row_live[wr] == live) {
        const int r_first = row0 + wr * 16;
        const int my_col_steps =
            causal && r_first >= ctx ? min(col_steps, (r_first + 15 - col0) / 16 + 1) : col_steps;
        float dq[NQ][4];
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) dq[j][c] = 0.f;
        for (int ks = 0; ks < my_col_steps; ++ks) {
          uint32_t a[4];
          hstu_bf16::ldsm(a, hstu_bf16::a_at(dSs, PS, wr * 16, ks * 16));
#pragma unroll
          for (int j = 0; j < NQ; j += 2) {
            uint32_t kf[4];
            hstu_bf16::ldsm_t(kf, hstu_bf16::b_kn_at(Ks, PK, ks * 16, (wc * NQ + j) * 8));
            hstu_bf16::mma(dq[j], a, kf[0], kf[1]);
            hstu_bf16::mma(dq[j + 1], a, kf[2], kf[3]);
          }
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
              if (row < length && d < p.D) atomicAdd(dqh + (long long)row * p.H * p.D + d, p.alpha * dq[j][c]);
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
    bf16* out = is_dv ? p.dv : p.dk;
    const int width = is_dv ? p.V : p.D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int col = col0 + am * 16 + g + 8 * i;
      if (col >= p.N) continue;
      bf16* dst = out + (((long long)b * p.N + col) * p.H + h) * width;
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        const int d = n0 + n * 8 + 2 * t;
        const float x0 = acc[gi * NG + n][2 * i], x1 = acc[gi * NG + n][2 * i + 1];
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

template <int W, bool FUSED>
cudaError_t launch_bf16_w(const Params<__nv_bfloat16>& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes_bf16<W>();
  auto kernel = dkv_bf16_kernel<W, FUSED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((p.N + TilingBf16<W>::BK - 1) / TilingBf16<W>::BK) * p.H * (long long)p.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, 32 * TilingBf16<W>::NW, smem, stream>>>(p);
  return cudaGetLastError();
}

// The pre-scaling pass (`hstu_bf16::prescale`), then this body at the next of
// the widths 32, 64, 128 (256 for D) above D and V. The wrapper's buffers: qs
// [B, N, H, D] for bfloat16(alpha q) (null where alpha is 1: q is read as it
// is), dos [B, N, H, V] for bfloat16(dO / norm).
template <bool FUSED>
int launch_bf16(const Params<__nv_bfloat16>& p, cudaStream_t s) {
  if (p.D > 256 || p.V > 128) return (int)cudaErrorInvalidValue;
  Params<__nv_bfloat16> r = p;
  const cudaError_t err = hstu_bf16::prescale(r, s);
  if (err != cudaSuccess) return (int)err;
  const int w = p.D > p.V ? p.D : p.V;
  if (w <= 32) return (int)launch_bf16_w<32, FUSED>(r, s);
  if (w <= 64) return (int)launch_bf16_w<64, FUSED>(r, s);
  if (w <= 128) return (int)launch_bf16_w<128, FUSED>(r, s);
  return (int)launch_bf16_w<256, FUSED>(r, s);
}

}  // namespace hstu_bwd_dkv
