// The bfloat16 body of K3 (`hstu_mha_bwd_dq_bf16`, K3-bf16) on Hopper's
// bfloat16 tensor cores, up to D 256 and V 128 (the wide body of
// hstu_attention_wide.cuh keeps wider heads). Replaces `_bwd_dq_kernel` of
// generative_recommenders_tpu/ops/pallas/hstu_attention.py on bfloat16, at
// its rounding points:
//
//   Q = bf16(alpha q) (where alpha != 1)   dO = bf16(do bf16(1 / norm))
//   S = Q K^T   sig = sigmoid(S)   dS = bf16((dO V^T) sig (1 + S (1 - sig)) mask)
//   dQ = alpha dS K, summed in float32, written as bfloat16
//
// With K4-bf16 it is the deterministic backward of the bias-free bfloat16
// model's first block. Included at the end of hstu_attention_bwd_dq.cuh,
// whose `Params` it shares; the float32 body there is float32 only.
//
// Bound on the H100: 2 (D + V) bytes per live row and head for q and dO, the
// same for k and v, and 2 D per element of dq, or 2 D + V multiply-adds per
// live element and head at the card's bfloat16 rate (989 TFLOP/s); at
// ml-3b's and bench.py's widths the bytes bound it. The design is the
// bfloat16 forward body's (hstu_attention_fwd_bf16.cuh) turned into a dq
// pass:
// * One block per (query tile, head, batch row). `hstu_bf16::prescale` forms
//   bfloat16(alpha q) and bfloat16(dO / norm) once per call into buffers the
//   wrapper allocates; the block keeps its Q and dO tiles resident and
//   streams K and V tiles by 16-byte `cp.async` into the second of two stages
//   while this step's products run (element by element where rows cannot be
//   read in pieces of 8).
// * Each warp owns 16 query rows across the whole key tile. S = Q K^T and
//   dP = dO V^T are `mma.sync.m16n8k16` on `ldmatrix` fragments; dS, rounded
//   to bfloat16 where the TPU kernel rounds it, goes from their accumulators
//   into bfloat16 pairs in registers as the A operand of dQ += dS K, with K's
//   B fragment by `ldmatrix.trans`, as the forward hands P to P V: dS never
//   passes through shared memory, and no barrier separates the products.
// * dQ sums in float32 registers over a walk in a fixed order, with no
//   atomics: the same bits on every run, as the deterministic backward
//   needs; it takes alpha at the end and is written as bfloat16, every
//   element of the block's rows (zeros past the length).
// * Dead work is skipped as in the float32 body: a causal walk stops at the
//   key tile of the query tile's last row once the tile is past the
//   contextual rows; a warp whose part of the step holds no live element
//   skips its products, and dQ the 16-column steps past the warp's last row
//   on a causal walk. Blocks start with the long walks (a row's last query
//   tiles).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16_mma.cuh"
#include "hstu_attention.cuh"
#include "hstu_attention_bwd_dq.cuh"

namespace hstu_bwd_dq {

// Per padded width W of the bfloat16 body: warps per block (each owns 16
// query rows), key columns per step, blocks an SM; each chosen by timing the
// alternatives (ops/cuda/variants.py, PERF.md).
template <int W> struct TilingBf16;
template <> struct TilingBf16<32> { static constexpr int NW = 4, BK = 64, MINB = 4; };
template <> struct TilingBf16<64> { static constexpr int NW = 4, BK = 64, MINB = 3; };
template <> struct TilingBf16<128> { static constexpr int NW = 4, BK = 32, MINB = 2; };
template <> struct TilingBf16<256> { static constexpr int NW = 4, BK = 32, MINB = 1; };

// Q [BQ][W + 8] and dO [BQ][WV + 8], resident; two stages of K [BK][W + 8]
// and V [BK][WV + 8]; all bfloat16.
template <int W>
__host__ __device__ constexpr int smem_bytes_bf16() {
  constexpr int WV = W < 128 ? W : 128, BQ = 16 * TilingBf16<W>::NW, BK = TilingBf16<W>::BK;
  return 2 * (BQ + 2 * BK) * (W + 8 + WV + 8);
}

// W: the padded head width. `p` after the pre-scaling pass: q is
// bfloat16(alpha q) and dout bfloat16(dO / norm).
template <int W>
__global__ void __launch_bounds__(32 * TilingBf16<W>::NW, TilingBf16<W>::MINB)
    dq_bf16_kernel(Params<__nv_bfloat16> p) {
  using Tl = TilingBf16<W>;
  using bf16 = __nv_bfloat16;
  constexpr int NW = Tl::NW, BK = Tl::BK, BQ = 16 * NW, kThr = 32 * NW;
  constexpr int WV = W < 128 ? W : 128;
  constexpr int PK = W + 8;   // pitch of the Q and K tiles, in elements
  constexpr int PV = WV + 8;  // of the dO and V tiles
  constexpr int NT = BK / 8;  // 8-column tiles of S; NT / 2 k-steps of dS K
  constexpr int NQ = W / 8;   // 8-column tiles of dQ
  constexpr int STAGE = BK * (PK + PV);
  static_assert(NT % 2 == 0 && NQ % 2 == 0 && NT * 4 <= 32, "fragments two 8-column tiles at a time");
  static_assert(smem_bytes_bf16<W>() <= kMaxShared, "the tiles fit a block's shared memory");

  extern __shared__ __align__(16) float dq_bf16_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(dq_bf16_smem);  // [BQ][PK]
  bf16* dOs = Qs + BQ * PK;                          // [BQ][PV]
  bf16* stages = dOs + BQ * PV;                      // 2 x { K [BK][PK], V [BK][PV] }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // the index counts the query tile last and from the end: every row's last
  // tile (the longest walk) starts before any row's second to last
  const int n_qt = (p.N + BQ - 1) / BQ;
  const int row0 = (n_qt - 1 - (int)(blockIdx.x / ((unsigned)p.H * p.B))) * BQ;
  const int h = (int)(blockIdx.x % (unsigned)p.H);
  const int b = (int)(blockIdx.x / (unsigned)p.H) % p.B;
  const int length = min(p.lengths[b], p.N);
  const int nt = p.num_targets ? p.num_targets[b] : 0;
  const int r_first = row0 + warp * 16;  // the warp's rows: r_first .. + 16

  float acc[NQ][4];
#pragma unroll
  for (int j = 0; j < NQ; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  if (row0 < length) {
    const bf16* qb = p.q + b * p.q_sb + h * p.q_sh;
    const bf16* kb = p.k + b * p.k_sb + h * p.k_sh;
    const bf16* vb = p.v + b * p.v_sb + h * p.v_sh;
    const bf16* ob = p.dout + b * p.do_sb + h * p.do_sh;
    const bool causal = p.causal != 0;
    const int ctx = p.contextual_seq_len;
    // causal: a row past the contextual rows sees no column past itself
    const int kv_end = causal && row0 >= ctx ? min(length, row0 + BQ) : length;
    // no contextual rows, targets or window: the mask is col <= row
    const bool plain_causal = causal && ctx == 0 && nt == 0 && p.max_attn_len == 0;
    // the step's K and V tiles: key columns c0 .. + BK into stage `st`
    auto load_step = [&](int c0, int st) {
      bf16* K = stages + st * STAGE;
      hstu_bf16::load_rows<W, PK, BK, kThr>(K, kb, p.k_sn, c0, length, p.D, p.vec_k != 0);
      hstu_bf16::load_rows<WV, PV, BK, kThr>(K + BK * PK, vb, p.v_sn, c0, length, p.V, p.vec_v != 0);
    };
    hstu_bf16::load_rows<W, PK, BQ, kThr>(Qs, qb, p.q_sn, row0, length, p.D, p.vec_q != 0);
    hstu_bf16::load_rows<WV, PV, BQ, kThr>(dOs, ob, p.do_sn, row0, length, p.V, p.vec_do != 0);
    load_step(0, 0);
    cp_async_commit();

    for (int step = 0, col0 = 0; col0 < kv_end; ++step, col0 += BK) {
      const bf16* Ks = stages + (step & 1) * STAGE;
      const bf16* Vs = Ks + BK * PK;
      cp_async_wait_all();
      // this step's K and V are in place, and every warp is done with the
      // previous step's
      __syncthreads();
      if (col0 + BK < kv_end) load_step(col0 + BK, (step + 1) & 1);  // into the other stage
      cp_async_commit();

      // the mask of the warp's 16 x BK part: element e = 4 j + c is row
      // r_first + g + 8 (c / 2), column col0 + 8 j + 2 t + c % 2
      unsigned ok_bits = 0;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = r_first + g + 8 * (c >> 1);
          const int col = col0 + j * 8 + 2 * t + (c & 1);
          const bool ok =
              row < length && col < length &&
              (plain_causal ? col <= row
                            : hstu::valid_elem(row, col, length, nt, causal, p.max_attn_len, ctx,
                                               p.min_full_attn_seq_len, /*guard=*/true));
          ok_bits |= (ok ? 1u : 0u) << (4 * j + c);
        }
      // the warp's part holds no live element (above the diagonal, past the
      // length, outside a window): no products
      if (__all_sync(kFull, ok_bits == 0)) continue;

      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
#pragma unroll
      for (int ks = 0; ks < W / 16; ++ks) {
        uint32_t a[4];
        hstu_bf16::ldsm(a, hstu_bf16::a_at(Qs, PK, warp * 16, ks * 16));
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t kf[4];
          hstu_bf16::ldsm(kf, hstu_bf16::b_nk_at(Ks, PK, j * 8, ks * 16));
          hstu_bf16::mma(s[j], a, kf[0], kf[1]);
          hstu_bf16::mma(s[j + 1], a, kf[2], kf[3]);
        }
      }
#pragma unroll
      for (int ks = 0; ks < WV / 16; ++ks) {
        uint32_t a[4];
        hstu_bf16::ldsm(a, hstu_bf16::a_at(dOs, PV, warp * 16, ks * 16));
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t vf[4];
          hstu_bf16::ldsm(vf, hstu_bf16::b_nk_at(Vs, PV, j * 8, ks * 16));
          hstu_bf16::mma(dp[j], a, vf[0], vf[1]);
          hstu_bf16::mma(dp[j + 1], a, vf[2], vf[3]);
        }
      }
      // dS, 0 where masked, in bfloat16 as the TPU kernel rounds it, packed
      // as the A fragments of dQ's k-steps
      uint32_t da[NT / 2][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float ds[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float x = s[j][c];
          const float sig = __fdividef(1.f, 1.f + __expf(-x));
          ds[c] = (ok_bits >> (4 * j + c)) & 1u ? dp[j][c] * sig * (1.f + x * (1.f - sig)) : 0.f;
        }
        da[j / 2][(j & 1) * 2] = hstu_bf16::pack(ds[0], ds[1]);
        da[j / 2][(j & 1) * 2 + 1] = hstu_bf16::pack(ds[2], ds[3]);
      }
      // dQ += dS K over the 16-column steps that reach the warp's rows: on a
      // causal walk, rows past the contextual ones see no column past the
      // warp's last row
      const int kk_end = causal && r_first >= ctx ? min(NT / 2, (r_first + 15 - col0) / 16 + 1) : NT / 2;
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        if (kk < kk_end) {
#pragma unroll
          for (int n = 0; n < NQ; n += 2) {
            if (n * 8 < p.D) {  // pad columns alone
              uint32_t kf[4];
              hstu_bf16::ldsm_t(kf, hstu_bf16::b_kn_at(Ks, PK, kk * 16, n * 8));
              hstu_bf16::mma(acc[n], da[kk], kf[0], kf[1]);
              hstu_bf16::mma(acc[n + 1], da[kk], kf[2], kf[3]);
            }
          }
        }
      }
    }
  }

  // every element of the block's rows of dq is written: alpha times the
  // sums, zeros at rows past the length and where the tile is dead
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_first + g + 8 * i;
    if (row >= p.N) continue;
    const bool in = row < length;
    bf16* dst = p.dq + (((long long)b * p.N + row) * p.H + h) * p.D;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int d = j * 8 + 2 * t;
      const float x0 = in ? p.alpha * acc[j][2 * i] : 0.f;
      const float x1 = in ? p.alpha * acc[j][2 * i + 1] : 0.f;
      if (d + 1 < p.D && p.D % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(dst + d) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (d < p.D) dst[d] = __float2bfloat16_rn(x0);
        if (d + 1 < p.D) dst[d + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

template <int W>
cudaError_t launch_bf16_w(const Params<__nv_bfloat16>& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes_bf16<W>();
  constexpr int BQ = 16 * TilingBf16<W>::NW;
  auto kernel = dq_bf16_kernel<W>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((p.N + BQ - 1) / BQ) * p.H * (long long)p.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, 32 * TilingBf16<W>::NW, smem, stream>>>(p);
  return cudaGetLastError();
}

// The pre-scaling pass into the wrapper's p.qs and p.dos, then this body at
// the next of the widths 32, 64, 128 (256 for D) above D and V.
int launch_bf16(const Params<__nv_bfloat16>& p, cudaStream_t s) {
  if (p.D > 256 || p.V > 128) return (int)cudaErrorInvalidValue;
  Params<__nv_bfloat16> r = p;
  const cudaError_t err = hstu_bf16::prescale(r, s);
  if (err != cudaSuccess) return (int)err;
  const int w = p.D > p.V ? p.D : p.V;
  if (w <= 32) return (int)launch_bf16_w<32>(r, s);
  if (w <= 64) return (int)launch_bf16_w<64>(r, s);
  if (w <= 128) return (int)launch_bf16_w<128>(r, s);
  return (int)launch_bf16_w<256>(r, s);
}

}  // namespace hstu_bwd_dq
