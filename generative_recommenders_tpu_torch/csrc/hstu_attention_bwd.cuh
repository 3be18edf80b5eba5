// HSTU attention backward for Hopper (sm_90a), float32: the body of K3
// (hstu_mha_bwd_dq.cu), dQ alone, which with K4 (hstu_mha_bwd_dkv.cu) makes
// the deterministic split backward. K2 and K4 have a body of their own on the
// tensor cores (hstu_attention_bwd_dkv.cuh), as the relative-bias backward K7
// has (hstu_mha_relbias_bwd.cu).
//
// Per head, with S recomputed from Q and K (the forward saves only q, k, v):
//
//   S = alpha Q K^T   sig = sigmoid(S)   dOn = dO / norm
//   dS = (dOn V^T) * sig (1 + S (1 - sig)) * mask   dQ = alpha dS K
//
// Replaces the Pallas TPU kernel `_bwd_dq_kernel` of
// generative_recommenders_tpu/ops/pallas/hstu_attention.py.
// The mask is `valid_elem` of hstu_attention.cuh with the length guard on, so
// rows at or past a row's length get exact zero gradients.
//
// Design. Tiles of 32 query rows by 32 key columns; 256 threads as a 16 x 16
// grid, each thread 2 x 2 elements of a tile, float32 FMAs on shared-memory
// tiles (no tensor cores yet). One block per (query tile, head, batch row)
// keeps Q, dOn and a dQ accumulator and walks the live key tiles (the causal
// bound of K1's kv_limit): per key tile it loads K and V, computes S and
// dP = dOn V^T, writes dS to shared memory and accumulates dQ += dS K. No
// atomics: the same bits on every run. Every output element is written: dead
// tiles and rows get zeros.
//
// Bound on the H100: float32 operations outside the tensor cores. Per live
// mask element and head K3 does 2 (2D + V) flops, 768 at D = V = 128, against
// 4 (D + V) bytes of q, k, v and dO per live row, so the flops set the least
// time (PERF.md has the times against it).
#pragma once

#include <cuda_runtime.h>

#include "hstu_attention.cuh"

namespace hstu_bwd {

constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kT = 32;         // query rows and key columns per tile
constexpr int kTp = kT + 1;    // pitch of the dS tile

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  float* dq;  // contiguous [B, N, H, D]
  const int* lengths;      // int32 [B]
  const int* num_targets;  // int32 [B] or null (no targets)
  int B, N, H, D, V;
  long long q_sb, q_sn, q_sh;
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  long long do_sb, do_sn, do_sh;
  float alpha, inv_norm;
  int causal, max_attn_len, contextual_seq_len, min_full_attn_seq_len;
};

// Q and K tiles [32][dw + 1], dO and V tiles [32][vw + 1], dS [32][33]; the
// odd pitches put a column's reads on distinct banks.
__host__ __device__ constexpr int smem_floats(int dw, int vw) {
  return 2 * kT * (dw + 1) + 2 * kT * (vw + 1) + kT * kTp;
}

// Rows [r0, r0 + 32) of one head of a strided [.., N, H, w] tensor, times
// `scale`, into a [32][w_pad + 1] shared tile; zero past N and in the pad
// columns [w, w_pad).
__device__ __forceinline__ void load_tile(float* dst, int w_pad, const float* src,
                                          long long sn, int r0, int N, int w,
                                          float scale) {
  const int pitch = w_pad + 1;
  for (int idx = threadIdx.x; idx < kT * w_pad; idx += kThreads) {
    const int r = idx / w_pad, c = idx - r * w_pad;
    const int n = r0 + r;
    dst[r * pitch + c] = (n < N && c < w) ? src[n * sn + c] * scale : 0.f;
  }
}

// S and dP = dOn V^T for the tile pair at (row0, col0); writes dS to shared
// memory. Masked elements get exact zeros.
__device__ __forceinline__ void tile_scores(const Params& p, const float* Qs,
                                            const float* Ks, const float* dOs,
                                            const float* Vs, float* dSs,
                                            int dw, int vw, int row0, int col0,
                                            int length, int nt) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int dpitch = dw + 1, vpitch = vw + 1;
  float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float g[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
  for (int d = 0; d < p.D; ++d) {
    const float q0 = Qs[ty * dpitch + d], q1 = Qs[(ty + 16) * dpitch + d];
    const float k0 = Ks[tx * dpitch + d], k1 = Ks[(tx + 16) * dpitch + d];
    s[0][0] = fmaf(q0, k0, s[0][0]);
    s[0][1] = fmaf(q0, k1, s[0][1]);
    s[1][0] = fmaf(q1, k0, s[1][0]);
    s[1][1] = fmaf(q1, k1, s[1][1]);
  }
#pragma unroll 4
  for (int e = 0; e < p.V; ++e) {
    const float o0 = dOs[ty * vpitch + e], o1 = dOs[(ty + 16) * vpitch + e];
    const float v0 = Vs[tx * vpitch + e], v1 = Vs[(tx + 16) * vpitch + e];
    g[0][0] = fmaf(o0, v0, g[0][0]);
    g[0][1] = fmaf(o0, v1, g[0][1]);
    g[1][0] = fmaf(o1, v0, g[1][0]);
    g[1][1] = fmaf(o1, v1, g[1][1]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = row0 + ty + 16 * i, c = col0 + tx + 16 * j;
      const bool ok =
          r < length && c < length &&
          hstu::valid_elem(r, c, length, nt, p.causal != 0, p.max_attn_len,
                           p.contextual_seq_len, p.min_full_attn_seq_len,
                           /*guard=*/true);
      const float x = s[i][j] * p.alpha;
      const float sig = 1.f / (1.f + expf(-x));
      const int at = (ty + 16 * i) * kTp + tx + 16 * j;
      const float ds = ok ? g[i][j] * sig * (1.f + x * (1.f - sig)) : 0.f;
      dSs[at] = ds;
    }
  }
}

// dQ += dS K over the first `cols` columns of the key tile; the thread owns
// query rows {ty, ty + 16} and columns tx + 16 j.
template <int DT>
__device__ __forceinline__ void accumulate_dq(const float* Ks, const float* dSs,
                                              float (&dq)[2][DT], int cols) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  constexpr int dpitch = 16 * DT + 1;
#pragma unroll 2
  for (int c = 0; c < cols; ++c) {
    const float s0 = dSs[ty * kTp + c], s1 = dSs[(ty + 16) * kTp + c];
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const float kk = Ks[c * dpitch + tx + 16 * j];
      dq[0][j] = fmaf(s0, kk, dq[0][j]);
      dq[1][j] = fmaf(s1, kk, dq[1][j]);
    }
  }
}

// K3: one block per (query tile, head, batch row).
template <int DT, int VT>
__global__ void __launch_bounds__(kThreads) dq_kernel(Params p) {
  constexpr int DW = 16 * DT, VW = 16 * VT;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kT * (DW + 1);
  float* dOs = Ks + kT * (DW + 1);
  float* Vs = dOs + kT * (VW + 1);
  float* dSs = Vs + kT * (VW + 1);

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = blockIdx.x * kT;
  const int length = min(p.lengths[b], p.N);
  const int nt = p.num_targets ? p.num_targets[b] : 0;

  float dq[2][DT];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < DT; ++j) dq[i][j] = 0.f;

  if (row0 < length) {
    const float* qb = p.q + b * p.q_sb + h * p.q_sh;
    const float* kb = p.k + b * p.k_sb + h * p.k_sh;
    const float* vb = p.v + b * p.v_sb + h * p.v_sh;
    const float* ob = p.dout + b * p.do_sb + h * p.do_sh;
    load_tile(Qs, DW, qb, p.q_sn, row0, p.N, p.D, 1.f);
    load_tile(dOs, VW, ob, p.do_sn, row0, p.N, p.V, p.inv_norm);
    int kv_limit = length;
    if (p.causal != 0 && p.contextual_seq_len == 0) kv_limit = min(kv_limit, row0 + kT);
    for (int col0 = 0; col0 < kv_limit; col0 += kT) {
      __syncthreads();  // the previous tile's product is done with Ks and dSs
      load_tile(Ks, DW, kb, p.k_sn, col0, p.N, p.D, 1.f);
      load_tile(Vs, VW, vb, p.v_sn, col0, p.N, p.V, 1.f);
      __syncthreads();
      tile_scores(p, Qs, Ks, dOs, Vs, dSs, DW, VW, row0, col0, length, nt);
      __syncthreads();
      accumulate_dq<DT>(Ks, dSs, dq, min(kT, length - col0));
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= p.N) continue;
    float* dqr = p.dq + (((long long)b * p.N + r) * p.H + h) * p.D;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int d = tx + 16 * j;
      if (d < p.D) dqr[d] = p.alpha * dq[i][j];
    }
  }
}

template <int DT, int VT>
cudaError_t launch_dv(const Params& p, cudaStream_t stream) {
  const int smem = smem_floats(16 * DT, 16 * VT) * (int)sizeof(float);
  void (*kernel)(Params) = dq_kernel<DT, VT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.N + kT - 1) / kT, p.H, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DT>
cudaError_t launch_d(const Params& p, cudaStream_t stream) {
  if (p.V < 1) return cudaErrorInvalidValue;
  if (p.V <= 16) return launch_dv<DT, 1>(p, stream);
  if (p.V <= 32) return launch_dv<DT, 2>(p, stream);
  if (p.V <= 64) return launch_dv<DT, 4>(p, stream);
  if (p.V <= 128) return launch_dv<DT, 8>(p, stream);
  return cudaErrorInvalidValue;
}

// Launches on `stream`; returns the launch's cudaGetLastError(). V is at
// most 128 and D at most 256 (the Python wrapper checks both); both are
// padded with zero columns to the next of 16, 32, 64, 128 (256 for D).
inline int launch(const Params& p, void* stream) {
  if (p.B == 0 || p.N == 0 || p.H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.D < 1) return (int)cudaErrorInvalidValue;
  if (p.D <= 16) return (int)launch_d<1>(p, s);
  if (p.D <= 32) return (int)launch_d<2>(p, s);
  if (p.D <= 64) return (int)launch_d<4>(p, s);
  if (p.D <= 128) return (int)launch_d<8>(p, s);
  if (p.D <= 256) return (int)launch_d<16>(p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace hstu_bwd
