// HSTU attention backward for Hopper (sm_90a), float32: the shared body of
// the fused kernel K2 (hstu_mha_bwd_fused.cu) and the split pair K3
// (hstu_mha_bwd_dq.cu) and K4 (hstu_mha_bwd_dkv.cu). The relative-bias
// backward K7 has a body of its own (hstu_mha_relbias_bwd.cu).
//
// Per head, with S recomputed from Q and K (the forward saves only q, k, v):
//
//   S = alpha Q K^T   sig = sigmoid(S)   P = S sig mask   dOn = dO / norm
//   dV = P^T dOn        dS = (dOn V^T) * sig (1 + S (1 - sig)) * mask
//   dK = alpha dS^T Q   dQ = alpha dS K
//
// Replaces the Pallas TPU kernels `_bwd_fused_kernel_rkv`, `_bwd_dq_kernel`
// and `_bwd_dkv_kernel` of generative_recommenders_tpu/ops/pallas/
// hstu_attention.py.
// The mask is `valid_elem` of hstu_attention.cuh with the length guard on, so
// rows and columns at or past a row's length get exact zero gradients.
//
// Design. Tiles of 32 query rows by 32 key columns; 256 threads as a 16 x 16
// grid, each thread 2 x 2 elements of a tile, float32 FMAs on shared-memory
// tiles (no tensor cores yet), as in K1.
// * K4 (dK, dV) and K2 (fused): one block per (key tile, head, batch row)
//   keeps its K and V tile in shared memory and its dK and dV rows in
//   registers, and walks the live query tiles: up to the row's length, and
//   from the key tile's own tile when causal without contextual rows
//   (earlier rows see none of its columns; contextual row 0 sees every column
//   below the target boundary, so the skip is off then). Per query tile it
//   loads Q and dOn, computes S and dP = dOn V^T, writes P and dS to shared
//   memory, and accumulates dV += P^T dOn and dK += dS^T Q.
// * K2 also forms the query tile's dQ share dS K and adds it into a zeroed
//   float32 dq buffer with atomicAdd. The TPU kernel carries dq across its
//   sequential grid steps in VMEM; Hopper's blocks run in parallel, so the
//   sums arrive in a different order on every run. Five S-sized products per
//   tile pair.
// * K3 (dQ): one block per (query tile, head, batch row) keeps Q, dOn and a
//   dQ accumulator and walks the live key tiles (the causal bound of K1's
//   kv_limit). K3 + K4 use no atomics and give the same bits on every run, at
//   seven products per tile pair.
// Every output element is written: dead tiles and rows get zeros.
//
// Bound on the H100: float32 operations outside the tensor cores. Per live
// mask element and head K2 does 2 (3D + 2V) flops, K3 2 (2D + V), K4
// 2 (2D + 2V): 1280, 768 and 1024 at D = V = 128, against 4 (D + V) bytes
// of q, k, v and dO per live row, so the flops set the least time (PERF.md
// has the times against it).
#pragma once

#include <cuda_runtime.h>

#include "hstu_attention.cuh"

namespace hstu_bwd {

constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kT = 32;         // query rows and key columns per tile
constexpr int kTp = kT + 1;    // pitch of the P and dS tiles

enum Kind { kFused = 0, kDq = 1, kDkv = 2 };

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  float* dq;  // contiguous [B, N, H, D]; K2: a zeroed accumulation buffer
  float* dk;  // contiguous [B, N, H, D]
  float* dv;  // contiguous [B, N, H, V]
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

// Q and K tiles [32][dw + 1], dO and V tiles [32][vw + 1], P and dS [32][33];
// the odd pitches put a column's reads on distinct banks.
__host__ __device__ constexpr int smem_floats(int dw, int vw) {
  return 2 * kT * (dw + 1) + 2 * kT * (vw + 1) + 2 * kT * kTp;
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

// S and dP = dOn V^T for the tile pair at (row0, col0); writes dS, and P when
// WANT_P, to shared memory. Masked elements get exact zeros.
template <bool WANT_P>
__device__ __forceinline__ void tile_scores(const Params& p, const float* Qs,
                                            const float* Ks, const float* dOs,
                                            const float* Vs, float* Ps, float* dSs,
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
      if (WANT_P) Ps[at] = ok ? x * sig : 0.f;
      const float ds = ok ? g[i][j] * sig * (1.f + x * (1.f - sig)) : 0.f;
      dSs[at] = ds;
    }
  }
}

// dV += P^T dOn and dK += dS^T Q over the first `rows` rows of the query
// tile; the thread owns key rows {ty, ty + 16} and columns tx + 16 j.
template <int DT, int VT>
__device__ __forceinline__ void accumulate_dkv(const float* Qs, const float* dOs,
                                               const float* Ps, const float* dSs,
                                               float (&dk)[2][DT], float (&dv)[2][VT],
                                               int rows) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  constexpr int dpitch = 16 * DT + 1, vpitch = 16 * VT + 1;
#pragma unroll 2
  for (int r = 0; r < rows; ++r) {
    const float p0 = Ps[r * kTp + ty], p1 = Ps[r * kTp + ty + 16];
    const float s0 = dSs[r * kTp + ty], s1 = dSs[r * kTp + ty + 16];
#pragma unroll
    for (int j = 0; j < VT; ++j) {
      const float o = dOs[r * vpitch + tx + 16 * j];
      dv[0][j] = fmaf(p0, o, dv[0][j]);
      dv[1][j] = fmaf(p1, o, dv[1][j]);
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const float qq = Qs[r * dpitch + tx + 16 * j];
      dk[0][j] = fmaf(s0, qq, dk[0][j]);
      dk[1][j] = fmaf(s1, qq, dk[1][j]);
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

// K2 (FUSED) and K4: one block per (key tile, head, batch row).
template <int DT, int VT, bool FUSED>
__global__ void __launch_bounds__(kThreads) dkv_kernel(Params p) {
  constexpr int DW = 16 * DT, VW = 16 * VT;
  extern __shared__ float smem[];
  float* Qs = smem;                  // [32][DW + 1]
  float* Ks = Qs + kT * (DW + 1);    // [32][DW + 1]
  float* dOs = Ks + kT * (DW + 1);   // [32][VW + 1]
  float* Vs = dOs + kT * (VW + 1);   // [32][VW + 1]
  float* Ps = Vs + kT * (VW + 1);    // [32][33]
  float* dSs = Ps + kT * kTp;        // [32][33]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int col0 = blockIdx.x * kT;
  const int length = min(p.lengths[b], p.N);
  const int nt = p.num_targets ? p.num_targets[b] : 0;

  float dk[2][DT], dv[2][VT];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < DT; ++j) dk[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < VT; ++j) dv[i][j] = 0.f;
  }

  if (col0 < length) {
    const float* qb = p.q + b * p.q_sb + h * p.q_sh;
    const float* kb = p.k + b * p.k_sb + h * p.k_sh;
    const float* vb = p.v + b * p.v_sb + h * p.v_sh;
    const float* ob = p.dout + b * p.do_sb + h * p.do_sh;
    load_tile(Ks, DW, kb, p.k_sn, col0, p.N, p.D, 1.f);
    load_tile(Vs, VW, vb, p.v_sn, col0, p.N, p.V, 1.f);
    const int row_first =
        (p.causal != 0 && p.contextual_seq_len == 0) ? col0 : 0;
    for (int row0 = row_first; row0 < length; row0 += kT) {
      __syncthreads();  // the previous tile's products are done with the tiles
      load_tile(Qs, DW, qb, p.q_sn, row0, p.N, p.D, 1.f);
      load_tile(dOs, VW, ob, p.do_sn, row0, p.N, p.V, p.inv_norm);
      __syncthreads();
      tile_scores<true>(p, Qs, Ks, dOs, Vs, Ps, dSs, DW, VW, row0, col0, length, nt);
      __syncthreads();
      accumulate_dkv<DT, VT>(Qs, dOs, Ps, dSs, dk, dv, min(kT, length - row0));
      if (FUSED) {
        float dq[2][DT];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < DT; ++j) dq[i][j] = 0.f;
        accumulate_dq<DT>(Ks, dSs, dq, min(kT, length - col0));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = row0 + ty + 16 * i;
          if (r >= length) continue;  // dead rows keep the buffer's zeros
          float* dqr = p.dq + (((long long)b * p.N + r) * p.H + h) * p.D;
#pragma unroll
          for (int j = 0; j < DT; ++j) {
            const int d = tx + 16 * j;
            if (d < p.D) atomicAdd(dqr + d, p.alpha * dq[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = col0 + ty + 16 * i;
    if (c >= p.N) continue;
    float* dkr = p.dk + (((long long)b * p.N + c) * p.H + h) * p.D;
    float* dvr = p.dv + (((long long)b * p.N + c) * p.H + h) * p.V;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int d = tx + 16 * j;
      if (d < p.D) dkr[d] = p.alpha * dk[i][j];
    }
#pragma unroll
    for (int j = 0; j < VT; ++j) {
      const int e = tx + 16 * j;
      if (e < p.V) dvr[e] = dv[i][j];
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
  float* dSs = Vs + kT * (VW + 1) + kT * kTp;  // same layout as dkv_kernel

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
      tile_scores<false>(p, Qs, Ks, dOs, Vs, nullptr, dSs, DW, VW, row0, col0, length, nt);
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

template <Kind KIND, int DT, int VT>
cudaError_t launch_dv(const Params& p, cudaStream_t stream) {
  const int smem = smem_floats(16 * DT, 16 * VT) * (int)sizeof(float);
  void (*kernel)(Params);
  if constexpr (KIND == kDq) {
    kernel = dq_kernel<DT, VT>;
  } else {
    kernel = dkv_kernel<DT, VT, KIND == kFused>;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.N + kT - 1) / kT, p.H, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <Kind KIND, int DT>
cudaError_t launch_d(const Params& p, cudaStream_t stream) {
  if (p.V < 1) return cudaErrorInvalidValue;
  if (p.V <= 16) return launch_dv<KIND, DT, 1>(p, stream);
  if (p.V <= 32) return launch_dv<KIND, DT, 2>(p, stream);
  if (p.V <= 64) return launch_dv<KIND, DT, 4>(p, stream);
  if (p.V <= 128) return launch_dv<KIND, DT, 8>(p, stream);
  return cudaErrorInvalidValue;
}

// Launches on `stream`; returns the launch's cudaGetLastError(). V is at
// most 128 and D at most 256 (the Python wrapper checks both); both are
// padded with zero columns to the next of 16, 32, 64, 128 (256 for D).
template <Kind KIND>
int launch(const Params& p, void* stream) {
  if (p.B == 0 || p.N == 0 || p.H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.D < 1) return (int)cudaErrorInvalidValue;
  if (p.D <= 16) return (int)launch_d<KIND, 1>(p, s);
  if (p.D <= 32) return (int)launch_d<KIND, 2>(p, s);
  if (p.D <= 64) return (int)launch_d<KIND, 4>(p, s);
  if (p.D <= 128) return (int)launch_d<KIND, 8>(p, s);
  if (p.D <= 256) return (int)launch_d<KIND, 16>(p, s);
  return (int)cudaErrorInvalidValue;
}

// The C entry points' common signature (the wrapper passes null for the
// outputs a kernel does not write).
#define HSTU_BWD_ENTRY(NAME, KIND)                                              \
  extern "C" int NAME(                                                          \
      const float* q, const float* k, const float* v, const float* dout,       \
      float* dq, float* dk, float* dv, const int* lengths,                      \
      const int* num_targets, int B, int N, int H, int D, int V,                \
      long long q_sb, long long q_sn, long long q_sh, long long k_sb,           \
      long long k_sn, long long k_sh, long long v_sb, long long v_sn,           \
      long long v_sh, long long do_sb, long long do_sn, long long do_sh,        \
      float alpha, float inv_norm, int causal, int max_attn_len,                \
      int contextual_seq_len, int min_full_attn_seq_len, void* stream) {        \
    hstu_bwd::Params p{q, k, v, dout, dq, dk, dv, lengths, num_targets,         \
                       B, N, H, D, V, q_sb, q_sn, q_sh, k_sb, k_sn, k_sh,       \
                       v_sb, v_sn, v_sh, do_sb, do_sn, do_sh, alpha, inv_norm,  \
                       causal, max_attn_len, contextual_seq_len,                \
                       min_full_attn_seq_len};                                  \
    return hstu_bwd::launch<KIND>(p, stream);                                   \
  }

}  // namespace hstu_bwd
