// HSTU attention forward for Hopper (sm_90a), float32: the shared body of
// the dense kernel K1 (hstu_mha_fwd.cu) and the M-FALCON delta kernel K5
// (delta_hstu_mha_fwd.cu).
//
//   S = alpha * Q K^T      P = silu(S) * valid_mask      O = (P V) / norm
//
// Replaces the Pallas TPU kernels `_fwd_kernel_rkv` / `_fwd_kernel` and
// `_delta_fwd_kernel_rkv` of generative_recommenders_tpu/ops/pallas/
// hstu_attention.py; `valid_elem` ports their tile mask helpers
// `_block_mask` (full, target-aware branch) and `_delta_block_mask`.
//
// Design. One block per (q tile, head, batch row). The block keeps its Q tile
// in shared memory and walks K/V tiles of kBlockK columns only up to the
// row's live bound: the row's length, and for causal attention without
// contextual rows the tile's last row (contextual row 0 attends to every
// column below the target boundary, so the causal early exit is off then).
// Each thread owns a 16-strided set of rows and output columns and keeps its
// accumulator in registers; S and P V are float32 FMAs on shared-memory
// tiles (no tensor cores yet). silu is x / (1 + expf(-x)) with the
// full-precision expf; the TPU's 0.5 * (tanh(x / 2) + 1) sigmoid differs by
// float32 rounding only. Rows and columns past the length or past N
// are masked in the kernel, so every output element is written, zero where
// the row is dead. On the H100 the dense kernel's least time is set by its
// float32 operations; the delta kernel's at the serving chunk (M = 5) by
// the bytes of K/V it reads. Both run far from either bound (PERF.md): the
// tiles are float32 FMAs from shared memory, without tensor cores.
#pragma once

#include <cuda_runtime.h>

namespace hstu {

constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kBlockK = 32;    // key columns per tile: 2 per thread

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* out;  // contiguous [B, n_rows, H, V]
  const int* lengths;      // int32 [B]
  const int* num_targets;  // int32 [B] or null (no targets)
  int B, N, H, D, V;
  int M;  // delta rows per batch row (delta kernel only)
  long long q_sb, q_sn, q_sh;
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  float alpha, inv_norm;
  int causal, max_attn_len, contextual_seq_len, min_full_attn_seq_len;
};

// `_get_valid_attn_mask` semantics for one (row, col) element, AND'ed with
// row/col < length when `guard` is set (the dense kernel's padded layout).
__device__ __forceinline__ bool valid_elem(int raw_r, int raw_c, int length,
                                           int num_targets, bool causal,
                                           int max_attn_len, int ctx,
                                           int min_full, bool guard) {
  int rows = raw_r, cols = raw_c, max_ids = length;
  if (ctx > 0) {
    rows = max(rows - ctx + 1, 0);
    cols = max(cols - ctx + 1, 0);
    max_ids = max_ids - ctx + 1;
  }
  max_ids -= num_targets;
  rows = min(rows, max_ids);
  cols = min(cols, max_ids);
  int dist = rows - cols;
  if (!causal) dist = abs(dist);
  bool valid = dist > 0 || raw_r == raw_c;
  if (max_attn_len > 0) {
    bool window = dist <= max_attn_len;
    if (min_full > 0) window = window || rows >= max_ids - min_full;
    valid = valid && window;
  }
  if (ctx > 0) valid = valid || (rows == 0 && cols < max_ids);
  if (guard) valid = valid && raw_c < length && raw_r < length;
  return valid;
}

__host__ __device__ constexpr int smem_floats(int bq, int d, int v) {
  return bq * (d + 1) + kBlockK * (d + 1) + kBlockK * v + bq * (kBlockK + 1);
}

// RT rows per thread (block of 16*RT query rows), VT = V / 16 output columns
// per thread. DELTA: the q rows are the M newest positions of each row.
template <int RT, int VT, bool DELTA>
__global__ void __launch_bounds__(kThreads) hstu_attn_kernel(Params p) {
  constexpr int BQ = 16 * RT;
  constexpr int BK = kBlockK;
  extern __shared__ float smem[];
  const int D = p.D;
  const int V = 16 * VT;
  const int Dp = D + 1;  // odd row pitch: column reads hit distinct banks
  float* Qs = smem;            // [BQ][Dp]
  float* Ks = Qs + BQ * Dp;    // [BK][Dp]
  float* Vs = Ks + BK * Dp;    // [BK][V]
  float* Ps = Vs + BK * V;     // [BQ][BK + 1]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int n_rows = DELTA ? p.M : p.N;
  const int length = min(p.lengths[b], p.N);
  const int nt = p.num_targets ? p.num_targets[b] : 0;
  const bool causal = DELTA ? true : (p.causal != 0);

  // mask row of each of this thread's q rows
  int mrow[RT];
  bool live[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = q0 + ty + 16 * i;
    live[i] = r < n_rows;
    mrow[i] = DELTA ? min(max(length - p.M + r, 0), p.N - 1) : r;
  }

  int kv_limit = length;
  if (!DELTA) {
    if (causal && p.contextual_seq_len == 0) kv_limit = min(kv_limit, q0 + BQ);
    if (q0 >= length) kv_limit = 0;  // every row of the tile is dead
  }

  float acc[RT][VT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < VT; ++j) acc[i][j] = 0.f;

  if (kv_limit > 0) {
    const float* qb = p.q + b * p.q_sb + h * p.q_sh;
    const float* kb = p.k + b * p.k_sb + h * p.k_sh;
    const float* vb = p.v + b * p.v_sb + h * p.v_sh;
    for (int idx = tid; idx < BQ * D; idx += kThreads) {
      const int r = idx / D, d = idx - r * D;
      const int qr = q0 + r;
      Qs[r * Dp + d] = qr < n_rows ? qb[qr * p.q_sn + d] : 0.f;
    }
    for (int c0 = 0; c0 < kv_limit; c0 += BK) {
      __syncthreads();  // the previous tile's P V is done with Ks/Vs/Ps
      for (int idx = tid; idx < BK * D; idx += kThreads) {
        const int c = idx / D, d = idx - c * D;
        const int n = c0 + c;
        Ks[c * Dp + d] = n < p.N ? kb[n * p.k_sn + d] : 0.f;
      }
      for (int idx = tid; idx < BK * V; idx += kThreads) {
        const int c = idx / V, e = idx - c * V;
        const int n = c0 + c;
        Vs[c * V + e] = n < p.N ? vb[n * p.v_sn + e] : 0.f;
      }
      __syncthreads();

      float s[RT][2];
#pragma unroll
      for (int i = 0; i < RT; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float k0 = Ks[tx * Dp + d];
        const float k1 = Ks[(tx + 16) * Dp + d];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float qq = Qs[(ty + 16 * i) * Dp + d];
          s[i][0] = fmaf(qq, k0, s[i][0]);
          s[i][1] = fmaf(qq, k1, s[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = c0 + tx + 16 * j;
          const float x = s[i][j] * p.alpha;
          const bool ok =
              live[i] && col < p.N &&
              valid_elem(mrow[i], col, length, nt, causal, p.max_attn_len,
                         p.contextual_seq_len, p.min_full_attn_seq_len,
                         /*guard=*/!DELTA);
          Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] =
              ok ? x / (1.f + expf(-x)) : 0.f;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int c = 0; c < BK; ++c) {
        float vv[VT];
#pragma unroll
        for (int j = 0; j < VT; ++j) vv[j] = Vs[c * V + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float pp = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
          for (int j = 0; j < VT; ++j) acc[i][j] = fmaf(pp, vv[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    if (!live[i]) continue;
    const long long r = q0 + ty + 16 * i;
    float* o = p.out + ((long long)b * n_rows + r) * p.H * V + (long long)h * V;
#pragma unroll
    for (int j = 0; j < VT; ++j) o[tx + 16 * j] = acc[i][j] * p.inv_norm;
  }
}

template <int RT, bool DELTA, int VT>
cudaError_t launch_vt(const Params& p, int n_rows, cudaStream_t stream) {
  const int smem = smem_floats(16 * RT, p.D, 16 * VT) * (int)sizeof(float);
  auto kernel = hstu_attn_kernel<RT, VT, DELTA>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n_rows + 16 * RT - 1) / (16 * RT), p.H, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Launches on `stream`; returns the launch's cudaGetLastError(). V must be
// 16, 32, 64 or 128 and D at most 256 (the Python wrapper checks both).
template <int RT, bool DELTA>
int launch(const Params& p, int n_rows, void* stream) {
  if (p.B == 0 || n_rows == 0 || p.H == 0) return 0;
  if (p.D < 1 || p.D > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.V) {
    case 16: return (int)launch_vt<RT, DELTA, 1>(p, n_rows, s);
    case 32: return (int)launch_vt<RT, DELTA, 2>(p, n_rows, s);
    case 64: return (int)launch_vt<RT, DELTA, 4>(p, n_rows, s);
    case 128: return (int)launch_vt<RT, DELTA, 8>(p, n_rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace hstu
