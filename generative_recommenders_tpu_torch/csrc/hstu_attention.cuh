// The mask and bias helpers of every HSTU attention kernel for Hopper
// (sm_90a): the forward body of K1 and K6 (hstu_attention_fwd.cuh), the
// backward bodies of K2 and K4 (hstu_attention_bwd_dkv.cuh) and of K3
// (hstu_attention_bwd_dq.cuh), the M-FALCON delta kernel K5
// (delta_hstu_mha_fwd.cu) and the relative-bias backward K7
// (hstu_mha_relbias_bwd.cu). `valid_elem` ports the tile mask helpers
// `_block_mask` (full, target-aware branch) and `_delta_block_mask` of
// generative_recommenders_tpu/ops/pallas/hstu_attention.py.
//
// The relative bias of K6 and K7 is rebuilt per element from two small tables
// and the row's timestamps, never as a [B, N, N] tensor:
//
//   bias[b, i, j] = pos_w[clip(j - i + Nm - 1, 0, 2 Nm - 2)]
//                 + ts_w[clip(floor(ln(max(|ts[b, min(i + 1, N - 1)]
//                                         - ts[b, j]|, 1)) / 0.301), 0, NB)]
#pragma once

#include <cuda_runtime.h>

namespace hstu {

// The body a launch takes, as the Python plan chose it (`route` of the plans
// in ops/cuda/hstu_attention.py and hstu_attention_relbias.py): the narrow
// body with its tables staged in shared memory, the narrow body with its
// tables read from device memory (K6, K7 and K7-det), the wide bodies on
// thread block clusters of hstu_attention_wide.cuh, its per-pair bodies
// (the widths no cluster takes), or its tile forward (float32 K1 and
// K1-bias at V of 129 to 256, or to 384 at D up to 128). A launch takes the
// route it is given and returns cudaErrorInvalidValue where that body cannot
// take the shape.
enum Route : int { kNarrow = 0, kRead = 1, kWide = 2, kWideChunks = 3, kWideTile = 4 };

// bucket(x) = floor(ln(x) / 0.301), computed as ln(x) * (1 / 0.301) with the
// full-precision logf: the form of the TPU kernel and of the plain version.
constexpr float kInvLogBase = (float)(1.0 / 0.301);

// Index into ts_w for a query-side and a key-side timestamp.
__device__ __forceinline__ int ts_bucket(float tq, float tk, int nb) {
  const float y = floorf(logf(fmaxf(fabsf(tq - tk), 1.f)) * kInvLogBase);
  return (int)fminf(fmaxf(y, 0.f), (float)nb);
}

// Index into pos_w for (row, col); out of range only where N > Nm.
__device__ __forceinline__ int pos_index(int row, int col, int nm) {
  return min(max(col - row + nm - 1, 0), 2 * nm - 2);
}

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

}  // namespace hstu
