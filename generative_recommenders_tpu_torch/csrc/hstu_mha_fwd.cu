// K1: dense HSTU attention forward, [B, N, H, D] in, [B, N, H, V] out.
// Replaces `_fwd_kernel_rkv` and `_fwd_kernel` (called from
// `hstu_mha_dense_pallas`) of generative_recommenders_tpu/ops/pallas/
// hstu_attention.py. Bound on the H100: at the serving shape (D = V = 128)
// its bytes, 4 (2 D + V) per live row and head and the whole output, at
// 3.35 TB/s; its 512 multiply-adds per live element and head take about half
// as long at the 3xTF32 rate of the tensor cores (165 TFLOP/s). The
// design, in hstu_attention_fwd.cuh: 3xTF32 `mma.sync` products with P kept
// in registers, one head and 64 query rows per block of 4 warps, 32-column
// key tiles double-buffered by `cp.async`, two blocks an SM.
//
// `hstu_mha_fwd_bf16` (K1-bf16) is K1 on bfloat16 q, k, v and out: the
// first HSTU block of the bias-free research model under
// compute_dtype="bfloat16", which the TPU runs through the same Pallas
// kernels on bfloat16. The TPU kernel's rounding points: alpha q rounded to
// bfloat16 (where alpha != 1), S in float32, P rounded to bfloat16 before
// P V, out = bfloat16(float32 sum / norm). Its body is the bfloat16 body of
// hstu_attention_fwd_bf16.cuh: bfloat16 tiles by `cp.async`, `mma.sync`
// m16n8k16 on the bfloat16 tensor cores, long walks cut in chunks of the
// plan's `chunk` key columns whose float32 sums go to `scratch` ([chunks, B,
// N, H, V], null where the plan cuts none) and are added in chunk order.
// Bound: 2 (2 D + V) bytes per live row and head and 2 V per output
// element, half the float32 kernel's, or its operations at the card's
// bfloat16 rate, 989 TFLOP/s.
//
// `hstu_mha_fwd_bias` and `hstu_mha_fwd_bias_bf16` (K1-bias) are K1 and
// K1-bf16 with an additive [B, N, N] bias added to S = alpha Q K^T before
// silu, as `_fwd_kernel_rkv` / `_fwd_kernel` take it under `has_bias` (a
// forward-only path of the JAX package: parity and inference experiments).
// The bias is float32 or bfloat16 (converted to float32 on load, as the TPU
// kernel casts it), contiguous along the key axis, its batch stride 0 for one
// [N, N] bias shared by the batch; each thread reads the bias of its own S
// elements from device memory into registers, two neighbouring columns a
// load, and only those of live rows and columns below the length, once for
// the block's group of heads. Bound: K1's bytes and operations plus the
// bias's bytes over the live elements, 4 (float32) or 2 (bfloat16) a (row,
// column) pair; at the serving shape the bias's bytes dominate.
//
// scratch (float32 entry points: after the mask ints; bfloat16: after out,
// where it also holds the chunks' sums), group_slabs, splits (after the mask
// ints): route kWideChunks's float32 scratch and its plan (`_pairs_plan` in
// ops/cuda/hstu_attention.py); null and 0 where the route takes none.
#include "hstu_attention_fwd.cuh"

extern "C" int hstu_mha_fwd(
    const float* q, const float* k, const float* v, float* out,
    const int* lengths, const int* num_targets,
    int B, int N, int H, int D, int V,
    long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh,
    float alpha, float inv_norm, int causal, int max_attn_len,
    int contextual_seq_len, int min_full_attn_seq_len, float* scratch, int group_slabs, int splits,
    int route, void* stream) {
  hstu_fwd::Params p{q, k, v, out, lengths, num_targets, B, N, H, D, V,
                     q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh,
                     alpha, inv_norm, causal, max_attn_len, contextual_seq_len,
                     min_full_attn_seq_len};
  p.scratch = scratch;
  p.group_slabs = group_slabs;
  p.splits = splits;
  return hstu_fwd::launch<hstu_fwd::kNoBias>(p, route, stream);
}

extern "C" int hstu_mha_fwd_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v, __nv_bfloat16* out,
    float* scratch, const int* lengths, const int* num_targets,
    int B, int N, int H, int D, int V,
    long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh,
    float alpha, float inv_norm, int causal, int max_attn_len,
    int contextual_seq_len, int min_full_attn_seq_len, int group_slabs, int splits, int chunk, int route,
    void* stream) {
  hstu_fwd::Params p{q, k, v, out, lengths, num_targets, B, N, H, D, V,
                     q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh,
                     alpha, inv_norm, causal, max_attn_len, contextual_seq_len,
                     min_full_attn_seq_len};
  p.chunk = chunk;
  p.scratch = scratch;
  p.group_slabs = group_slabs;
  p.splits = splits;
  return hstu_fwd::launch<hstu_fwd::kNoBias, __nv_bfloat16>(p, route, stream);
}

// K1-bias: q, k, v and out float32 (hstu_mha_fwd_bias) or bfloat16
// (hstu_mha_fwd_bias_bf16, with K1-bf16's scratch and chunk); bias float32
// or bfloat16 (bias_bf16) with strides bias_sb (0: one bias for every batch
// row) and bias_sn, contiguous along the key axis.
extern "C" int hstu_mha_fwd_bias(
    const float* q, const float* k, const float* v, float* out,
    const int* lengths, const int* num_targets, const void* bias,
    int B, int N, int H, int D, int V,
    long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh, long long bias_sb, long long bias_sn,
    float alpha, float inv_norm, int causal, int max_attn_len,
    int contextual_seq_len, int min_full_attn_seq_len, float* scratch, int group_slabs, int splits,
    int bias_bf16, int route, void* stream) {
  hstu_fwd::Params p{q, k, v, out, lengths, num_targets, B, N, H, D, V,
                     q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh,
                     alpha, inv_norm, causal, max_attn_len, contextual_seq_len,
                     min_full_attn_seq_len};
  p.scratch = scratch;
  p.group_slabs = group_slabs;
  p.splits = splits;
  p.bias = bias;
  p.bias_sb = bias_sb;
  p.bias_sn = bias_sn;
  p.bias_bf16 = bias_bf16;
  return hstu_fwd::launch<hstu_fwd::kDenseBias>(p, route, stream);
}

extern "C" int hstu_mha_fwd_bias_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v, __nv_bfloat16* out,
    float* scratch, const int* lengths, const int* num_targets, const void* bias,
    int B, int N, int H, int D, int V,
    long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh, long long bias_sb, long long bias_sn,
    float alpha, float inv_norm, int causal, int max_attn_len,
    int contextual_seq_len, int min_full_attn_seq_len, int group_slabs, int splits, int bias_bf16, int chunk,
    int route, void* stream) {
  hstu_fwd::Params p{q, k, v, out, lengths, num_targets, B, N, H, D, V,
                     q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh,
                     alpha, inv_norm, causal, max_attn_len, contextual_seq_len,
                     min_full_attn_seq_len};
  p.bias = bias;
  p.bias_sb = bias_sb;
  p.bias_sn = bias_sn;
  p.bias_bf16 = bias_bf16;
  p.chunk = chunk;
  p.scratch = scratch;
  p.group_slabs = group_slabs;
  p.splits = splits;
  return hstu_fwd::launch<hstu_fwd::kDenseBias, __nv_bfloat16>(p, route, stream);
}
