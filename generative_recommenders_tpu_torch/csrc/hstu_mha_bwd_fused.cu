// K2: fused HSTU attention backward, dq, dk and dv in one pass over the live
// tile pairs, dq summed with atomicAdd into a zeroed float32 buffer.
// Replaces `_bwd_fused_kernel_rkv` (called from `_hstu_mha_bwd`) of
// generative_recommenders_tpu/ops/pallas/hstu_attention.py. See
// hstu_attention_bwd_dkv.cuh for the design (five 3xTF32 products per tile
// pair on the tensor cores).
//
// `hstu_mha_bwd_fused_bf16` (K2-bf16) is K2 on bfloat16 q, k, v and dO, the
// backward of K1-bf16 (the first HSTU block of the bias-free research model
// under compute_dtype="bfloat16"), at the TPU kernel's rounding points, on
// the bfloat16 body of hstu_attention_bwd_dkv_bf16.cuh (a pre-scaling pass
// into the wrapper's qs and dos, then `mma.sync` m16n8k16 on the bfloat16
// tensor cores). Bound: 2 (2 D + 2 V) bytes per live row and head for q, k,
// v and dO and 2 (2 D + V) per element of the outputs, with 8 D more per
// element for dq's float32 buffer (zeroed, summed into, read by the second
// kernel), or its operations at the card's bfloat16 rate (989 TFLOP/s).
#include "hstu_attention_bwd_dkv.cuh"

// dq is zeroed; vec_*: whether q, k, v and dO may be read in 16-byte pieces.
// scratch, group_slabs, splits: route kWideChunks's float32 scratch and its
// plan (`_wide_bwd_plan`); null and 0 on every other route.
extern "C" int hstu_mha_bwd_fused(
    const float* q, const float* k, const float* v, const float* dout,
    float* dq, float* dk, float* dv, const int* lengths, const int* num_targets,
    int B, int N, int H, int D, int V,
    long long q_sb, long long q_sn, long long q_sh, long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh, long long do_sb, long long do_sn, long long do_sh,
    float alpha, float inv_norm, int causal, int max_attn_len, int contextual_seq_len,
    int min_full_attn_seq_len,
    float* scratch, int group_slabs, int splits, int vec_q, int vec_k, int vec_v, int vec_do, int route, void* stream) {
  hstu_bwd_dkv::Params<float> p{q, k, v, dout, dq, dk, dv, lengths, num_targets, B, N, H, D, V,
                                q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, do_sb, do_sn, do_sh,
                                alpha, inv_norm, causal, max_attn_len, contextual_seq_len,
                                min_full_attn_seq_len, vec_q, vec_k, vec_v, vec_do};
  p.scratch = scratch;
  p.group_slabs = group_slabs;
  p.splits = splits;
  return hstu_bwd_dkv::launch</*FUSED=*/true, float>(p, route, stream);
}

// The bfloat16 kernel: q, k, v, dout, dk and dv bfloat16; qs and dos
// contiguous [B, N, H, D] and [B, N, H, V] bfloat16 buffers for bfloat16(alpha
// q) (null where alpha is 1) and bfloat16(dO / norm); dq32 a zeroed float32
// [B, N, H, D] buffer for dq's sums, which a last launch writes into dq as
// bfloat16. vec_*: rows readable in 16-byte pieces.
extern "C" int hstu_mha_bwd_fused_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const __nv_bfloat16* dout, __nv_bfloat16* qs, __nv_bfloat16* dos, float* dq32, __nv_bfloat16* dq,
    __nv_bfloat16* dk,
    __nv_bfloat16* dv, const int* lengths, const int* num_targets,
    int B, int N, int H, int D, int V,
    long long q_sb, long long q_sn, long long q_sh, long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh, long long do_sb, long long do_sn, long long do_sh,
    float alpha, float inv_norm, int causal, int max_attn_len, int contextual_seq_len,
    int min_full_attn_seq_len,
    float* scratch, int group_slabs, int splits, int vec_q, int vec_k, int vec_v, int vec_do, int route, void* stream) {
  hstu_bwd_dkv::Params<__nv_bfloat16> p{
      q, k, v, dout, dq32, dk, dv, lengths, num_targets, B, N, H, D, V,
      q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, do_sb, do_sn, do_sh,
      alpha, inv_norm, causal, max_attn_len, contextual_seq_len,
      min_full_attn_seq_len, vec_q, vec_k, vec_v, vec_do, qs, dos};
  p.scratch = scratch;
  p.group_slabs = group_slabs;
  p.splits = splits;
  const int err = hstu_bwd_dkv::launch</*FUSED=*/true, __nv_bfloat16>(p, route, stream);
  if (err != 0) return err;
  return (int)hstu_tf32::to_bf16(dq32, dq, (long long)B * N * H * D, static_cast<cudaStream_t>(stream));
}
