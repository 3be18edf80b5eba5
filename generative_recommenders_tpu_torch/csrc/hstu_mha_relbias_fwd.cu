// K6: dense HSTU attention forward with the relative position and time bias
// rebuilt inside the kernel, [B, N, H, D] in, [B, N, H, V] out.
// Replaces `_fwd_kernel_relbias` (called from `hstu_mha_dense_pallas_relbias`)
// of generative_recommenders_tpu/ops/pallas/hstu_attention_relbias.py. Bound
// on the H100: at the research shape (D = V = 32) its bytes, 4 (2 D + V) per
// live row and head, at 3.35 TB/s; its 128 multiply-adds per live element
// and head take less at the 3xTF32 rate (165 TFLOP/s). The design, in
// hstu_attention_fwd.cuh: 3xTF32 `mma.sync` products with P kept in
// registers, a group of 2 heads and 128 query rows per block of 8 warps, so
// that the mask, the bucket's logf and both table reads are computed once
// per (row, column) for the group; 32-column key tiles double-buffered by
// `cp.async`, two blocks an SM. `hstu_mha_relbias_fwd_bf16` is the same
// kernel on bfloat16 q, k, v and out (the bias tables and the timestamps stay
// float32): at 2 (2 D + V) bytes per live row and head its bound halves,
// and its operations are held to the card's bfloat16 rate, 989 TFLOP/s,
// though its products are one exact TF32 `mma` each, which run at half that
// rate (the TF32 rate, 495).
#include "hstu_attention_fwd.cuh"

extern "C" int hstu_mha_relbias_fwd(
    const float* q, const float* k, const float* v, float* out,
    const int* lengths, const int* num_targets, const float* ts,
    const float* pos_w, const float* ts_w,
    int B, int N, int H, int D, int V,
    long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh,
    float alpha, float inv_norm, int causal, int max_attn_len,
    int contextual_seq_len, int min_full_attn_seq_len, int Nm, int NB,
    void* stream) {
  hstu_fwd::Params p{q, k, v, out, lengths, num_targets, B, N, H, D, V,
                     q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh,
                     alpha, inv_norm, causal, max_attn_len, contextual_seq_len,
                     min_full_attn_seq_len, ts, pos_w, ts_w, Nm, NB};
  return hstu_fwd::launch</*RELBIAS=*/true>(p, stream);
}

extern "C" int hstu_mha_relbias_fwd_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v, __nv_bfloat16* out,
    const int* lengths, const int* num_targets, const float* ts,
    const float* pos_w, const float* ts_w,
    int B, int N, int H, int D, int V,
    long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh,
    float alpha, float inv_norm, int causal, int max_attn_len,
    int contextual_seq_len, int min_full_attn_seq_len, int Nm, int NB,
    void* stream) {
  hstu_fwd::Params p{q, k, v, out, lengths, num_targets, B, N, H, D, V,
                     q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh,
                     alpha, inv_norm, causal, max_attn_len, contextual_seq_len,
                     min_full_attn_seq_len, ts, pos_w, ts_w, Nm, NB};
  return hstu_fwd::launch</*RELBIAS=*/true, __nv_bfloat16>(p, stream);
}
