// K6: dense HSTU attention forward with the relative position and time bias
// rebuilt inside the kernel, [B, N, H, D] in, [B, N, H, V] out.
// Replaces `_fwd_kernel_relbias` (called from `hstu_mha_dense_pallas_relbias`)
// of generative_recommenders_tpu/ops/pallas/hstu_attention_relbias.py. See
// hstu_attention.cuh for the design.
#include "hstu_attention.cuh"

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
  hstu::Params p{q, k, v, out, lengths, num_targets, B, N, H, D, V,
                 q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh,
                 alpha, inv_norm, causal, max_attn_len, contextual_seq_len,
                 min_full_attn_seq_len, ts, pos_w, ts_w, Nm, NB};
  // 32 query rows per block (2 per thread): at N = 511 and 8 heads of width
  // 32 the grid still holds thousands of blocks
  return hstu::launch</*RT=*/2, /*RELBIAS=*/true>(p, N, stream);
}
