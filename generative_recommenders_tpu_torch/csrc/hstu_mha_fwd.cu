// K1: dense HSTU attention forward, [B, N, H, D] in, [B, N, H, V] out.
// Replaces `_fwd_kernel_rkv` and `_fwd_kernel` (called from
// `hstu_mha_dense_pallas`) of generative_recommenders_tpu/ops/pallas/
// hstu_attention.py. See hstu_attention.cuh for the design.
#include "hstu_attention.cuh"

extern "C" int hstu_mha_fwd(
    const float* q, const float* k, const float* v, float* out,
    const int* lengths, const int* num_targets,
    int B, int N, int H, int D, int V,
    long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh,
    float alpha, float inv_norm, int causal, int max_attn_len,
    int contextual_seq_len, int min_full_attn_seq_len, void* stream) {
  hstu::Params p{q, k, v, out, lengths, num_targets, B, N, H, D, V,
                 q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh,
                 alpha, inv_norm, causal, max_attn_len, contextual_seq_len,
                 min_full_attn_seq_len};
  // 64 query rows per block (4 per thread)
  return hstu::launch</*RT=*/4>(p, N, stream);
}
