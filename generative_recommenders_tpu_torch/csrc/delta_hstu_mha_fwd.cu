// K5: M-FALCON cached-decode attention forward. The M newest queries of each
// row (positions length-M .. length-1, [B, M, H, D]) attend over the cache +
// delta keys/values ([B, N, H, D], [B, N, H, V]); out is [B, M, H, V].
// Replaces `_delta_fwd_kernel_rkv` (called from `delta_hstu_mha_pallas`) of
// generative_recommenders_tpu/ops/pallas/hstu_attention.py. M is not padded:
// rows m >= M are simply not computed. See hstu_attention.cuh.
#include "hstu_attention.cuh"

extern "C" int delta_hstu_mha_fwd(
    const float* q, const float* k, const float* v, float* out,
    const int* lengths, const int* num_targets,
    int B, int M, int N, int H, int D, int V,
    long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh,
    float alpha, float inv_norm, int max_attn_len, int contextual_seq_len,
    int min_full_attn_seq_len, void* stream) {
  hstu::Params p{q, k, v, out, lengths, num_targets, B, N, H, D, V, M,
                 q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh,
                 alpha, inv_norm, /*causal=*/1, max_attn_len,
                 contextual_seq_len, min_full_attn_seq_len};
  // 16 delta rows per block (1 per thread): the serving chunk is M = 5
  return hstu::launch</*RT=*/1, /*DELTA=*/true>(p, M, stream);
}
