// K4: HSTU attention backward, dk and dv; with K3 the deterministic split
// backward. Replaces `_bwd_dkv_kernel` (called from `_hstu_mha_bwd`) of
// generative_recommenders_tpu/ops/pallas/hstu_attention.py. See
// hstu_attention_bwd_dkv.cuh for the design (K2's body without dQ: four
// 3xTF32 products per tile pair on the tensor cores, no atomics, the same
// bits on every run).
#include "hstu_attention_bwd_dkv.cuh"

// dq is null; vec_*: whether q, k, v and dO may be read in 16-byte pieces.
extern "C" int hstu_mha_bwd_dkv(
    const float* q, const float* k, const float* v, const float* dout,
    float* dq, float* dk, float* dv, const int* lengths, const int* num_targets,
    int B, int N, int H, int D, int V,
    long long q_sb, long long q_sn, long long q_sh, long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh, long long do_sb, long long do_sn, long long do_sh,
    float alpha, float inv_norm, int causal, int max_attn_len, int contextual_seq_len,
    int min_full_attn_seq_len, int vec_q, int vec_k, int vec_v, int vec_do, void* stream) {
  hstu_bwd_dkv::Params<float> p{q, k, v, dout, dq, dk, dv, lengths, num_targets, B, N, H, D, V,
                                q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, do_sb, do_sn, do_sh,
                                alpha, inv_norm, causal, max_attn_len, contextual_seq_len,
                                min_full_attn_seq_len, vec_q, vec_k, vec_v, vec_do};
  return hstu_bwd_dkv::launch</*FUSED=*/false, float>(p, stream);
}
