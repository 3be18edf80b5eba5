// K3: HSTU attention backward, dq alone; with K4 the deterministic split
// backward. Replaces `_bwd_dq_kernel` (called from `_hstu_mha_bwd`) of
// generative_recommenders_tpu/ops/pallas/hstu_attention.py. See
// hstu_attention_bwd.cuh for the design.
#include "hstu_attention_bwd.cuh"

// The wrapper's common signature of the backward kernels: dk and dv are null.
extern "C" int hstu_mha_bwd_dq(
    const float* q, const float* k, const float* v, const float* dout,
    float* dq, float* dk, float* dv, const int* lengths, const int* num_targets,
    int B, int N, int H, int D, int V,
    long long q_sb, long long q_sn, long long q_sh, long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh, long long do_sb, long long do_sn, long long do_sh,
    float alpha, float inv_norm, int causal, int max_attn_len, int contextual_seq_len,
    int min_full_attn_seq_len, void* stream) {
  hstu_bwd::Params p{q, k, v, dout, dq, lengths, num_targets, B, N, H, D, V,
                     q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, do_sb, do_sn, do_sh,
                     alpha, inv_norm, causal, max_attn_len, contextual_seq_len,
                     min_full_attn_seq_len};
  return hstu_bwd::launch(p, stream);
}
