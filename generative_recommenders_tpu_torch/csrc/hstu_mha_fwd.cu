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
#include "hstu_attention_fwd.cuh"

extern "C" int hstu_mha_fwd(
    const float* q, const float* k, const float* v, float* out,
    const int* lengths, const int* num_targets,
    int B, int N, int H, int D, int V,
    long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh,
    float alpha, float inv_norm, int causal, int max_attn_len,
    int contextual_seq_len, int min_full_attn_seq_len, void* stream) {
  hstu_fwd::Params p{q, k, v, out, lengths, num_targets, B, N, H, D, V,
                     q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh,
                     alpha, inv_norm, causal, max_attn_len, contextual_seq_len,
                     min_full_attn_seq_len};
  return hstu_fwd::launch</*RELBIAS=*/false>(p, stream);
}
