// K4: HSTU attention backward, dk and dv; with K3 the deterministic split
// backward. Replaces `_bwd_dkv_kernel` (called from `_hstu_mha_bwd`) of
// generative_recommenders_tpu/ops/pallas/hstu_attention.py. See
// hstu_attention_bwd_dkv.cuh for the design (K2's body without dQ: four
// 3xTF32 products per tile pair on the tensor cores, no atomics, the same
// bits on every run).
//
// `hstu_mha_bwd_dkv_bf16` (K4-bf16) is K4 on bfloat16 q, k, v, dO, dk and
// dv: with K3-bf16 the deterministic backward of K1-bf16, at the rounding
// points of `_bwd_dkv_kernel` on bfloat16, which are K2-bf16's: alpha q and
// dO / norm rounded to bfloat16 by a pre-scaling pass, S, dP and dS in
// float32, P rounded to bfloat16 before dV = P^T dO and dS before dK = dS^T
// (alpha q), against the rounded alpha q, so that dk takes no alpha of its
// own; dk and dv written as bfloat16; K2-bf16's bfloat16 body
// (hstu_attention_bwd_dkv_bf16.cuh) without dQ. Bound: 2 (2 D + 2 V) bytes
// per live row and head for q, k, v and dO and 2 (D + V) per element of dk
// and dv, or its 2 D + 2 V multiply-adds per live element and head at the
// card's bfloat16 rate (989 TFLOP/s).
#include "hstu_attention_bwd_dkv.cuh"

// dq is null; vec_*: whether q, k, v and dO may be read in 16-byte pieces.
// scratch, group_slabs, splits: route kWideChunks's float32 scratch and its
// plan (`_wide_bwd_plan`); null and 0 on every other route.
extern "C" int hstu_mha_bwd_dkv(
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
  return hstu_bwd_dkv::launch</*FUSED=*/false, float>(p, route, stream);
}

// The bfloat16 kernel: q, k, v, dout, dk and dv bfloat16; qs and dos
// K2-bf16's buffers; dq null. vec_*: rows readable in 16-byte pieces.
extern "C" int hstu_mha_bwd_dkv_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const __nv_bfloat16* dout, __nv_bfloat16* qs, __nv_bfloat16* dos, __nv_bfloat16* dq, __nv_bfloat16* dk,
    __nv_bfloat16* dv,
    const int* lengths, const int* num_targets, int B, int N, int H, int D, int V,
    long long q_sb, long long q_sn, long long q_sh, long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh, long long do_sb, long long do_sn, long long do_sh,
    float alpha, float inv_norm, int causal, int max_attn_len, int contextual_seq_len,
    int min_full_attn_seq_len,
    float* scratch, int group_slabs, int splits, int vec_q, int vec_k, int vec_v, int vec_do, int route, void* stream) {
  hstu_bwd_dkv::Params<__nv_bfloat16> p{
      q, k, v, dout, nullptr, dk, dv, lengths, num_targets, B, N, H, D, V,
      q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, do_sb, do_sn, do_sh,
      alpha, inv_norm, causal, max_attn_len, contextual_seq_len,
      min_full_attn_seq_len, vec_q, vec_k, vec_v, vec_do, qs, dos};
  p.scratch = scratch;
  p.group_slabs = group_slabs;
  p.splits = splits;
  return hstu_bwd_dkv::launch</*FUSED=*/false, __nv_bfloat16>(p, route, stream);
}
