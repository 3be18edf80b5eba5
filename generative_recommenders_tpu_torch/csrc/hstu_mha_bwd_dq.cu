// K3: HSTU attention backward, dq alone; with K4 the deterministic split
// backward. Replaces `_bwd_dq_kernel` (called from `_hstu_mha_bwd`) of
// generative_recommenders_tpu/ops/pallas/hstu_attention.py. See
// hstu_attention_bwd_dq.cuh for the design (three 3xTF32 products per tile
// pair on the tensor cores, dQ in registers, no atomics: the same bits on
// every run).
//
// `hstu_mha_bwd_dq_bf16` (K3-bf16) is K3 on bfloat16 q, k, v, dO and dq:
// with K4-bf16 the deterministic backward of K1-bf16 (the first HSTU block of
// the bias-free research model under compute_dtype="bfloat16"), at the
// rounding points of `_bwd_dq_kernel` on bfloat16: alpha q and dO / norm
// rounded to bfloat16 by a pre-scaling pass, S and dP in float32, dS rounded
// to bfloat16 before dQ = dS K, dq = alpha times its float32 sum, written as
// bfloat16; on the bfloat16 body of hstu_attention_bwd_dq_bf16.cuh (the
// products `mma.sync` m16n8k16 on the bfloat16 tensor cores, dS handed to
// dQ in registers). Bound: 2 (D + V) bytes per live row and head for q and
// dO, the same for k and v, 2 D per element of dq, or its 2 D + V
// multiply-adds per live element and head at the card's bfloat16 rate
// (989 TFLOP/s).
#include "hstu_attention_bwd_dq.cuh"

// dk and dv are null; vec_*: whether q, k, v and dO may be read in 16-byte pieces.
// scratch, group_slabs, splits: route kWideChunks's float32 scratch and its
// plan (`_wide_bwd_plan`); null and 0 on every other route.
extern "C" int hstu_mha_bwd_dq(
    const float* q, const float* k, const float* v, const float* dout,
    float* dq, float* dk, float* dv, const int* lengths, const int* num_targets,
    int B, int N, int H, int D, int V,
    long long q_sb, long long q_sn, long long q_sh, long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh, long long do_sb, long long do_sn, long long do_sh,
    float alpha, float inv_norm, int causal, int max_attn_len, int contextual_seq_len,
    int min_full_attn_seq_len,
    float* scratch, int group_slabs, int splits, int vec_q, int vec_k, int vec_v, int vec_do, int route, void* stream) {
  hstu_bwd_dq::Params<float> p{q, k, v, dout, dq, lengths, num_targets, B, N, H, D, V,
                               q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, do_sb, do_sn, do_sh,
                               alpha, inv_norm, causal, max_attn_len, contextual_seq_len,
                               min_full_attn_seq_len, vec_q, vec_k, vec_v, vec_do};
  p.scratch = scratch;
  p.group_slabs = group_slabs;
  p.splits = splits;
  return hstu_bwd_dq::launch(p, route, stream);
}

// The bfloat16 kernel: q, k, v, dout and dq bfloat16; qs and dos contiguous
// [B, N, H, D] and [B, N, H, V] bfloat16 buffers for bfloat16(alpha q) (null
// where alpha is 1) and bfloat16(dO / norm); dk and dv null. vec_*: rows
// readable in 16-byte pieces.
extern "C" int hstu_mha_bwd_dq_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const __nv_bfloat16* dout, __nv_bfloat16* qs, __nv_bfloat16* dos, __nv_bfloat16* dq, __nv_bfloat16* dk,
    __nv_bfloat16* dv,
    const int* lengths, const int* num_targets, int B, int N, int H, int D, int V,
    long long q_sb, long long q_sn, long long q_sh, long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh, long long do_sb, long long do_sn, long long do_sh,
    float alpha, float inv_norm, int causal, int max_attn_len, int contextual_seq_len,
    int min_full_attn_seq_len,
    float* scratch, int group_slabs, int splits, int vec_q, int vec_k, int vec_v, int vec_do, int route, void* stream) {
  hstu_bwd_dq::Params<__nv_bfloat16> p{
      q, k, v, dout, dq, lengths, num_targets, B, N, H, D, V,
      q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, do_sb, do_sn, do_sh,
      alpha, inv_norm, causal, max_attn_len, contextual_seq_len,
      min_full_attn_seq_len, vec_q, vec_k, vec_v, vec_do, qs, dos};
  p.scratch = scratch;
  p.group_slabs = group_slabs;
  p.splits = splits;
  return hstu_bwd_dq::launch(p, route, stream);
}
