// K2: fused HSTU attention backward, dq, dk and dv in one pass over the live
// tile pairs, dq summed with atomicAdd into a zeroed float32 buffer.
// Replaces `_bwd_fused_kernel_rkv` (called from `_hstu_mha_bwd`) of
// generative_recommenders_tpu/ops/pallas/hstu_attention.py. See
// hstu_attention_bwd.cuh for the design.
#include "hstu_attention_bwd.cuh"

HSTU_BWD_ENTRY(hstu_mha_bwd_fused, hstu_bwd::kFused)
