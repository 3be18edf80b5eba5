// K4: HSTU attention backward, dk and dv; with K3 the deterministic split
// backward. Replaces `_bwd_dkv_kernel` (called from `_hstu_mha_bwd`) of
// generative_recommenders_tpu/ops/pallas/hstu_attention.py. See
// hstu_attention_bwd.cuh for the design.
#include "hstu_attention_bwd.cuh"

HSTU_BWD_ENTRY(hstu_mha_bwd_dkv, hstu_bwd::kDkv)
