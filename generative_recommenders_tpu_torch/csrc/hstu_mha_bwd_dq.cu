// K3: HSTU attention backward, dq alone; with K4 the deterministic split
// backward. Replaces `_bwd_dq_kernel` (called from `_hstu_mha_bwd`) of
// generative_recommenders_tpu/ops/pallas/hstu_attention.py. See
// hstu_attention_bwd.cuh for the design.
#include "hstu_attention_bwd.cuh"

HSTU_BWD_ENTRY(hstu_mha_bwd_dq, hstu_bwd::kDq)
