"""The attention kernels' share of their roofline in the profiled serving
sub-window: the least time the card could take for the attention calls those
steps made (each call's bound the larger of its bytes over 3.35 TB/s and its
operations over the precision's peak, counted from the configuration's
shapes and the batches' live lengths by the reference's `attention_calls`),
over the device time of the port's attention kernels, matched by name.
Null where the trace matched fewer attention kernel launches than the port's
`LaunchCounter`s saw entry calls (a renamed or new kernel)."""

from harness.roofline import attention_share

SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "serve_candidates_per_s"
# the namespaces of the port's attention kernels (csrc/)
KERNEL_PATTERNS = (
    "hstu_fwd::", "hstu_bwd_dkv::", "hstu_bwd_dq::", "hstu_relbias_bwd::", "hstu_wide::", "hstu_delta::",
)
HBM_BYTES_PER_S = 3.35e12
# dense peaks of one H100 SXM (NVIDIA's data sheet); float32 as 3xTF32
PEAK_FLOPS = {"float32": 165e12, "bfloat16": 989e12}


def read(run):
    return attention_share(run, KERNEL_PATTERNS, HBM_BYTES_PER_S, PEAK_FLOPS)
