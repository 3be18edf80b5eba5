"""Share of the profiled serving sub-window's device time launched inside
the program's ``dlrm.lookup`` span (`modules/dlrm_hstu.py:
lookup_and_merge_features`): the int8 tables' gather and dequantisation
(`inference/model_family.py:HSTUModelFamily._lookup`) and the merge of the
history with the candidates. Null where the trace holds no such span."""

from harness.spans import device_share

SOURCE = "device_trace"
LAYER = "table lookup"
MOVES = "serve_candidates_per_s"
SPAN = "dlrm.lookup"


def read(run):
    return device_share(run, SPAN)
