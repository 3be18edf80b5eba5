"""Share of the profiled serving sub-window's device time launched inside
the program's ``dlrm.stu`` span (`modules/hstu_transducer.py:HSTUTransducer.
forward`, around the STU stack, `modules/stu.py`): its GEMMs, norms and the
attention (K1). Null where the trace holds no such span."""

from harness.spans import device_share

SOURCE = "device_trace"
LAYER = "STU stack"
MOVES = "serve_candidates_per_s"
SPAN = "dlrm.stu"


def read(run):
    return device_share(run, SPAN)
