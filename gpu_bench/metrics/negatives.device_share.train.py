"""Share of the profiled training sub-window's device time launched inside
the program's ``research.negatives`` span (`train/train_loop.py:
ResearchTrainer.loss`, around the sampler's call, `models/samplers.py`):
drawing the negatives and gathering their embeddings, forward only. Null
where the trace holds no such span."""

from harness.spans import device_share

SOURCE = "device_trace"
LAYER = "negatives sampler"
MOVES = "train_examples_per_s"
SPAN = "research.negatives"


def read(run):
    return device_share(run, SPAN)
