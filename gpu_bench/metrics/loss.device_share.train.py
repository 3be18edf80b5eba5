"""Share of the profiled training sub-window's device time launched inside
the program's ``research.loss`` span (`train/train_loop.py:ResearchTrainer.
loss`, around the loss it calls, `models/losses.py`): the sampled softmax's
forward over the positives and negatives; its backward is inside
``train.backward``. Null where the trace holds no such span."""

from harness.spans import device_share

SOURCE = "device_trace"
LAYER = "losses"
MOVES = "train_examples_per_s"
SPAN = "research.loss"


def read(run):
    return device_share(run, SPAN)
