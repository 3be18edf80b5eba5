"""Share of the profiled training sub-window's device time launched inside
the program's ``train.backward`` span (`train/dlrm_train.py:DlrmTrainer.
train_step`, `train/train_loop.py:ResearchTrainer.train_step`: around
``loss.backward()``), by the autograd thread while the caller waits. Null
where the trace holds no such span."""

from harness.spans import device_share

SOURCE = "device_trace"
LAYER = "backward"
MOVES = "train_examples_per_s"
SPAN = "train.backward"


def read(run):
    return device_share(run, SPAN)
