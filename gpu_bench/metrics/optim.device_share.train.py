"""Share of the profiled sub-window's device time spent in kernels launched
under PyTorch's own ``Optimizer.step#<class>.step`` ranges: AdamW and the
ranker's row-wise Adagrad (`parallel/optimizers.py`)."""

SOURCE = "device_trace"
LAYER = "optimizers"
MOVES = "train_examples_per_s"
RANGE_PREFIX = "Optimizer.step#"


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    share = t.range_device_time(RANGE_PREFIX)
    return None if share <= 0 else 100.0 * share / t.busy_s
