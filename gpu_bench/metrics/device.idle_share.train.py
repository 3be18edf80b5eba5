"""Share of the profiled training sub-window in which no kernel, copy or
fill ran on the card: 1 - (union of the device intervals) / window."""

SOURCE = "device_trace"
LAYER = "device"
MOVES = "train_examples_per_s"


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * t.idle_share
