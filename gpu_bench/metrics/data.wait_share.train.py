"""Share of the training window's time that the step loop waited for its
next batch from the port's data layer (`data/dataset.py`: the threaded
batching and `background_prefetch`), by the harness's timer around that call,
over the window that follows the profiled steps."""

SOURCE = "host_clock"
LAYER = "data"
MOVES = "train_examples_per_s"


def read(run):
    if run.window_s <= 0 or "data_wait_s" not in run.timers:
        return None
    return 100.0 * run.timers["data_wait_s"] / run.window_s
