"""The load generator's lateness: the 95th percentile, over the window's
queries, of how long after it could have started a query it did (after the
query's due time and after the query before it ended), in ms. Time lost
here is the harness's, and adds to every latency behind it."""

from harness.runner import quantile

SOURCE = "host_clock"
LAYER = "load generator"
MOVES = "serve_p95_ms"


def read(run):
    late = run.samples.get("late_ms")
    return quantile(late, 0.95) if late else None
