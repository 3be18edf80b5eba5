"""Driver: the ranking service's Server scenario, an open loop. Queries
arrive by a Poisson process at the traffic's fixed rate (``qps``), each
one QSL batch; the arrival times are one draw, fixed by the traffic's
``arrival_seed``, and the run's seed draws the requests (their sizes and
ids) and the weights: a tail over some hundreds of queries swings with
the order of the gaps far more than between two runs of one schedule, so
every seed serves the same arrivals with other requests in them. One thread
serves the queries in order of arrival with
`HSTUModelFamily.predict`. A query's latency runs from when it was due to
when its predictions are on the device and the host has synchronised, so a
query that waits behind others counts the wait. The generator's lateness is
how long after it could have started a query it did (after its due time and
after the query before it ended). Queries due in the window that have not
ended a minute after it closes are failures."""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List

import numpy as np

from harness import ranker, synth
from harness.runner import Check, Window, quantile
from harness.trace import TraceSummary, traced

GRACE_S = 60.0


def arrivals(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times in [0, seconds) of a Poisson process of ``rate`` per second:
    rate x seconds gaps, the strata of the exponential distribution (the
    same gaps for every seed) in an order drawn from ``seed``."""
    n = int(round(rate * seconds))
    gaps = synth.stratified(np.random.default_rng(seed), n, lambda u: -math.log1p(-u) / rate)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return due[due < seconds]


def _sleep_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(left - 0.001 if left > 0.002 else 0)


def open_loop(predict, due: np.ndarray, t0: float, deadline: float, preds: List[Any]) -> Dict[str, Any]:
    """Serves the queries due at ``t0 + due`` in order; returns their
    latencies and lateness (seconds), the number left unfinished at
    ``deadline``, and the backlog (queries due but not started) when the
    last one was due."""
    lat, late, backlog = [], [], 0
    prev_done = t0
    t_last_due = t0 + (float(due[-1]) if len(due) else 0.0)
    for q, d in enumerate(due):
        t_due = t0 + float(d)
        if time.perf_counter() > deadline:
            return dict(latency=lat, late=late, unfinished=len(due) - q, backlog=backlog)
        _sleep_until(t_due)
        start = time.perf_counter()
        late.append(start - max(t_due, prev_done))
        if start >= t_last_due and backlog == 0:
            backlog = int(np.searchsorted(due, start - t0, side="right")) - q
        preds.append(predict(q))
        prev_done = time.perf_counter()
        lat.append(prev_done - t_due)
    return dict(latency=lat, late=late, unfinished=0, backlog=backlog)


def setup(cell, seed: int, device: str) -> Dict[str, Any]:
    return ranker.setup_serving(cell, seed, device)


def window(state: Dict[str, Any], seconds: float, trace: bool) -> Window:
    t = state["cell"].traffic
    predict, sync = ranker.predictor(state)
    traces: List[TraceSummary] = []
    if trace:
        sync()
        due = arrivals(t["qps"], t["trace_seconds"], t["arrival_seed"] + 1)
        with traced(traces):
            open_loop(predict, due, time.perf_counter(), float("inf"), [])
            sync()
    due = arrivals(t["qps"], seconds, t["arrival_seed"])
    t0 = time.perf_counter()
    r = open_loop(predict, due, t0, t0 + seconds + GRACE_S, state["preds"])
    lat_ms = [x * 1e3 for x in r["latency"]]
    return Window(
        e2e={"serve_p95_ms": quantile(lat_ms, 0.95) if lat_ms else float("inf")},
        attempted=len(due), failed=r["unfinished"], window_s=seconds,
        counters={"backlog_at_close": r["backlog"]},
        samples={"latency_ms": lat_ms, "late_ms": [x * 1e3 for x in r["late"]]},
        trace=traces[0] if traces else None,
    )


def check(state: Dict[str, Any]) -> List[Check]:
    return ranker.check_serving(state)


def control(cell, seed: int, device: str) -> Dict[str, Dict[str, float]]:
    return ranker.control_serving(cell, seed, device)
