"""Driver: the ranking service's Offline scenario. `HSTUModelFamily.predict`
(`inference/model_family.py`, dense, int8 tables) takes the queries back to
back, each one QSL batch, cycled; a query ends when its predictions are on
the device and the host has synchronised, as `inference/main.py` times it."""

from __future__ import annotations

import time
from typing import Any, Dict, List

from harness import ranker
from harness.runner import Check, Window
from harness.trace import TraceSummary, traced


def setup(cell, seed: int, device: str) -> Dict[str, Any]:
    return ranker.setup_serving(cell, seed, device)


def window(state: Dict[str, Any], seconds: float, trace: bool) -> Window:
    cell, qsl = state["cell"], state["qsl"]
    ref, cfg, t = cell.reference, cell.config, cell.traffic
    predict, sync = ranker.predictor(state)
    count = lambda: sum(c.count for c in state["launches"])  # noqa: E731
    traces: List[TraceSummary] = []
    calls, flops_traced, entries = [], 0.0, 0
    if trace:
        sync()
        before = count()
        with traced(traces):
            for q in range(t["trace_queries"]):
                predict(q)
                calls += ref.attention_calls(cfg, t, qsl[q % len(qsl)])
            sync()
        entries = count() - before
    preds = state["preds"]
    n_cands, flops, q = 0, 0.0, 0
    t0 = time.perf_counter()
    t_end, t_last = t0 + seconds, t0
    while time.perf_counter() < t_end:
        p = predict(q)
        done = time.perf_counter()
        if done > t_end:
            break
        preds.append(p)
        batch = qsl[q % len(qsl)]
        n_cands += ranker.live_candidates(batch)
        flops += ref.forward_flops(cfg, t, batch)
        t_last = done
        q += 1
    window_s = t_last - t0
    return Window(
        e2e={"serve_candidates_per_s": n_cands / window_s if window_s > 0 else 0.0},
        attempted=q, failed=0, window_s=window_s,
        counters={"attention_entry_calls": entries},
        work={"model_flops": flops, "traced_attention_calls": calls},
        trace=traces[0] if traces else None,
    )


def check(state: Dict[str, Any]) -> List[Check]:
    return ranker.check_serving(state)


def control(cell, seed: int, device: str) -> Dict[str, Dict[str, float]]:
    return ranker.control_serving(cell, seed, device)
