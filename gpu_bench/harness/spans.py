"""The arithmetic of the per-layer metrics that read the program's own spans
(`generative_recommenders_tpu_torch/utils/profiling.py:span`) in the traced
sub-window's `TraceSummary`. A span is matched by its exact name on the
window's thread (the thread that calls the model); a trace that holds no
such span reads None, never 0."""

from __future__ import annotations

from typing import List, Optional

from harness.trace import Interval, TraceSummary, covered


def _spans(t: TraceSummary, name: str) -> List[Interval]:
    """The intervals of the window thread's ranges named ``name``, clipped to
    the sub-window."""
    out = []
    for n, s, e in t._host:
        s, e = max(s, t._lo), min(e, t._hi)
        if n == name and e > s:
            out.append((s, e))
    return out


def device_share(run, name: str) -> Optional[float]:
    """Device time launched inside the span ``name`` (from any thread, while
    the span is open), as a share of the sub-window's device busy time, in %."""
    t = run.trace
    if t is None or t.busy_s <= 0 or not _spans(t, name):
        return None
    return 100.0 * t.range_device_time(name) / t.busy_s


def idle_share(run, name: str) -> Optional[float]:
    """Share of the time inside the span ``name`` in which no kernel, copy or
    fill ran on the card, in %; None where nothing ran on a card at all."""
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    spans = _spans(t, name)
    inside = covered(spans)
    if inside <= 0:
        return None
    # the part of the spans that no device interval covers
    return 100.0 * (covered(spans + t._busy) - covered(t._busy)) / inside
