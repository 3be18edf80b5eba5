"""The traced run's device trace: `torch.profiler` over a steady sub-window
of the measured window, written as a Chrome trace to a temporary file, read
back into a summary, and deleted.

Device time is the union of the intervals of every kernel, copy and fill on
any stream, clipped to the sub-window (``harness.window``, a range the
harness records around it): a kernel that overlaps another is not counted
twice. The device time of a host range (PyTorch's ``Optimizer.step#...``)
is that of the kernels its launches started, matched by the profiler's
correlation ids.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import shutil
import tempfile
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

WINDOW_RANGE = "harness.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "python_function")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_NAME_LEN = 160

Interval = Tuple[float, float]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The intervals merged where they overlap or touch, in order."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals: Iterable[Interval]) -> float:
    return sum(e - s for s, e in union(intervals))


def _clip(iv: Interval, lo: float, hi: float) -> Optional[Interval]:
    s, e = max(iv[0], lo), min(iv[1], hi)
    return (s, e) if e > s else None


class TraceSummary:
    """What the per-layer metrics read from one traced sub-window. Times in
    seconds; the Chrome trace's are microseconds."""

    def __init__(self, events: Sequence[dict]) -> None:
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        wins = [e for e in xs if e.get("name") == WINDOW_RANGE and e.get("cat") in _HOST_CATS]
        if not wins:
            raise ValueError(f"the trace holds no {WINDOW_RANGE!r} range")
        win = wins[0]
        self._lo, self._hi = float(win["ts"]), float(win["ts"]) + float(win["dur"])
        self._host_tid = (win.get("pid"), win.get("tid"))
        self.window_s = (self._hi - self._lo) * 1e-6
        self.device: List[Tuple[str, Interval, Optional[int]]] = []
        for e in xs:
            if e.get("cat") in _DEVICE_CATS:
                iv = _clip((float(e["ts"]), float(e["ts"]) + float(e["dur"])), self._lo, self._hi)
                if iv is not None:
                    self.device.append((str(e.get("name", "")), iv, (e.get("args") or {}).get("correlation")))
        self._busy = union(iv for _, iv, _ in self.device)
        self.busy_s = sum(e - s for s, e in self._busy) * 1e-6
        self._launch_ts: Dict[int, float] = {}
        for e in xs:
            if e.get("cat") in _LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    self._launch_ts[corr] = float(e["ts"])
        self._host = [
            (str(e.get("name", "")), float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in xs
            if e.get("cat") in _HOST_CATS and (e.get("pid"), e.get("tid")) == self._host_tid
        ]

    @property
    def idle_share(self) -> Optional[float]:
        return None if self.window_s <= 0 else 1.0 - self.busy_s / self.window_s

    def kernel_time(self, patterns: Sequence[str]) -> Tuple[float, int]:
        """(seconds covered, launches) of the device operations whose name
        holds one of ``patterns``."""
        hits = [iv for name, iv, _ in self.device if any(p in name for p in patterns)]
        return covered(hits) * 1e-6, len(hits)

    def range_device_time(self, prefix: str) -> float:
        """Seconds covered by the device operations launched inside host
        ranges whose name starts with ``prefix``."""
        ranges = [(s, e) for name, s, e in self._host if name.startswith(prefix)]
        if not ranges:
            return 0.0
        ranges.sort()
        starts = [s for s, _ in ranges]
        hits = []
        for _, iv, corr in self.device:
            ts = self._launch_ts.get(corr) if corr is not None else None
            if ts is None:
                continue
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ranges[i][0] <= ts <= ranges[i][1]:
                hits.append(iv)
        return covered(hits) * 1e-6

    def device_ops(self, top: int = 10) -> List[List]:
        """The device operations that took most time, summed by name."""
        by_name: Dict[str, float] = {}
        for name, (s, e), _ in self.device:
            key = name[:_NAME_LEN]
            by_name[key] = by_name.get(key, 0.0) + (e - s) * 1e-6
        return [[n, t] for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The device's idle time inside the sub-window, summed by what the
        host thread was doing at each gap's middle (its innermost range)."""
        gaps, t = [], self._lo
        for s, e in self._busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self._hi > t:
            gaps.append((t, self._hi))
        # one thread's ranges nest: a sweep in time order keeps the stack of
        # those open, whose top is the innermost at each gap's middle
        host = sorted((hs, he, name) for name, hs, he in self._host if name != WINDOW_RANGE)
        by_what: Dict[str, float] = {}
        stack: List[Tuple[float, str]] = []
        k = 0
        for s, e in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = 0.5 * (s + e)
            while k < len(host) and host[k][0] <= mid:
                while stack and stack[-1][0] < host[k][0]:
                    stack.pop()
                stack.append((host[k][1], host[k][2]))
                k += 1
            while stack and stack[-1][0] < mid:
                stack.pop()
            what = stack[-1][1][:_NAME_LEN] if stack else "host: outside any range"
            by_what[what] = by_what.get(what, 0.0) + (e - s) * 1e-6
        return [[n, t] for n, t in sorted(by_what.items(), key=lambda kv: -kv[1])[:top]]


@contextlib.contextmanager
def traced(out: List[TraceSummary]) -> Iterator[None]:
    """Profiles the block (host and, with a card, device activity) and
    appends its `TraceSummary` to ``out``. The caller synchronises the
    device at the block's ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    tmp = tempfile.mkdtemp(prefix="gpu_bench_trace_")
    try:
        with profile(activities=acts) as prof:
            with record_function(WINDOW_RANGE):
                yield
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        out.append(TraceSummary(events))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
