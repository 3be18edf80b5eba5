"""One run of one cell: the driver's set-up, its measured window, the
comparison with the plain reference, and the result line.

A driver module (``drivers/<name>.py``) has three functions, and a fourth
that `control.py` calls:

  setup(cell, seed, device) -> state      build, load, warm up every shape;
                                          counted in ``setup_s``
  window(state, seconds, trace) -> Window the measured window (and with
                                          ``trace`` a profiled sub-window)
  check(state) -> [Check]                 once the window has closed and the
                                          program's state is freed: the
                                          comparison that decides ``correct``
  control(cell, seed, device) -> {name: {check: value}}
                                          the comparison's numbers for the
                                          control and planted faults, with no
                                          program run
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import sys
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

from harness.registry import Cell, metric_value
from harness.trace import TraceSummary, traced

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "generative_recommenders_tpu")


@dataclasses.dataclass
class Check:
    """One number compared with the reference, and its limit (at most)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Window:
    """What a measured window gives the metrics."""

    e2e: Dict[str, float]  # the end-to-end metrics this window measured
    attempted: int
    failed: int
    window_s: float
    timers: Dict[str, float] = dataclasses.field(default_factory=dict)  # seconds, by what they time
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    samples: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    work: Dict[str, Any] = dataclasses.field(default_factory=dict)  # counted work (operations, calls)
    trace: Optional[TraceSummary] = None
    cell: Optional[Cell] = None


def forbidden_modules() -> List[str]:
    """The modules loaded in this process whose top-level name is JAX's,
    its libraries' or the JAX package's (the whole name before the first dot)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def training_checks(prog: Dict[str, Any], ref: Dict[str, Any], limits: Dict[str, float]) -> List[Check]:
    """A training cell's program readings (``losses``, ``grad_norms``,
    ``change_norms``) against the reference's: each step's loss, relative;
    the first gradient and the change after the last step by the worst leaf,
    the gap between the two norms against the larger of the reference's norm
    of that leaf and of the median leaf. Leaves whose reference gradient is
    under a thousandth of the median leaf's move by round-off alone and are
    left out of the change."""
    names = list(ref["grad_norms"])
    med_g = statistics.median(ref["grad_norms"].values())
    moved = [n for n in names if ref["grad_norms"][n] >= 1e-3 * med_g]

    def worst(what: str, p: Dict[str, float], r: Dict[str, float], keep: List[str]) -> float:
        med = statistics.median(r[n] for n in keep)
        gap, leaf = max((abs(p[n] - r[n]) / max(r[n], med), n) for n in keep)
        log(f"{what}: worst leaf {leaf} ({p[leaf]!r} against {r[leaf]!r}; median leaf {med!r})")
        return gap

    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    return [
        Check("loss_gap", loss_gap, limits["loss_gap"]),
        Check("grad_gap", worst("grad_gap", prog["grad_norms"], ref["grad_norms"], names), limits["grad_gap"]),
        Check("change_gap", worst("change_gap", prog["change_norms"], ref["change_norms"], moved), limits["change_gap"]),
    ]


def quantile(values: List[float], q: float) -> float:
    """The q-quantile (0..1) of ``values``, linearly interpolated."""
    xs = sorted(values)
    if not xs:
        return float("nan")
    pos = q * (len(xs) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def train_window(
    feed: Iterator[Any],
    step: Callable[[Any], float],
    examples: Callable[[Any], int],
    work: Callable[[Any], Dict[str, Any]],
    launches: Callable[[], int],
    seconds: float,
    trace_steps: int,
    sync: Callable[[], None],
) -> Window:
    """The training window: steps run back to back for ``seconds``; a step
    ends when its loss is on the host. Its rate counts the examples of every
    step that ended inside the window, over the time from the window's start
    to the last of them. With ``trace_steps`` a profiled sub-window of that
    many steps comes first, read apart: what the per-layer metrics time
    (data waits, operations per second) is taken from the window that
    follows it, without the profiler."""
    traces: List[TraceSummary] = []
    traced_work: List[Dict[str, Any]] = []
    launches_traced = 0
    if trace_steps:
        sync()
        before = launches()
        with traced(traces):
            for _ in range(trace_steps):
                batch = next(feed)
                step(batch)
                traced_work.append(work(batch))
            sync()
        launches_traced = launches() - before
    wait_s, n_ex, n_steps, failed, flops = 0.0, 0, 0, 0, 0.0
    t0 = time.perf_counter()
    t_end, t_last = t0 + seconds, t0
    while True:
        t = time.perf_counter()
        if t >= t_end:
            break
        batch = next(feed)
        wait_s += time.perf_counter() - t
        loss = step(batch)
        t_done = time.perf_counter()
        if t_done > t_end:
            break  # ended after the window: not counted
        n_steps += 1
        failed += 0 if math.isfinite(loss) else 1
        n_ex += examples(batch)
        flops += work(batch).get("model_flops", 0.0)
        t_last = t_done
    window_s = t_last - t0
    return Window(
        e2e={"train_examples_per_s": n_ex / window_s if window_s > 0 else 0.0},
        attempted=n_steps,
        failed=failed,
        window_s=window_s,
        timers={"data_wait_s": wait_s},
        counters={"attention_entry_calls": launches_traced},
        work={
            "model_flops": flops,
            "traced_attention_calls": [c for w in traced_work for c in w.get("attention_calls", [])],
        },
        trace=traces[0] if traces else None,
    )


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str, t_start: float) -> dict:
    """Runs ``cell`` once and returns its result line (a dict)."""
    import torch

    drv = cell.driver
    state = drv.setup(cell, seed, device)
    setup_s = time.perf_counter() - t_start
    log(f"setup {setup_s:.2f} s")
    win = drv.window(state, seconds, trace)
    win.cell = cell
    log(f"window {time.perf_counter() - t_start - setup_s:.2f} s ({win.window_s:.3f} s measured)")
    on_card = device != "cpu"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    t_check = time.perf_counter()
    checks = drv.check(state)
    log(f"reference and comparison {time.perf_counter() - t_check:.2f} s")
    metrics: Dict[str, Dict[str, Any]] = {}
    if not trace:
        values = dict(win.e2e, setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = metric_value(cell.metric_module(m["name"]), win)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev: Dict[str, Any] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
    }
    line: Dict[str, Any] = {
        "correct": all(c.ok for c in checks) and bool(checks),
        "attempted": win.attempted,
        "failed": win.failed,
        "metrics": metrics,
        "device": dev,
    }
    if trace and win.trace is not None:
        dev["busy_s"] = win.trace.busy_s
        dev["window_s"] = win.trace.window_s
        line["breakdown"] = {"device_ops": win.trace.device_ops(), "idle_gaps": win.trace.idle_gaps()}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return line


def log(msg: str) -> None:
    print(f"[gpu_bench] {msg}", file=sys.stderr, flush=True)
