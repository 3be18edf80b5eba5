"""The arithmetic of the roofline and peak shares. The numbers (peaks,
bandwidth, kernel names) are the metric files' own."""

from __future__ import annotations

from typing import Dict, Optional, Sequence


def precision(config: dict) -> str:
    """"bfloat16" where the configuration's precision says so, else "float32"."""
    return "bfloat16" if "bfloat16" in config.get("precision", "") else "float32"


def attention_share(run, patterns: Sequence[str], hbm_bytes_per_s: float,
                    peak_flops: Dict[str, float]) -> Optional[float]:
    """The least time of the traced sub-window's attention calls (each the
    larger of its bytes over the bandwidth and its operations over the
    precision's peak) over the device time of the kernels named by
    ``patterns``, in %. None without a trace or calls, or where the trace
    matched fewer kernel launches than the program's counters saw calls."""
    t, calls = run.trace, run.work.get("traced_attention_calls") or []
    if t is None or not calls:
        return None
    seconds, launches = t.kernel_time(patterns)
    if seconds <= 0 or launches < run.counters.get("attention_entry_calls", 0):
        return None
    peak = peak_flops[precision(run.cell.config)]
    bound = sum(max(b / hbm_bytes_per_s, ops / peak) for ops, b in calls)
    return 100.0 * bound / seconds


def peak_share(run, peak_flops: Dict[str, float]) -> Optional[float]:
    """The window's counted operations over its time and the precision's
    peak, in %."""
    flops = run.work.get("model_flops", 0.0)
    if flops <= 0 or run.window_s <= 0:
        return None
    return 100.0 * flops / run.window_s / peak_flops[precision(run.cell.config)]
