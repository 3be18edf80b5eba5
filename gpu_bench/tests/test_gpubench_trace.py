"""The device trace's reduction on a made-up Chrome trace."""

import pytest

from harness.trace import TraceSummary, union


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid, "args": args}


def _events():
    return [
        _x("harness.window", "user_annotation", 0, 100),
        _x("Optimizer.step#AdamW.step", "user_annotation", 60, 25),
        _x("aten::mm", "cpu_op", 5, 10),
        _x("cudaLaunchKernel", "cuda_runtime", 6, 1, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 62, 1, correlation=2),
        _x("cudaLaunchKernel", "cuda_runtime", 64, 1, correlation=3),
        _x("void hstu_fwd::fwd_kernel<32>(x)", "kernel", 10, 20, tid=7, correlation=1),
        _x("sgemm", "kernel", 25, 10, tid=8),  # overlaps the first on another stream
        _x("adam", "kernel", 65, 10, tid=7, correlation=2),
        _x("adam", "kernel", 90, 20, tid=7, correlation=3),  # runs past the window: clipped
    ]


def test_union_merges_overlaps():
    assert union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]


def test_summary():
    t = TraceSummary(_events())
    assert t.window_s == pytest.approx(100e-6)
    # 10..35 and 65..75 and 90..100
    assert t.busy_s == pytest.approx(45e-6)
    assert t.idle_share == pytest.approx(0.55)
    assert t.kernel_time(["hstu_fwd::"]) == (pytest.approx(20e-6), 1)
    assert t.range_device_time("Optimizer.step#") == pytest.approx(20e-6)
    ops = dict((n, s) for n, s in t.device_ops())
    assert ops["adam"] == pytest.approx(20e-6)
    gaps = dict((n, s) for n, s in t.idle_gaps())
    # 0..10 inside aten::mm (5..15) at its middle 5; 35..65 and 75..90 in the optimizer or outside
    assert gaps["aten::mm"] == pytest.approx(10e-6)
    assert gaps["Optimizer.step#AdamW.step"] == pytest.approx(15e-6)
    assert gaps["host: outside any range"] == pytest.approx(30e-6)
