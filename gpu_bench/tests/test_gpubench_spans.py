"""The metrics that read the program's spans, on made-up Chrome traces whose
shares are worked out by hand."""

import os
from types import SimpleNamespace

import pytest

from harness.registry import load_module
from harness.trace import TraceSummary

HARNESS_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = ("step.backward_share.train", "negatives.device_share.train", "loss.device_share.train")
SERVE = ("stu.device_share.serve", "lookup.device_share.serve", "serve.predict_idle_share.server")


def _read(metric, events):
    run = SimpleNamespace(trace=None if events is None else TraceSummary(events))
    return load_module(os.path.join(HARNESS_DIR, "metrics", metric + ".py")).read(run)


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid, "args": args}


def _launch(ts, corr, tid=1):
    return _x("cudaLaunchKernel", "cuda_runtime", ts, 1, tid=tid, correlation=corr)


def _kernel(name, ts, dur, corr):
    return _x(name, "kernel", ts, dur, tid=7, correlation=corr)


def _training(spans=True):
    """Window 0..200 on thread 1. Busy: 12..17, 35..55, 90..100, 102..112,
    150..160 = 55 us."""
    events = [
        _x("harness.window", "user_annotation", 0, 200),
        _launch(10, 1), _kernel("sgemm", 12, 5, 1),  # before the step's spans
        # the backward's kernel, launched from the autograd thread (2) while the caller waits
        _launch(30, 2, tid=2), _kernel("sgemm_bwd", 35, 20, 2),
        _launch(86, 3), _kernel("gather", 90, 10, 3),
        _launch(101, 4), _kernel("mul", 102, 10, 4),
        # launched inside a range of another thread (3) only: not the window's
        _launch(150, 5, tid=2), _kernel("adam", 150, 10, 5),
    ]
    if spans:
        events += [
            _x("train.backward", "user_annotation", 20, 60),
            _x("research.negatives", "user_annotation", 85, 10),
            _x("research.loss", "user_annotation", 100, 20),
            _x("train.backward", "user_annotation", 145, 25, tid=3),
        ]
    return events


def _serving(spans=True):
    """Window 0..100. Two predicts (10..30, 50..70) around one gap, a third
    (95..110) cut by the window's end. Busy: 15..40, 60..80 = 45 us."""
    events = [
        _x("harness.window", "user_annotation", 0, 100),
        _launch(12, 1), _kernel("int8_gather", 15, 5, 1),
        _launch(16, 2), _kernel("sgemm", 20, 20, 2),  # runs on past its predict's end
        _launch(52, 3), _kernel("int8_gather", 60, 5, 3),
        _launch(54, 4), _kernel("sgemm", 65, 15, 4),
    ]
    if spans:
        events += [
            _x("serve.predict", "user_annotation", 10, 20),
            _x("dlrm.lookup", "user_annotation", 11, 3),
            _x("dlrm.stu", "user_annotation", 14, 14),
            _x("serve.predict", "user_annotation", 50, 20),
            _x("dlrm.lookup", "user_annotation", 51, 2),
            _x("dlrm.stu", "user_annotation", 53, 16),
            _x("serve.predict", "user_annotation", 95, 15),
        ]
    return events


def test_training_shares_by_hand():
    assert _read("step.backward_share.train", _training()) == pytest.approx(100 * 20 / 55)
    assert _read("negatives.device_share.train", _training()) == pytest.approx(100 * 10 / 55)
    assert _read("loss.device_share.train", _training()) == pytest.approx(100 * 10 / 55)


def test_serving_shares_by_hand():
    assert _read("stu.device_share.serve", _serving()) == pytest.approx(100 * (20 + 15) / 45)
    assert _read("lookup.device_share.serve", _serving()) == pytest.approx(100 * (5 + 5) / 45)
    # inside the predicts 20 + 20 + 5 us; idle 10..15, 50..60 and 95..100
    assert _read("serve.predict_idle_share.server", _serving()) == pytest.approx(100 * (5 + 10 + 5) / 45)


@pytest.mark.parametrize("metric", TRAIN + SERVE)
def test_a_missing_span_reads_null(metric):
    events = _training(spans=False) if metric in TRAIN else _serving(spans=False)
    assert _read(metric, events) is None
    # the other trace's spans are not this metric's
    assert _read(metric, _serving() if metric in TRAIN else _training()) is None
    assert _read(metric, None) is None


@pytest.mark.parametrize("metric", TRAIN + SERVE)
def test_no_device_work_reads_null(metric):
    events = _training() if metric in TRAIN else _serving()
    assert _read(metric, [e for e in events if e["cat"] != "kernel"]) is None
