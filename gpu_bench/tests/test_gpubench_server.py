"""The Server cell's open loop times each query from when it was due, so a
query that waits behind another counts the wait, and it reports how late
the generator itself started each query."""

import os
import time

import pytest

from harness.registry import load_module

HARNESS_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
server = load_module(os.path.join(HARNESS_DIR, "drivers", "serve_server.py"))


def test_latency_runs_from_the_due_time():
    service = 0.05
    due = [0.0, 0.01, 0.02, 0.3]  # three at once queue up; the fourth finds the server idle

    def predict(q):
        time.sleep(service)
        return q

    preds = []
    t0 = time.perf_counter()
    r = server.open_loop(predict, due, t0, t0 + 60.0, preds)
    assert preds == [0, 1, 2, 3] and r["unfinished"] == 0
    lat = r["latency"]
    # the k-th of the first three waits for the k before it
    for k in range(3):
        assert lat[k] == pytest.approx((k + 1) * service - due[k], abs=0.02)
    assert lat[3] == pytest.approx(service, abs=0.02)
    # the generator started each query as soon as it could
    assert max(r["late"]) < 0.01


def test_lateness_counts_a_late_start():
    """A generator that oversleeps shows its lateness, and the latency holds it."""
    real_sleep = server._sleep_until

    def oversleep(t):
        real_sleep(t + 0.03)

    server._sleep_until = oversleep
    try:
        t0 = time.perf_counter()
        r = server.open_loop(lambda q: q, [0.0, 0.2], t0, t0 + 60.0, [])
    finally:
        server._sleep_until = real_sleep
    assert min(r["late"]) >= 0.025
    assert min(r["latency"]) >= 0.025


def test_queries_left_at_the_deadline_are_failures():
    t0 = time.perf_counter()
    r = server.open_loop(lambda q: time.sleep(0.05), [0.0, 0.0, 0.0, 0.0], t0, t0 + 0.08, [])
    assert r["unfinished"] >= 1 and len(r["latency"]) + r["unfinished"] == 4
