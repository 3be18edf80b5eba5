"""The Server cell's sweep of arrival rates, which fixed its rate: one
set-up, then the median latency of a lone query (each query issued after the
one before has ended and the card has idled), then an open loop at each
rate for ``--seconds``.

    python3 gpu_bench/sweep.py --workload <server cell> --seed <n> --rates 20,30,40 [--seconds 20]

One JSON line a rate: the median and 95th-percentile latency (ms), the
backlog (queries due but not started) when the last query was due, and the
rate completed. The knee is the highest rate whose p95 stays within four
times the lone query's median with no growing backlog; the cell runs at
four fifths of it.
"""

import argparse
import json
import os
import statistics
import sys
import time

HARNESS_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HARNESS_DIR, os.path.dirname(HARNESS_DIR)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from harness import ranker
    from harness.registry import find_cell
    from harness.runner import quantile

    cell = find_cell(args.workload)
    drv = cell.driver
    state = drv.setup(cell, args.seed, args.device)
    predict, sync = ranker.predictor(state)
    lone = []
    for q in range(40):
        time.sleep(0.02)
        t = time.perf_counter()
        predict(q)
        lone.append((time.perf_counter() - t) * 1e3)
    print(json.dumps({"lone_query_ms": {"median": statistics.median(lone), "p95": quantile(lone, 0.95)}}), flush=True)
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        due = drv.arrivals(rate, args.seconds, args.seed + 100 + i)
        t0 = time.perf_counter()
        r = drv.open_loop(predict, due, t0, t0 + args.seconds + drv.GRACE_S, [])
        lat = r["latency"]
        span = time.perf_counter() - t0
        print(json.dumps({
            "qps": rate, "queries": len(due), "median_ms": statistics.median(lat) * 1e3,
            "p95_ms": quantile(lat, 0.95) * 1e3, "backlog_at_last_due": r["backlog"],
            "completed_per_s": len(lat) / span, "late_p95_ms": quantile(r["late"], 0.95) * 1e3,
            "unfinished": r["unfinished"],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
