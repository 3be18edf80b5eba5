"""Runs one cell several times, one process a run, and summarises the spread
of every metric: the median, the quartiles (Python's
`statistics.quantiles(values, n=4)`) and the spread (Q3 - Q1) / median,
each set on its own and both together.

    python3 gpu_bench/sets.py --workload <name> --seeds <n>,<n>,... [--sets 2]
        [--seconds <s>] [--trace 0|1] [--out <file>]

Every set runs the same seeds in the same order. The result lines and the
summary go to standard output as JSON, and to ``--out`` when given.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HARNESS_DIR = os.path.dirname(os.path.abspath(__file__))
CHECKOUT_DIR = os.path.dirname(HARNESS_DIR)


def spread(values):
    """(median, Q1, Q3, (Q3 - Q1) / median) of ``values``."""
    if len(values) < 2:
        v = values[0] if values else float("nan")
        return v, v, v, 0.0
    q1, med, q3 = statistics.quantiles(values, n=4)
    return med, q1, q3, (q3 - q1) / abs(med) if med else float("nan")


def run_once(workload, seed, seconds, trace):
    cmd = [sys.executable, os.path.join(HARNESS_DIR, "run.py"), "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)]
    t = time.perf_counter()
    p = subprocess.run(cmd, cwd=CHECKOUT_DIR, capture_output=True, text=True)
    wall = time.perf_counter() - t
    lines = p.stdout.strip().splitlines()
    try:
        line = json.loads(lines[-1]) if p.returncode == 0 and lines else None
    except json.JSONDecodeError:
        line = None
    return {"seed": seed, "rc": p.returncode, "wall_s": wall, "line": line,
            "stderr_tail": p.stderr[-1500:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seconds = args.seconds
    if seconds is None:
        with open(os.path.join(CHECKOUT_DIR, "BENCHMARK.json")) as f:
            seconds = json.load(f)["run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",")]
    runs = []
    for k in range(args.sets):
        for seed in seeds:
            r = run_once(args.workload, seed, seconds, args.trace)
            r["set"] = k
            runs.append(r)
            print(json.dumps(r), flush=True)
    summary = {}
    names = sorted({m for r in runs if r["line"] for m in r["line"]["metrics"]})
    for name in names:
        per = {}
        for k in list(range(args.sets)) + ["all"]:
            vals = [r["line"]["metrics"][name]["value"] for r in runs
                    if r["line"] and name in r["line"]["metrics"] and (k == "all" or r["set"] == k)]
            per[str(k)] = dict(zip(("median", "q1", "q3", "spread"), spread(vals)), n=len(vals))
        summary[name] = per
    checks = {}
    for r in runs:
        for c, v in ((r["line"] or {}).get("checks") or {}).items():
            checks.setdefault(c, []).append(v["value"])
    out = {"workload": args.workload, "seconds": seconds, "seeds": seeds,
           "correct": [bool(r["line"] and r["line"]["correct"]) for r in runs],
           "summary": summary, "checks_max": {c: max(v) for c, v in checks.items()}}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"runs": runs, "summary": out}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
