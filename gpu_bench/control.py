"""The control and the planted faults of a cell's comparison, read on the
card at the cell's own size (the benchmark's runs do not run them):

    python3 gpu_bench/control.py --workload <name> --seeds <n>,<n>,...

For each seed it prints one JSON line: the numbers the comparison reads for
the control (the reference in the precision below the configuration's) and
for each fault the driver plants, each against the limit the benchmark
holds it to. A limit lies between the program's readings and these.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HARNESS_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HARNESS_DIR, os.path.dirname(HARNESS_DIR)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from harness.registry import find_cell

    cell = find_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        readings = cell.driver.control(cell, seed, args.device)
        print(json.dumps({"workload": cell.name, "seed": seed, "readings": readings,
                          "limits": cell.reference.LIMITS}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
