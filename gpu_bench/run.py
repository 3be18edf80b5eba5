"""Runs one cell of the benchmark once, on the card, and prints its result.

    python3 gpu_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It loads, warms up, measures for ``--seconds``,
checks what the timed path produced against the plain reference, and prints
one JSON line last on standard output: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics and the device
trace's summary. The numbers compared with the reference, each beside its
limit, come last on standard error and under ``checks`` in the line. It
exits with another code than 0, and prints no result, without a card, with
fewer cards than the cell asks for, or when JAX or the JAX package was
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HARNESS_DIR = os.path.dirname(os.path.abspath(__file__))
CHECKOUT_DIR = os.path.dirname(HARNESS_DIR)


def _cache_dirs() -> None:
    """Every kernel cache at a fixed path inside the checkout (the port's own
    nvcc build directory, `build/torch_port/`, already is)."""
    build = os.path.join(CHECKOUT_DIR, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()
    for path in (HARNESS_DIR, CHECKOUT_DIR):
        if path not in sys.path:
            sys.path.insert(0, path)
    from harness.registry import find_cell
    from harness.runner import forbidden_modules, run_cell

    cell = find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(
            f"needs {cell.chips} CUDA card(s); available: {torch.cuda.is_available()}, "
            f"count {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
            file=sys.stderr,
        )
        return 3
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
