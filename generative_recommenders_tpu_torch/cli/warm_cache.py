"""Prebuilds the port's CUDA kernels (the counterpart of
`generative_recommenders_tpu/cli/warm_cache.py` and `utils/compile_cache.py`,
which fill the XLA compilation cache):

    python -m generative_recommenders_tpu_torch.cli.warm_cache [--force] [kernel ...]

Builds every kernel source under `csrc/` (or the ones named) through
`ops/cuda/build.build`, one nvcc each, all started together, into
``build/torch_port/``, each library stamped with the hash of its source,
headers and flags (its cache key: a later run rebuilds only what changed).
Prints each kernel's build seconds and whether it was built or already
current; a build failure exits nonzero with nvcc's output. Needs nvcc, not
a card.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

from generative_recommenders_tpu_torch.ops.cuda import build


def warm(names: Optional[List[str]] = None, force: bool = False) -> Dict[str, dict]:
    """{kernel: {"built": bool, "seconds": float, "hash": str, "log": str}}:
    builds what is missing or stale (everything with ``force``), all at
    once; "log" is nvcc's output (ptxas' registers and spills)."""
    names = list(build.KERNEL_SOURCES if not names else names)
    unknown = [n for n in names if n not in build.KERNEL_SOURCES]
    if unknown:
        raise ValueError(f"unknown kernels {unknown}; known: {sorted(build.KERNEL_SOURCES)}")
    built = build.build(names, force=force)
    return {
        n: {"built": n in built, "seconds": round(build.build_seconds[n], 3) if n in built else 0.0,
            "hash": build.source_hash(n)[:16], "log": built.get(n, "")}
        for n in names
    }


def main(argv: Optional[List[str]] = None) -> Dict[str, dict]:
    p = argparse.ArgumentParser()
    p.add_argument("kernels", nargs="*", help="kernel names (default: all)")
    p.add_argument("--force", action="store_true", help="rebuild even what is current")
    args = p.parse_args(argv)
    try:
        out = warm(args.kernels, args.force)
    except (RuntimeError, ValueError) as e:
        print(e, file=sys.stderr)
        raise SystemExit(1)
    for n, r in out.items():
        print(f"{n:24s} {'built' if r['built'] else 'current':8s} {r['seconds']:8.3f} s  {r['hash']}")
    print(json.dumps({n: {k: v for k, v in r.items() if k != "log"} for n, r in out.items()}))
    return out


if __name__ == "__main__":
    main()
