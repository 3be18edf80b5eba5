"""Prebuilds the port's CUDA kernels (the counterpart of
`generative_recommenders_tpu/cli/warm_cache.py` and `utils/compile_cache.py`,
which fill the XLA compilation cache):

    python -m generative_recommenders_tpu_torch.cli.warm_cache [--force] [--ptxas] [kernel ...]

Builds every kernel source under `csrc/` (or the ones named) through
`ops/cuda/build.build`, one nvcc each, all started together, into
``build/torch_port/``, each library stamped with the hash of its source,
headers and flags (its cache key: a later run rebuilds only what changed).
Prints each kernel's build seconds and whether it was built or already
current; a build failure exits nonzero with nvcc's output; with
``--ptxas``, each built kernel's registers and spills per instance. Needs
nvcc, not a card.
"""

from __future__ import annotations

import argparse
import json
import re
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


def _function(mangled: str) -> str:
    """The unqualified function name of a mangled `ns::fn<...>` symbol (the
    last name of its `_ZN <length><name> ...` prefix), or the symbol."""
    names, i = [], 3
    while mangled.startswith("_ZN") and i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        names.append(mangled[j:j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
    return names[-1] if names else mangled


def ptxas_report(log: str) -> str:
    """ptxas -v's report in one line: per instance (named by its function and
    its template arguments: the padded width first, bf16 for a bfloat16
    instance) its registers and its spill stores / loads where it spills."""
    entries, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            args = ",".join(a or b or "bf16" for a, b, c in re.findall(
                r"Li(\d+)E|Lb([01])E|(13__nv_bfloat16)(?!Ex)", mangled))
            entry = f"{_function(mangled)} {args}".strip()
            entries[entry] = ["?", ""]
        elif entry and "bytes spill stores" in line and not line.strip().endswith(
                "0 bytes spill stores, 0 bytes spill loads"):
            stores, loads = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            entries[entry][1] = f", spill {stores} / {loads} bytes"
        elif entry and line.lstrip().startswith("ptxas info") and "registers" in line:
            entries[entry][0] = re.search(r"Used (\d+) registers", line).group(1)
    return "; ".join(f"<{k}> {r} registers{sp}" for k, (r, sp) in entries.items())


def main(argv: Optional[List[str]] = None) -> Dict[str, dict]:
    p = argparse.ArgumentParser()
    p.add_argument("kernels", nargs="*", help="kernel names (default: all)")
    p.add_argument("--force", action="store_true", help="rebuild even what is current")
    p.add_argument("--ptxas", action="store_true", help="print each built kernel's registers and spills")
    args = p.parse_args(argv)
    try:
        out = warm(args.kernels, args.force)
    except (RuntimeError, ValueError) as e:
        print(e, file=sys.stderr)
        raise SystemExit(1)
    for n, r in out.items():
        print(f"{n:24s} {'built' if r['built'] else 'current':8s} {r['seconds']:8.3f} s  {r['hash']}")
        if args.ptxas and r["built"]:
            print(f"  {ptxas_report(r['log'])}")
    print(json.dumps({n: {k: v for k, v in r.items() if k != "log"} for n, r in out.items()}))
    return out


if __name__ == "__main__":
    main()
