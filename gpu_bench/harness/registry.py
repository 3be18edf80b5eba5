"""Finds a cell's pieces by the names in `BENCHMARK.json`.

Everything that belongs to one configuration, traffic mix, driver or
per-layer metric sits in a file of its own under the harness's folder:

  configs/<config>.json     the configuration as it is run (the file that
                            `BENCHMARK.json` names for it)
  reference/<config>.py     its plain reference and its counts of operations
                            and bytes
  traffic/<mix>.json        the traffic mix's parameters and its driver's name
  drivers/<driver>.py       the driver that sets up, runs the window and checks
  metrics/<metric>.py       a per-layer metric and the arithmetic that reads it

A later cell, mix or metric is added as new files and entries; no file here
needs an edit for it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Any, Dict, List, Optional

HARNESS_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT_DIR = os.path.dirname(HARNESS_DIR)

_loaded: Dict[str, ModuleType] = {}


def load_module(path: str) -> ModuleType:
    """The Python file at ``path`` as a module, loaded once per process."""
    path = os.path.abspath(path)
    if path not in _loaded:
        name = "gpu_bench_" + re.sub(r"[^0-9A-Za-z_]", "_", os.path.relpath(path, HARNESS_DIR))[:-3]
        spec = importlib.util.spec_from_file_location(name, path)
        if spec is None or spec.loader is None:
            raise FileNotFoundError(path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _loaded[path] = module
    return _loaded[path]


def _read_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of `BENCHMARK.json` with everything it names, found by name."""

    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]
    traffic_name: str
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]  # the end-to-end metrics this cell reports
    per_layer: List[Dict[str, Any]]  # the per-layer metrics this cell reports
    harness_dir: str

    @property
    def driver(self) -> ModuleType:
        return load_module(os.path.join(self.harness_dir, "drivers", self.traffic["driver"] + ".py"))

    @property
    def reference(self) -> ModuleType:
        return load_module(os.path.join(self.harness_dir, "reference", self.config_name + ".py"))

    def metric_module(self, name: str) -> ModuleType:
        return load_module(os.path.join(self.harness_dir, "metrics", name + ".py"))


def _applies(metric: Dict[str, Any], cell: str, reported: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    # a metric without a list applies where its end-to-end metric is reported
    return metric.get("moves") in reported if "moves" in metric else True


def find_cell(name: str, checkout: str = CHECKOUT_DIR, harness_dir: str = HARNESS_DIR) -> Cell:
    """The cell ``name`` of ``checkout``'s `BENCHMARK.json`, its configuration
    and traffic read from their files."""
    bench = _read_json(os.path.join(checkout, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, [])]
    reported = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config_name=w["config"],
        config=_read_json(os.path.join(checkout, cfg_entry["file"])),
        traffic_name=w["traffic"],
        traffic=_read_json(os.path.join(harness_dir, "traffic", w["traffic"] + ".json")),
        end_to_end=e2e,
        per_layer=per_layer,
        harness_dir=harness_dir,
    )


def metric_value(module: ModuleType, run: Any) -> Optional[float]:
    """A per-layer metric's reading of a traced run; None where it finds
    nothing to read."""
    value = module.read(run)
    return None if value is None else float(value)
