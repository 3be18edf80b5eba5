"""ctypes bindings to the C++ load generator `csrc/loadgen.cpp` (the port's
own copy of `generative_recommenders_tpu/inference/loadgen.py`).

The C++ side owns the scenario schedule (Offline, Server with Poisson
arrivals, SingleStream, MultiStream), timing and latency bookkeeping;
Python supplies the `issue_query` callback and calls `query_complete`. The
library is built with g++ on first use into `build/torch_port/`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import enum
import logging
import os
import subprocess
from typing import Callable, Dict, Optional

logger = logging.getLogger(__name__)

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_SRC = os.path.join(_REPO_ROOT, "csrc", "loadgen.cpp")
_LIB_DIR = os.path.join(_REPO_ROOT, "build", "torch_port")
_LIB = os.path.join(_LIB_DIR, "libloadgen.so")


class Scenario(enum.IntEnum):
    OFFLINE = 0
    SERVER = 1
    SINGLE_STREAM = 2
    MULTI_STREAM = 3


class _CSettings(ctypes.Structure):
    _fields_ = [
        ("scenario", ctypes.c_int32),
        ("target_qps", ctypes.c_double),
        ("min_query_count", ctypes.c_int64),
        ("min_duration_ms", ctypes.c_int64),
        ("seed", ctypes.c_int64),
        ("target_latency_ns", ctypes.c_int64),
        ("target_percentile", ctypes.c_double),
        ("enable_early_stopping", ctypes.c_int32),
    ]


@dataclasses.dataclass
class TestSettings:
    scenario: Scenario = Scenario.OFFLINE
    target_qps: float = 10.0
    min_query_count: int = 64
    min_duration_ms: int = 0
    seed: int = 0
    # latency constraint + early stopping (`loadgen/early_stopping.cc`):
    # MLPerf percentiles are p90 SingleStream, p99 MultiStream/Server
    target_latency_ms: float = 0.0  # 0 = unconstrained
    target_percentile: float = 0.9
    enable_early_stopping: bool = True
    # MultiStream: samples per query (the SUT batches this many per issue)
    samples_per_query: int = 8


_ISSUE_CB_T = ctypes.CFUNCTYPE(None, ctypes.c_int64)


def _build_library() -> str:
    os.makedirs(_LIB_DIR, exist_ok=True)
    if (
        os.path.exists(_LIB)
        and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)
    ):
        return _LIB
    cmd = [
        "g++", "-O2", "-shared", "-fPIC", "-pthread", "-std=c++17",
        "-o", _LIB, _SRC,
    ]
    logger.info("building loadgen: %s", " ".join(cmd))
    subprocess.run(cmd, check=True)
    return _LIB


_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_build_library())
        lib.lg_start_test.argtypes = [_CSettings, _ISSUE_CB_T]
        lib.lg_query_complete.argtypes = [ctypes.c_int64]
        lib.lg_query_count.restype = ctypes.c_int64
        lib.lg_achieved_qps.restype = ctypes.c_double
        lib.lg_latency_ns.argtypes = [ctypes.c_double]
        lib.lg_latency_ns.restype = ctypes.c_int64
        lib.lg_early_stopped.restype = ctypes.c_int32
        lib.lg_latency_bound_ok.restype = ctypes.c_int32
        lib.lg_min_queries_for_early_stop.argtypes = [
            ctypes.c_int64, ctypes.c_double,
        ]
        lib.lg_min_queries_for_early_stop.restype = ctypes.c_int64
        _lib = lib
    return _lib


def query_complete(query_id: int) -> None:
    _load().lg_query_complete(query_id)


def start_test(
    settings: TestSettings, issue_query: Callable[[int], None]
) -> Dict[str, float]:
    """Runs the scenario (blocking); returns qps + latency percentiles."""
    lib = _load()
    cb = _ISSUE_CB_T(lambda qid: issue_query(int(qid)))
    c_settings = _CSettings(
        scenario=int(settings.scenario),
        target_qps=float(settings.target_qps),
        min_query_count=int(settings.min_query_count),
        min_duration_ms=int(settings.min_duration_ms),
        seed=int(settings.seed),
        target_latency_ns=int(settings.target_latency_ms * 1e6),
        target_percentile=float(settings.target_percentile),
        enable_early_stopping=int(settings.enable_early_stopping),
    )
    lib.lg_start_test(c_settings, cb)
    result = {
        "qps": float(lib.lg_achieved_qps()),
        "query_count": float(lib.lg_query_count()),
    }
    for p in (50.0, 80.0, 90.0, 95.0, 99.0, 99.9):
        ns = lib.lg_latency_ns(ctypes.c_double(p))
        result[f"p{p:g}_ms"] = ns / 1e6 if ns >= 0 else float("nan")
    result["early_stopped"] = float(lib.lg_early_stopped())
    result["latency_bound_ok"] = float(lib.lg_latency_bound_ok())
    return result
