"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each kernel source under `generative_recommenders_tpu_torch/csrc/` becomes
one shared library with a plain C interface, compiled for Hopper
(``sm_90a``) into ``build/torch_port/`` at the repo root on first use, and
rebuilt when the hash of its source, the shared headers and the compiler
flags differs from the one stamped beside the library (``lib<name>.so.sha256``)
or the stamp is missing. `build` starts one nvcc process per source, all at
once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_port")

# kernel name -> its source file; every source includes the shared headers
KERNEL_SOURCES = {
    "hstu_mha_fwd": "hstu_mha_fwd.cu",
    "delta_hstu_mha_fwd": "delta_hstu_mha_fwd.cu",
    "hstu_mha_bwd_fused": "hstu_mha_bwd_fused.cu",
    "hstu_mha_bwd_dq": "hstu_mha_bwd_dq.cu",
    "hstu_mha_bwd_dkv": "hstu_mha_bwd_dkv.cu",
    "hstu_mha_relbias_fwd": "hstu_mha_relbias_fwd.cu",
    "hstu_mha_relbias_bwd": "hstu_mha_relbias_bwd.cu",
}
_HEADERS = (
    "bf16_mma.cuh", "hstu_attention.cuh", "hstu_attention_bwd_dkv.cuh", "hstu_attention_bwd_dkv_bf16.cuh",
    "hstu_attention_bwd_dq.cuh", "hstu_attention_bwd_dq_bf16.cuh", "hstu_attention_fwd.cuh",
    "hstu_attention_fwd_bf16.cuh", "hstu_attention_relbias_bwd_bf16.cuh", "hstu_attention_wide.cuh", "tf32_mma.cuh",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
# The relative-bias backward's library holds 31 kernel instances and sets the
# build's time: nvcc optimizes its device code on every core
# (`--split-compile`), which took its build from 66 to 39 s on an 8-core host
# beside an H100; ptxas reports the same registers and spills for every
# instance either way. The forward's libraries, with the wide forward's
# cluster instances, split too: K1's took 66 s on one thread, 38 s split
# (the narrow K1 the same time). The others keep one thread: two of K2's
# instances come out with other register counts when split.
_SPLIT_COMPILE = ("hstu_mha_relbias_bwd", "hstu_mha_fwd", "hstu_mha_relbias_fwd")


def nvcc_flags(name: str) -> tuple:
    """The nvcc flags of kernel ``name``'s library."""
    return NVCC_FLAGS + (("--split-compile=0",) if name in _SPLIT_COMPILE else ())


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}  # the last build of each kernel: seconds until its nvcc ended


class LaunchCounter:
    """Counts a kernel's launches, and apart the launches of each route its
    plan took (``narrow``, ``read`` or ``wide``, `hstu_attention._ROUTES`).
    Thread-safe: the serving harness may run predictions on several producer
    threads."""

    def __init__(self) -> None:
        self._n = 0
        self._routes: Dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, route: str = "") -> None:
        with self._lock:
            self._n += 1
            if route:
                self._routes[route] = self._routes.get(route, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0
            self._routes = {}

    @property
    def count(self) -> int:
        return self._n

    @property
    def routes(self) -> Dict[str, int]:
        """The launches by route since the last `reset`."""
        with self._lock:
            return dict(self._routes)


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def source_hash(name: str) -> str:
    """sha256 of the kernel's source, every shared header and the nvcc
    flags: the library's cache key."""
    h = hashlib.sha256(" ".join(nvcc_flags(name)).encode())
    for s in (KERNEL_SOURCES[name],) + _HEADERS:
        h.update(s.encode())
        with open(os.path.join(CSRC_DIR, s), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _stamp_path(name: str) -> str:
    return library_path(name) + ".sha256"


def _stale(name: str) -> bool:
    if not (os.path.exists(library_path(name)) and os.path.exists(_stamp_path(name))):
        return True
    with open(_stamp_path(name)) as f:
        return f.read().strip() != source_hash(name)


def build(names: Optional[Iterable[str]] = None, force: bool = False) -> Dict[str, str]:
    """Compiles the named kernels (all by default) that are missing or stale,
    one nvcc process per source started together. Returns each compiled
    kernel's compiler output (ptxas register and spill counts), and records
    each one's seconds from the start in `build_seconds`; raises with nvcc's
    output if any build fails."""
    names = list(KERNEL_SOURCES if names is None else names)
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    hashes = {n: source_hash(n) for n in todo}  # of what this build compiles
    for n in todo:
        tmp = library_path(n) + f".{os.getpid()}.tmp"
        cmd = [nvcc, *nvcc_flags(n), "-o", tmp, os.path.join(CSRC_DIR, KERNEL_SOURCES[n])]
        procs[n] = (
            tmp,
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        )
    t0 = time.perf_counter()

    def wait(n: str) -> None:  # each nvcc's output and its own wall time
        logs[n] = procs[n][1].communicate()[0]
        build_seconds[n] = time.perf_counter() - t0

    logs: Dict[str, str] = {}
    waiters = [threading.Thread(target=wait, args=(n,)) for n in procs]
    for t in waiters:
        t.start()
    for t in waiters:
        t.join()
    failed = []
    for n, (tmp, proc) in procs.items():
        if proc.returncode != 0:
            failed.append(n)
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            os.replace(tmp, library_path(n))
            with open(_stamp_path(n), "w") as f:
                f.write(hashes[n] + "\n")
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
        return lib
