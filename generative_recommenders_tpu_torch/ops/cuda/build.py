"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each kernel source under `generative_recommenders_tpu_torch/csrc/` becomes
one shared library with a plain C interface, compiled for Hopper
(``sm_90a``) into ``build/torch_port/`` at the repo root on first use, and
rebuilt when a source is newer than its library. `build` starts one nvcc
process per source, all at once.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
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
_HEADERS = ("hstu_attention.cuh", "hstu_attention_bwd.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """Counts a kernel's launches. Thread-safe: the serving harness may run
    predictions on several producer threads."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def count(self) -> int:
        return self._n


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


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not os.path.exists(lib):
        return True
    sources = (KERNEL_SOURCES[name],) + _HEADERS
    newest = max(os.path.getmtime(os.path.join(CSRC_DIR, s)) for s in sources)
    return os.path.getmtime(lib) < newest


def build(names: Optional[Iterable[str]] = None, force: bool = False) -> Dict[str, str]:
    """Compiles the named kernels (all by default) that are missing or stale,
    one nvcc process per source started together. Returns each compiled
    kernel's compiler output (ptxas register and spill counts); raises with
    nvcc's output if any build fails."""
    names = list(KERNEL_SOURCES if names is None else names)
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = library_path(n) + f".{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, KERNEL_SOURCES[n])]
        procs[n] = (
            tmp,
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        )
    logs, failed = {}, []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[n] = out
        if proc.returncode != 0:
            failed.append(n)
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            os.replace(tmp, library_path(n))
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
