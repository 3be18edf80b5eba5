"""ctypes bindings to the native sharded-CSV corpus reader (port
`csrc/csv_reader.cpp`, a copy of the root one): mmap'd shards, a native line
index, rows parsed into int64 numpy buffers without the GIL. The port's own
copy of `generative_recommenders_tpu/data/native_reader.py`, with one
difference: a failed build or load raises, with the compiler's message,
instead of leaving the caller to fall back to Python.

The library is built with g++ on first use into `build/torch_port/`.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_PORT_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PORT_ROOT, "csrc", "csv_reader.cpp")
_LIB = os.path.join(os.path.dirname(_PORT_ROOT), "build", "torch_port", "libcsvreader.so")

_lib: Optional[ctypes.CDLL] = None
_I64P = ctypes.POINTER(ctypes.c_int64)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if not (os.path.exists(_LIB) and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)):
        os.makedirs(os.path.dirname(_LIB), exist_ok=True)
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", _LIB, _SRC]
        logger.info("building the csv reader: %s", " ".join(cmd))
        try:
            done = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:  # no compiler
            raise RuntimeError(f"cannot build the native csv reader: {e}") from e
        if done.returncode != 0:
            raise RuntimeError(f"building the native csv reader failed:\n{done.stderr}")
    lib = ctypes.CDLL(_LIB)
    lib.csv_open.argtypes = [ctypes.c_char_p, ctypes.c_int32, _I64P]
    lib.csv_open.restype = ctypes.c_int64
    lib.csv_num_rows.argtypes = [ctypes.c_int64]
    lib.csv_num_rows.restype = ctypes.c_int64
    lib.csv_user_id.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lib.csv_user_id.restype = ctypes.c_int64
    lib.csv_read_row.argtypes = [ctypes.c_int64, ctypes.c_int64, _I64P, _I64P, ctypes.c_int64]
    lib.csv_read_row.restype = ctypes.c_int64
    lib.csv_close.argtypes = [ctypes.c_int64]
    _lib = lib
    return lib


class NativeCorpus:
    """mmap'd sharded corpus; thread-safe reads without the GIL."""

    def __init__(self, prefix: str, row_counts, initial_cap: int = 4096) -> None:
        self._lib = _load()
        counts = np.asarray(row_counts, np.int64)
        self._h = self._lib.csv_open(prefix.encode(), len(counts), counts.ctypes.data_as(_I64P))
        if self._h < 0:
            raise RuntimeError(f"csv_open failed for {prefix}")
        self._cap = initial_cap

    def __len__(self) -> int:
        return int(self._lib.csv_num_rows(self._h))

    def read_row(self, idx: int) -> Tuple[int, np.ndarray, np.ndarray]:
        """(user id, item ids, ratings) of row ``idx``."""
        cap = self._cap
        while True:
            items = np.empty(cap, np.int64)
            ratings = np.empty(cap, np.int64)
            n = self._lib.csv_read_row(
                self._h, idx, items.ctypes.data_as(_I64P), ratings.ctypes.data_as(_I64P), cap
            )
            if n >= 0:
                return int(self._lib.csv_user_id(self._h, idx)), items[:n], ratings[:n]
            if n == -1:
                raise IndexError(f"row {idx} unreadable")
            cap = max(cap * 2, -int(n))
            self._cap = cap

    def close(self) -> None:
        if self._h >= 0:
            self._lib.csv_close(self._h)
            self._h = -1
