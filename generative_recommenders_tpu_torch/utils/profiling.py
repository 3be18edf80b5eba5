"""Profiling (port of `generative_recommenders_tpu/utils/profiling.py`) on
`torch.profiler`.

`Profiler` follows the training loop's steps with the reference's schedule:
it skips ``wait`` steps, warms up for ``warmup`` and records ``active``
steps of host and device activity, then writes them as one Chrome trace
(``trace_<n>.json``) under ``log_dir``. `trace` records a block of code the
same way.
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Iterator, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, schedule

logger = logging.getLogger(__name__)

DEFAULT_LOG_DIR = os.path.join("tmp", "trace")


def _activities() -> List[ProfilerActivity]:
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


class Profiler:
    """Step-schedule profiler: call `step` after every training step and
    `close` at the end. ``paths`` lists the traces written so far."""

    def __init__(
        self, log_dir: str = DEFAULT_LOG_DIR, wait: int = 10, warmup: int = 20, active: int = 5
    ) -> None:
        self.log_dir = log_dir
        self.paths: List[str] = []
        os.makedirs(log_dir, exist_ok=True)
        self._prof: Optional[profile] = profile(
            activities=_activities(),
            schedule=schedule(wait=wait, warmup=warmup, active=active, repeat=1),
            on_trace_ready=self._write,
        )
        self._prof.start()

    def _write(self, prof: profile) -> None:
        path = os.path.join(self.log_dir, f"trace_{len(self.paths)}.json")
        prof.export_chrome_trace(path)
        self.paths.append(path)
        logger.info("profiler: wrote trace to %s", path)

    def step(self) -> None:
        if self._prof is not None:
            self._prof.step()

    def close(self) -> None:
        if self._prof is not None:
            self._prof.stop()
            self._prof = None


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Records the block and writes ``log_dir/trace.json``."""
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
