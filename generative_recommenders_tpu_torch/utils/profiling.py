"""Profiling (port of `generative_recommenders_tpu/utils/profiling.py`) on
`torch.profiler`.

`Profiler` follows the training loop's steps with the reference's schedule:
it skips ``wait`` steps, warms up for ``warmup`` and records ``active``
steps of host and device activity, then writes them as one Chrome trace
(``trace_<n>.json``) under ``log_dir``.

`span` names a layer of the program in whatever profile is recording on the
calling thread (`Profiler`'s, or any ``torch.profiler.profile``): a
``record_function`` range on the profiler's own clock, beside the kernels it
launched. With no profile recording it is one shared no-op. The program opens
six, on the thread that calls the model:

  train.backward      `DlrmTrainer.train_step`, `ResearchTrainer.train_step`:
                      ``loss.backward()`` (the autograd thread launches its
                      kernels while the caller waits inside)
  dlrm.lookup         `modules/dlrm_hstu.py:lookup_and_merge_features`
  dlrm.stu            `HSTUTransducer.forward`: the STU stack
  research.negatives  `ResearchTrainer.loss`: the sampler's draw and gather
  research.loss       `ResearchTrainer.loss`: the loss's forward
  serve.predict       `HSTUModelFamily.predict`
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import ContextManager, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function, schedule

logger = logging.getLogger(__name__)

DEFAULT_LOG_DIR = os.path.join("tmp", "trace")

_profiler_enabled = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()


def span(name: str) -> ContextManager:
    """A range ``name`` in the profile recording on this thread; the shared
    no-op when none is."""
    return record_function(name) if _profiler_enabled() else _NO_SPAN


def _activities() -> List[ProfilerActivity]:
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


class Profiler:
    """Step-schedule profiler: call `step` after every training step and
    `close` at the end. ``paths`` lists the traces written so far; each holds
    the program's spans (`span`) of the steps it recorded."""

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
