"""Checkpoint save and restore (port of
`generative_recommenders_tpu/utils/checkpoint.py`, with `torch.save` /
`torch.load` where the JAX package uses Orbax). A checkpoint is one file,
``<path>/<step>.pt``, holding a nested dict of tensors (and plain Python
values): the research trainer saves ``{"params", "opt_state"}``, the ranker
its model's parameters, tables included. A checkpoint always holds whole
tables: a trainer on a mesh gathers its shards before rank 0 writes, and
takes its rows of the file on restore, so the JAX package's sparse/dense
split has no counterpart here.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Union

import torch


def save_checkpoint(path: str, state: Any, step: int) -> str:
    """Writes ``state`` to ``path/<step>.pt``; returns that file's path."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    ckpt_path = os.path.join(path, f"{step}.pt")
    tmp = ckpt_path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, ckpt_path)  # a reader never sees half a file
    return ckpt_path


def latest_step(path: str) -> Optional[int]:
    """The largest step saved under ``path``, or None."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        return None
    steps = [int(d[:-3]) for d in os.listdir(path) if d.endswith(".pt") and d[:-3].isdigit()]
    return max(steps) if steps else None


def restore_checkpoint(
    path: str, map_location: Union[str, torch.device], step: Optional[int] = None
) -> Any:
    """The state saved at ``step`` (default: the latest), its tensors on
    ``map_location``, the device of whatever it is loaded into."""
    path = os.path.abspath(path)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    return torch.load(os.path.join(path, f"{step}.pt"), map_location=map_location, weights_only=True)
