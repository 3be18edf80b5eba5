"""Multitask ranking metrics: NE / AUC / MSE / MAE + logger (own copy of
`generative_recommenders_tpu/train/dlrm_metrics.py`; `MetricsLogger.update`
also takes torch tensors). Metrics accumulate on the host over
(preds, labels, weights) batches per task:

  * NE  — normalized entropy: weighted BCE / entropy of the base CTR
  * AUC — exact rank-based AUC over the accumulated window
  * MSE / MAE — weighted regression errors
"""

from __future__ import annotations

import logging
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from generative_recommenders_tpu_torch.modules.multitask_module import (
    MultitaskTaskType,
    TaskConfig,
)

logger = logging.getLogger(__name__)
_EPS = 1e-12


def normalized_entropy(
    preds: np.ndarray, labels: np.ndarray, weights: np.ndarray
) -> float:
    """sum(w * bce) / sum(w * bce(base_rate)) — torchrec NE definition."""
    p = np.clip(preds.astype(np.float64), _EPS, 1 - _EPS)
    y = labels.astype(np.float64)
    w = weights.astype(np.float64)
    wsum = w.sum()
    if wsum <= 0:
        return float("nan")
    bce = -(y * np.log(p) + (1 - y) * np.log(1 - p))
    ctr = (w * y).sum() / wsum
    ctr = min(max(ctr, _EPS), 1 - _EPS)
    base = -(ctr * np.log(ctr) + (1 - ctr) * np.log(1 - ctr))
    return float((w * bce).sum() / (wsum * base + _EPS))


def auc(preds: np.ndarray, labels: np.ndarray, weights: np.ndarray) -> float:
    """Weighted rank AUC (ties get midrank)."""
    mask = weights > 0
    p, y, w = preds[mask], labels[mask], weights[mask]
    if p.size == 0 or y.min() == y.max():
        return float("nan")
    order = np.argsort(p, kind="mergesort")
    p, y, w = p[order], y[order], w[order]
    # midranks of weighted positions
    cw = np.cumsum(w)
    rank = cw - w / 2.0
    # average ranks over score ties
    _, inv, counts = np.unique(p, return_inverse=True, return_counts=True)
    rank_sum = np.zeros(counts.shape[0])
    w_sum = np.zeros(counts.shape[0])
    np.add.at(rank_sum, inv, rank * w)
    np.add.at(w_sum, inv, w)
    rank = (rank_sum / np.maximum(w_sum, _EPS))[inv]
    wpos = (w * y).sum()
    wneg = (w * (1 - y)).sum()
    if wpos <= 0 or wneg <= 0:
        return float("nan")
    pos_rank = (w * y * rank).sum()
    return float((pos_rank - wpos * (wpos / 2.0)) / (wpos * wneg))


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class MetricsLogger:
    """Per-task accumulation + compute.

    update() takes the DlrmHSTU multitask outputs: preds [T, B, M],
    labels [T, B, M], weights [T, B, M] (invalid candidates carry weight 0).
    """

    def __init__(
        self, task_configs: Sequence[TaskConfig], window: int = 0
    ) -> None:
        self._tasks = list(task_configs)
        self._window = window  # 0 = unbounded
        self._buf: List[List[Tuple[np.ndarray, np.ndarray, np.ndarray]]] = [
            [] for _ in self._tasks
        ]

    def update(self, preds, labels, weights) -> None:
        preds, labels, weights = (_numpy(x) for x in (preds, labels, weights))
        for t in range(len(self._tasks)):
            self._buf[t].append(
                (preds[t].ravel(), labels[t].ravel(), weights[t].ravel())
            )
            if self._window and len(self._buf[t]) > self._window:
                self._buf[t].pop(0)

    def compute(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for t, task in enumerate(self._tasks):
            if not self._buf[t]:
                continue
            p = np.concatenate([b[0] for b in self._buf[t]])
            y = np.concatenate([b[1] for b in self._buf[t]])
            w = np.concatenate([b[2] for b in self._buf[t]])
            name = task.task_name
            if task.task_type == MultitaskTaskType.BINARY_CLASSIFICATION:
                out[f"{name}/ne"] = normalized_entropy(p, y, w)
                out[f"{name}/auc"] = auc(p, y, w)
            else:
                wsum = max(w.sum(), _EPS)
                out[f"{name}/mse"] = float((w * (p - y) ** 2).sum() / wsum)
                out[f"{name}/mae"] = float((w * np.abs(p - y)).sum() / wsum)
        return out

    def compute_and_log(self, step: int) -> Dict[str, float]:
        m = self.compute()
        logger.info(
            "step %d metrics: %s",
            step, {k: round(v, 5) for k, v in m.items()},
        )
        return m

    def reset(self) -> None:
        self._buf = [[] for _ in self._tasks]
