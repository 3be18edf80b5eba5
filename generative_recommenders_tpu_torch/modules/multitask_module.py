"""Multitask prediction head (port of
`generative_recommenders_tpu/modules/multitask_module.py`): T tasks, binary
classification from an action bitmask or regression on watch time,
predicted from user_emb * item_emb through an MLP, and the per-task losses
(BCE with logits, MSE) scaled by ``causal_multitask_weights``."""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from generative_recommenders_tpu_torch.modules.mlp import Dense, SwishLayerNorm


class MultitaskTaskType(enum.IntEnum):
    BINARY_CLASSIFICATION = 0
    REGRESSION = 1


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    task_name: str
    task_weight: int
    task_type: MultitaskTaskType


def get_supervision_labels_and_weights(
    supervision_bitmasks: torch.Tensor,  # int[B, M] candidate action bitmasks
    watchtime_sequence: torch.Tensor,  # [B, M]
    task_configs: Tuple[TaskConfig, ...],
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Per-task float labels (and no per-task weights)."""
    labels: Dict[str, torch.Tensor] = {}
    for task in task_configs:
        if task.task_type == MultitaskTaskType.REGRESSION:
            labels[task.task_name] = watchtime_sequence.to(torch.float32)
        elif task.task_type == MultitaskTaskType.BINARY_CLASSIFICATION:
            labels[task.task_name] = (
                (supervision_bitmasks.to(torch.int32) & task.task_weight) > 0
            ).to(torch.float32)
        else:
            raise ValueError(f"Unsupported task type {task.task_type}")
    return labels, {}


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable binary cross entropy with logits (own copy of
    `generative_recommenders_tpu/models/losses.py:_bce_with_logits`)."""
    return logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


class DefaultMultitaskModule(nn.Module):
    """Predictions and losses over [B, M, D] candidate embeddings with a
    [B, M] validity mask."""

    def __init__(
        self,
        task_configs: Tuple[TaskConfig, ...],
        embedding_dim: int,
        causal_multitask_weights: float,
        prediction_hidden_dim: int = 512,
        gen: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if not task_configs:
            raise ValueError("at least one task is required")
        if list(task_configs) != sorted(task_configs, key=lambda t: t.task_type):
            raise ValueError("task_configs must be sorted by task_type")
        self.task_configs = task_configs
        self.causal_multitask_weights = causal_multitask_weights
        self.num_classification = sum(
            t.task_type == MultitaskTaskType.BINARY_CLASSIFICATION for t in task_configs
        )
        self.pred_fc1 = Dense(embedding_dim, prediction_hidden_dim, gen)
        self.pred_sln = SwishLayerNorm(prediction_hidden_dim)
        self.pred_fc2 = Dense(prediction_hidden_dim, len(task_configs), gen)

    def forward(
        self,
        encoded_user_embeddings: torch.Tensor,  # [B, M, D]
        item_embeddings: torch.Tensor,  # [B, M, D]
        supervision_labels: Dict[str, torch.Tensor],  # each [B, M]
        supervision_weights: Dict[str, torch.Tensor],
        candidate_valid_mask: torch.Tensor,  # bool[B, M]
        compute_losses: bool = True,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
        """Returns (preds [T, B, M], labels [T, B, M], weights [T, B, M],
        losses [T]); preds are sigmoids for classification tasks and raw
        values for regression tasks. Without ``compute_losses`` the last
        three are None."""
        logits = self.pred_fc2(
            self.pred_sln(self.pred_fc1(encoded_user_embeddings * item_embeddings))
        )
        logits = logits.movedim(-1, 0).to(torch.float32)  # [T, B, M]
        n = self.num_classification
        preds = torch.cat([torch.sigmoid(logits[:n]), logits[n:]], dim=0)
        if not compute_losses:
            return preds, None, None, None

        labels = torch.stack([supervision_labels[t.task_name] for t in self.task_configs])
        valid = candidate_valid_mask.to(torch.float32)
        # invalid candidates never contribute
        weights = torch.stack(
            [supervision_weights.get(t.task_name, valid) for t in self.task_configs]
        ) * valid[None]
        per_elem = torch.cat(
            [_bce_with_logits(logits[:n], labels[:n]), (logits[n:] - labels[n:]).square()]
        ) * weights
        T = len(self.task_configs)
        per_task = per_elem.reshape(T, -1).sum(-1) / weights.reshape(T, -1).sum(-1).clamp_min(1.0)
        return preds, labels, weights, per_task * self.causal_multitask_weights
