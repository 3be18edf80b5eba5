"""Multitask prediction head (port of
`generative_recommenders_tpu/modules/multitask_module.py`): T tasks, binary
classification from an action bitmask or regression on watch time,
predicted from user_emb * item_emb through an MLP. Inference predictions
only; the losses come with the training port."""

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


class DefaultMultitaskModule(nn.Module):
    """Predictions over [B, M, D] candidate embeddings."""

    def __init__(
        self,
        task_configs: Tuple[TaskConfig, ...],
        embedding_dim: int,
        prediction_hidden_dim: int = 512,
        gen: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if not task_configs:
            raise ValueError("at least one task is required")
        if list(task_configs) != sorted(task_configs, key=lambda t: t.task_type):
            raise ValueError("task_configs must be sorted by task_type")
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
    ) -> torch.Tensor:
        """Predictions [T, B, M]: sigmoid for classification tasks, the raw
        value for regression tasks."""
        logits = self.pred_fc2(
            self.pred_sln(self.pred_fc1(encoded_user_embeddings * item_embeddings))
        )
        logits = logits.movedim(-1, 0).to(torch.float32)  # [T, B, M]
        n = self.num_classification
        return torch.cat([torch.sigmoid(logits[:n]), logits[n:]], dim=0)
