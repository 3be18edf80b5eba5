"""Action encoder (port of `generative_recommenders_tpu/modules/action_encoder.py`).

Decodes per-event action bitmasks into concatenated per-action-type
embeddings; candidate positions get a learned target-action embedding, also
exposed alone for the M-FALCON delta path.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from generative_recommenders_tpu_torch.modules.mlp import new_param, normal
from generative_recommenders_tpu_torch.ops.padded import valid_mask


class ActionEncoder(nn.Module):
    def __init__(
        self,
        action_embedding_dim: int,
        action_feature_name: str,
        action_weights: Tuple[int, ...],
        gen: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.action_feature_name = action_feature_name
        self.register_buffer(
            "_weights", torch.tensor(action_weights, dtype=torch.int32), persistent=False
        )
        A, d = len(action_weights), action_embedding_dim
        self.action_embedding_table = new_param((A, d), normal(0.1), gen)
        self.target_action_embedding_table = new_param((1, A * d), normal(0.1), gen)

    @property
    def output_embedding_dim(self) -> int:
        return self.target_action_embedding_table.shape[1]

    def target_embedding(self) -> torch.Tensor:
        """[1, A*d]: the learned candidate-position action embedding."""
        return self.target_action_embedding_table

    def encode_actions(self, actions: torch.Tensor) -> torch.Tensor:
        """Bitmask [...] -> [..., A*d] embeddings (uih positions)."""
        exploded = (actions.to(torch.int32)[..., None] & self._weights) > 0  # [..., A]
        table = self.action_embedding_table
        return (exploded[..., None].to(table.dtype) * table).reshape(
            *actions.shape, self.output_embedding_dim
        )

    def forward(
        self,
        uih_lengths: torch.Tensor,  # int[B]
        seq_payloads: Dict[str, torch.Tensor],  # merged [B, N] features
    ) -> torch.Tensor:
        """[B, N, A*d]; candidate positions (>= uih length) get the target
        embedding."""
        actions = seq_payloads[self.action_feature_name]
        is_uih = valid_mask(uih_lengths, actions.shape[1])[:, :, None]
        return torch.where(
            is_uih, self.encode_actions(actions),
            self.target_action_embedding_table.reshape(1, 1, -1),
        )
