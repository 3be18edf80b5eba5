"""Action and content encoders (port of
`generative_recommenders_tpu/modules/action_encoder.py`).

`ActionEncoder` decodes per-event action bitmasks into concatenated
per-action-type embeddings, with optional watch-time thresholds that each
add a synthetic action type (set where the event's watch time reaches the
threshold); candidate positions get a learned target-action embedding,
also exposed alone for the M-FALCON delta path. `ContentEncoder`
concatenates side features onto the item embeddings.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from generative_recommenders_tpu_torch.modules.mlp import new_param, normal
from generative_recommenders_tpu_torch.ops.padded import valid_mask


class ActionEncoder(nn.Module):
    """``watchtime_to_action_thresholds_and_weights``: (threshold, weight)
    pairs; each ORs ``weight`` into an event's bitmask where the payload
    ``watchtime_feature_name`` is at least ``threshold``, and adds one action
    type (a row of the [A + T, d] table) for that bit."""

    def __init__(
        self,
        action_embedding_dim: int,
        action_feature_name: str,
        action_weights: Tuple[int, ...],
        watchtime_feature_name: str = "",
        watchtime_to_action_thresholds_and_weights: Tuple[Tuple[int, int], ...] = (),
        gen: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.action_feature_name = action_feature_name
        self.watchtime_feature_name = watchtime_feature_name
        self.watchtime_to_action_thresholds_and_weights = tuple(watchtime_to_action_thresholds_and_weights)
        weights = tuple(action_weights) + tuple(w for _, w in self.watchtime_to_action_thresholds_and_weights)
        self.register_buffer("_weights", torch.tensor(weights, dtype=torch.int32), persistent=False)
        A, d = len(weights), action_embedding_dim
        self.action_embedding_table = new_param((A, d), normal(0.1), gen)
        self.target_action_embedding_table = new_param((1, A * d), normal(0.1), gen)

    @property
    def output_embedding_dim(self) -> int:
        return self.target_action_embedding_table.shape[1]

    def target_embedding(self) -> torch.Tensor:
        """[1, A*d]: the learned candidate-position action embedding."""
        return self.target_action_embedding_table

    def encode_actions(self, actions: torch.Tensor, watchtimes: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Bitmask [...] -> [..., A*d] embeddings (uih positions); with
        thresholds, ``watchtimes`` [...] sets their bits first."""
        actions = actions.to(torch.int32)
        for threshold, weight in self.watchtime_to_action_thresholds_and_weights:
            actions = actions | (watchtimes >= threshold).to(torch.int32) * weight
        exploded = (actions[..., None] & self._weights) > 0  # [..., A]
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
        watchtimes = (
            seq_payloads.get(self.watchtime_feature_name)
            if self.watchtime_to_action_thresholds_and_weights else None
        )
        is_uih = valid_mask(uih_lengths, actions.shape[1])[:, :, None]
        return torch.where(
            is_uih, self.encode_actions(actions, watchtimes),
            self.target_action_embedding_table.reshape(1, 1, -1),
        )


class ContentEncoder(nn.Module):
    """Item embeddings [B, N, D] with the ``additional_content_features``
    (payloads [B, N, d_f]) concatenated, then the ``target_enrich_features``,
    which exist only for candidates: uih positions get a learned dummy
    ``target_enrich_dummy_<name>`` [1, d_f] instead."""

    def __init__(
        self,
        input_embedding_dim: int,
        additional_content_features: Tuple[Tuple[str, int], ...] = (),
        target_enrich_features: Tuple[Tuple[str, int], ...] = (),
        gen: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.input_embedding_dim = input_embedding_dim
        self.additional_content_features = additional_content_features
        self.target_enrich_features = target_enrich_features
        for name, dim in target_enrich_features:
            self.register_parameter(f"target_enrich_dummy_{name}", new_param((1, dim), normal(0.1), gen))

    @property
    def output_embedding_dim(self) -> int:
        return (
            self.input_embedding_dim
            + sum(d for _, d in self.additional_content_features)
            + sum(d for _, d in self.target_enrich_features)
        )

    def forward(
        self,
        seq_embeddings: torch.Tensor,  # [B, N, D]
        uih_lengths: torch.Tensor,  # int[B]
        seq_payloads: Dict[str, torch.Tensor],  # merged [B, N, d_f] features
    ) -> torch.Tensor:
        parts = [seq_embeddings]
        for name, _ in self.additional_content_features:
            parts.append(seq_payloads[name].to(seq_embeddings.dtype))
        is_uih = valid_mask(uih_lengths, seq_embeddings.shape[1])[:, :, None]
        for name, dim in self.target_enrich_features:
            dummy = getattr(self, f"target_enrich_dummy_{name}").reshape(1, 1, dim)
            parts.append(torch.where(is_uih, dummy.to(seq_embeddings.dtype),
                                     seq_payloads[name].to(seq_embeddings.dtype)))
        return seq_embeddings if len(parts) == 1 else torch.cat(parts, dim=-1)
