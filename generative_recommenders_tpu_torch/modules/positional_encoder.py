"""HSTU positional encoder (port of
`generative_recommenders_tpu/modules/positional_encoder.py`): learned
count-down position buckets plus sqrt-bucketed time-delta embeddings, added
to the input scaled by sqrt(D)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from generative_recommenders_tpu_torch.modules.mlp import new_param, uniform
from generative_recommenders_tpu_torch.ops.position import (
    _timestamp_buckets,
    add_timestamp_positional_embeddings,
)


class HSTUPositionalEncoder(nn.Module):
    def __init__(
        self,
        num_position_buckets: int,
        num_time_buckets: int,
        embedding_dim: int,
        contextual_seq_len: int = 0,
        gen: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.embedding_dim = embedding_dim
        self.contextual_seq_len = contextual_seq_len
        self.position_embeddings_weight = new_param(
            (num_position_buckets, embedding_dim),
            uniform(math.sqrt(1.0 / num_position_buckets)), gen,
        )
        self.timestamp_embeddings_weight = new_param(
            (num_time_buckets + 1, embedding_dim),
            uniform(math.sqrt(1.0 / num_time_buckets)), gen,
        )

    def forward(
        self,
        seq_embeddings: torch.Tensor,  # [B, N, D]
        seq_lengths: torch.Tensor,  # int[B]
        seq_timestamps: torch.Tensor,  # [B, N]
        num_targets: Optional[torch.Tensor] = None,
        query_time: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        return add_timestamp_positional_embeddings(
            seq_embeddings, seq_lengths, seq_timestamps,
            self.position_embeddings_weight, self.timestamp_embeddings_weight,
            alpha=self.embedding_dim**0.5, num_targets=num_targets,
            max_contextual_seq_len=self.contextual_seq_len,
            query_time=query_time,
        )

    def delta(
        self,
        cand_embeddings: torch.Tensor,  # [B, m, D]
        cand_timestamps: torch.Tensor,  # [B, m]
        query_time: torch.Tensor,  # [B]
    ) -> torch.Tensor:
        """M-FALCON twin of `forward` for candidate tokens: the position is
        the constant target index (the contextual offset), the time bucket is
        measured against the query time."""
        B, m, _ = cand_embeddings.shape
        pos = self.position_embeddings_weight[self.contextual_seq_len]
        ts_w = self.timestamp_embeddings_weight
        ts_idx = _timestamp_buckets(
            cand_timestamps,
            torch.full((B,), m, dtype=torch.int32, device=cand_timestamps.device),
            ts_w.shape[0] - 1, query_time=query_time,
        )
        add = pos[None, None, :] + ts_w[ts_idx.long()]
        return cand_embeddings * (self.embedding_dim**0.5) + add.to(cand_embeddings.dtype)
