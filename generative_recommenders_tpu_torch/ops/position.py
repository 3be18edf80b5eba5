"""Timestamp + position embedding addition (port of
`generative_recommenders_tpu/ops/position.py`), padded-dense.

Position indices count down from the last non-target position, targets share
the terminal index, and contextual rows get the fixed indices [0, C).
Timestamps are bucketed in float32 as in the JAX package: sqrt of the time
before the query, in minutes, truncated to int32.
"""

from __future__ import annotations

from typing import Optional

import torch


def _position_indices(
    N: int,
    seq_lengths: torch.Tensor,  # int[B]
    num_targets: Optional[torch.Tensor],
    max_contextual_seq_len: int,
    max_pos_ind: int,
) -> torch.Tensor:
    B = seq_lengths.shape[0]
    col = torch.arange(N, device=seq_lengths.device, dtype=torch.int32)[None, :].expand(B, N)
    if num_targets is not None:
        high = (seq_lengths - num_targets).to(torch.int32)[:, None]
        col = high - torch.minimum(col, high)
    else:
        col = seq_lengths.to(torch.int32)[:, None] - col
    col = (col + max_contextual_seq_len).clamp(max=max_pos_ind - 1)
    if max_contextual_seq_len > 0:
        col = col.clone()
        col[:, :max_contextual_seq_len] = torch.arange(
            max_contextual_seq_len, device=col.device, dtype=torch.int32
        )[None, :]
    return col.clamp(0, max_pos_ind - 1)


def _timestamp_buckets(
    timestamps: torch.Tensor,  # int/float[B, N]
    seq_lengths: torch.Tensor,  # int[B]
    num_buckets: int,
    time_bucket_increments: float = 60.0,
    query_time: Optional[torch.Tensor] = None,  # [B]: overrides ts[len - 1]
) -> torch.Tensor:
    B, N = timestamps.shape
    ts = timestamps.to(torch.float32)
    if query_time is not None:
        query_time = query_time.to(torch.float32).reshape(B, 1)
    else:
        q_idx = (seq_lengths.long() - 1).clamp(0, N - 1)
        query_time = torch.gather(ts, 1, q_idx[:, None])  # [B, 1]
    dt = (query_time - ts).clamp_min(1e-6) / time_bucket_increments
    return torch.sqrt(dt).to(torch.int32).clamp(0, num_buckets)


def add_timestamp_positional_embeddings(
    seq_embeddings: torch.Tensor,  # [B, N, D]
    seq_lengths: torch.Tensor,  # int[B]
    timestamps: torch.Tensor,  # [B, N]
    position_embeddings: torch.Tensor,  # [num_position_buckets, D]
    timestamp_embeddings: torch.Tensor,  # [num_time_buckets + 1, D]
    *,
    alpha: float,
    num_targets: Optional[torch.Tensor] = None,
    max_contextual_seq_len: int = 0,
    query_time: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """seq_embeddings * alpha + pos_emb[pos_idx] + ts_emb[ts_bucket]."""
    N = seq_embeddings.shape[1]
    pos_idx = _position_indices(
        N, seq_lengths, num_targets, max_contextual_seq_len,
        position_embeddings.shape[0],
    )
    ts_idx = _timestamp_buckets(
        timestamps, seq_lengths, timestamp_embeddings.shape[0] - 1,
        query_time=query_time,
    )
    add = position_embeddings[pos_idx.long()] + timestamp_embeddings[ts_idx.long()]
    return seq_embeddings * alpha + add.to(seq_embeddings.dtype)
