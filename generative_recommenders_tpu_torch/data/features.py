"""Batch -> `SequentialFeatures` (port of
`generative_recommenders_tpu/data/features.py`): reserves
``max_output_length`` tail slots and scatters the target's timestamp at
position ``lengths``, so that the relative-time bias of the last history row
sees the query time.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch


class SequentialFeatures(NamedTuple):
    past_lengths: torch.Tensor  # int[B]
    past_ids: torch.Tensor  # int[B, N]
    past_embeddings: Optional[torch.Tensor]  # [B, N, D] or None
    past_payloads: Dict[str, torch.Tensor]


def seq_features_from_row(
    row: Dict[str, torch.Tensor],
    max_output_length: int,
) -> Tuple[SequentialFeatures, torch.Tensor, torch.Tensor]:
    """Returns (features, target_ids [B, 1], target_ratings [B, 1]); integer
    tensors are int64 (what torch indexes with)."""
    lengths = row["history_lengths"].long()
    ids = row["historical_ids"].long()
    ratings = row["historical_ratings"].long()
    timestamps = row["historical_timestamps"].long()
    target_ids = row["target_ids"].long().reshape(-1, 1)
    target_ratings = row["target_ratings"].long().reshape(-1, 1)
    target_ts = row["target_timestamps"].long().reshape(-1, 1)
    B = ids.shape[0]
    if max_output_length > 0:
        pad = lambda x: torch.cat([x, x.new_zeros((B, max_output_length))], dim=1)  # noqa: E731
        ids, ratings, timestamps = pad(ids), pad(ratings), pad(timestamps)
        timestamps[torch.arange(B, device=ids.device), lengths] = target_ts[:, 0]
    features = SequentialFeatures(
        past_lengths=lengths,
        past_ids=ids,
        past_embeddings=None,
        past_payloads={"timestamps": timestamps, "ratings": ratings},
    )
    return features, target_ids, target_ratings


def scatter_target_into_ids(
    past_ids: torch.Tensor, lengths: torch.Tensor, target_ids: torch.Tensor
) -> torch.Tensor:
    """A copy of ``past_ids`` with past_ids[b, lengths[b]] = target_ids[b]."""
    out = past_ids.clone()
    out[torch.arange(past_ids.shape[0], device=past_ids.device), lengths] = target_ids.reshape(-1)
    return out
