"""Sequence tensor utilities of the research stack (port of
`generative_recommenders_tpu/models/seq_utils.py:get_current_embeddings`)."""

from __future__ import annotations

import torch


def get_current_embeddings(
    lengths: torch.Tensor,  # int[B]
    encoded_embeddings: torch.Tensor,  # [B, N, D]
) -> torch.Tensor:
    """out[b] = encoded[b, lengths[b] - 1]."""
    B, N, D = encoded_embeddings.shape
    idx = (lengths.long() - 1).clamp(0, N - 1)
    return encoded_embeddings[torch.arange(B, device=idx.device), idx]
