"""Autoregressive losses of the research stack, dense-masked form (port of
`generative_recommenders_tpu/models/losses.py`): the loss stays dense [B, N]
with a weight mask that is zero exactly where a jagged form drops positions.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from generative_recommenders_tpu_torch.modules.multitask_module import _bce_with_logits


def sampled_softmax_loss_from_logits(
    pos_logits: torch.Tensor,  # [B, N]: raw similarity of the positives
    neg_logits: torch.Tensor,  # [B, N, R]: raw similarity of the sampled negatives
    supervision_ids: torch.Tensor,  # int[B, N]
    supervision_weights: torch.Tensor,  # float[B, N]
    sampled_ids: torch.Tensor,  # int[B, N, R]
    softmax_temperature: float,
) -> torch.Tensor:
    """Sampled softmax; a negative that collides with its positive's id is
    masked to -5e4."""
    pos_logits = pos_logits.float() / softmax_temperature
    neg_logits = torch.where(
        supervision_ids[..., None] == sampled_ids,
        -5e4,
        neg_logits.float() / softmax_temperature,
    )
    logits = torch.cat([pos_logits[..., None], neg_logits], dim=-1)
    per_pos = -torch.log_softmax(logits, dim=-1)[..., 0]  # [B, N]
    w = supervision_weights.to(per_pos.dtype)
    return (per_pos * w).sum() / w.sum().clamp_min(1e-6)


def sampled_softmax_loss(
    output_embeddings: torch.Tensor,  # [B, N, D]: encoder outputs (postprocessed)
    supervision_embeddings: torch.Tensor,  # [B, N, D]: positives (normalised)
    supervision_ids: torch.Tensor,  # int[B, N]
    supervision_weights: torch.Tensor,  # float[B, N]
    sampled_ids: torch.Tensor,  # int[B, N, R]
    sampled_negative_embeddings: torch.Tensor,  # [B, N, R, D] (normalised)
    softmax_temperature: float,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Dot-product sampled softmax."""
    pos_logits = (output_embeddings * supervision_embeddings).sum(-1)
    neg_logits = torch.einsum("bnd,bnrd->bnr", output_embeddings, sampled_negative_embeddings)
    loss = sampled_softmax_loss_from_logits(
        pos_logits, neg_logits, supervision_ids, supervision_weights,
        sampled_ids, softmax_temperature,
    )
    return loss, {}


def bce_loss(
    output_embeddings: torch.Tensor,  # [B, N, D]
    supervision_embeddings: torch.Tensor,  # [B, N, D]
    supervision_ids: torch.Tensor,  # int[B, N]
    supervision_weights: torch.Tensor,  # float[B, N]
    sampled_ids: torch.Tensor,  # int[B, N, 1]
    sampled_negative_embeddings: torch.Tensor,  # [B, N, 1, D]
    temperature: float = 1.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """BCE with one sampled negative."""
    pos_logits = (output_embeddings * supervision_embeddings).sum(-1) / temperature
    neg_logits = (output_embeddings * sampled_negative_embeddings[:, :, 0, :]).sum(-1) / temperature
    valid_neg = (supervision_ids != sampled_ids[..., 0]).float()
    weights = supervision_weights.float() * valid_neg
    losses = (
        _bce_with_logits(pos_logits, torch.ones_like(pos_logits))
        + _bce_with_logits(neg_logits, torch.zeros_like(neg_logits))
    ) * weights * 0.5
    return losses.sum() / weights.sum().clamp_min(1e-6), {}


def bce_loss_with_ratings(
    output_embeddings: torch.Tensor,
    supervision_embeddings: torch.Tensor,
    supervision_ratings: torch.Tensor,  # [B, N]
    supervision_weights: torch.Tensor,
    temperature: float = 1.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Rating-supervised BCE."""
    logits = (output_embeddings * supervision_embeddings).sum(-1) / temperature
    w = supervision_weights.float()
    losses = _bce_with_logits(logits, supervision_ratings.float()) * w
    return losses.sum() / w.sum().clamp_min(1e-6), {}
