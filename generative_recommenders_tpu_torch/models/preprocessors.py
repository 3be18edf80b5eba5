"""Input-features preprocessors of the research stack (port of
`generative_recommenders_tpu/models/preprocessors.py`): the learnable
positional one, with the KV-cached encode's ``delta_positions``, and the two
rated ones, which add a rating embedding (concatenated, or interleaved as a
token of its own). As in the JAX package, no model wires the rated two.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from generative_recommenders_tpu_torch.modules.mlp import new_param, truncated_normal, xavier_normal
from generative_recommenders_tpu_torch.ops.hstu_compute import dropout


class LearnablePositionalEmbeddingInputFeaturesPreprocessor(nn.Module):
    """emb * sqrt(D) + learned position embedding, dropout, pads zeroed.
    ``pos_emb_init``: "xavier_normal" (the HSTU path) or "truncated_normal"
    (std sqrt(1 / D), SASRec's)."""

    def __init__(
        self,
        max_sequence_len: int,
        embedding_dim: int,
        dropout_rate: float,
        pos_emb_init: str = "xavier_normal",
        gen: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.embedding_dim = embedding_dim
        self.dropout_rate = dropout_rate
        init = (
            xavier_normal if pos_emb_init == "xavier_normal"
            else truncated_normal((1.0 / embedding_dim) ** 0.5)
        )
        self.pos_emb = new_param((max_sequence_len, embedding_dim), init, gen)

    def forward(
        self,
        past_lengths: torch.Tensor,  # int[B]
        past_ids: torch.Tensor,  # int[B, N]
        past_embeddings: torch.Tensor,  # [B, N, D]
        past_payloads: Dict[str, torch.Tensor],
        deterministic: bool = False,
        gen: Optional[torch.Generator] = None,  # the dropout masks' generator
        delta_positions: Optional[torch.Tensor] = None,  # int[B, M]: absolute positions
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(lengths, embeddings [B, N, D], valid mask [B, N, 1]). With
        ``delta_positions`` the N = M tokens are the KV-cached encode's
        appended ones, each at its row's own absolute position."""
        N = past_ids.shape[1]
        if delta_positions is not None:
            pos = self.pos_emb[delta_positions.clamp(0, self.pos_emb.shape[0] - 1)]
        else:
            pos = self.pos_emb[None, :N, :]
        user_embeddings = past_embeddings * self.embedding_dim**0.5 + pos
        if not deterministic:
            user_embeddings = dropout(user_embeddings, self.dropout_rate, gen)
        valid_mask = (past_ids != 0)[..., None].to(user_embeddings.dtype)
        return past_lengths, user_embeddings * valid_mask, valid_mask


class LearnablePositionalEmbeddingRatedInputFeaturesPreprocessor(nn.Module):
    """[item embedding, rating embedding] * sqrt(D) + learned position
    embedding, D = item + rating width; dropout, pads zeroed. Both tables
    truncated normal(sqrt(1 / D))."""

    def __init__(
        self,
        max_sequence_len: int,
        item_embedding_dim: int,
        rating_embedding_dim: int,
        num_ratings: int,
        dropout_rate: float,
        gen: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.dropout_rate = dropout_rate
        D = self.output_dim = item_embedding_dim + rating_embedding_dim
        init = truncated_normal((1.0 / D) ** 0.5)
        self.pos_emb = new_param((max_sequence_len, D), init, gen)
        self.rating_emb = new_param((num_ratings, rating_embedding_dim), init, gen)

    def forward(
        self,
        past_lengths: torch.Tensor,
        past_ids: torch.Tensor,
        past_embeddings: torch.Tensor,
        past_payloads: Dict[str, torch.Tensor],
        deterministic: bool = False,
        gen: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        N = past_ids.shape[1]
        ratings = past_payloads["ratings"].long().clamp(0, self.rating_emb.shape[0] - 1)
        user_embeddings = (
            torch.cat([past_embeddings, self.rating_emb[ratings]], dim=-1) * self.output_dim**0.5
            + self.pos_emb[None, :N, :]
        )
        if not deterministic:
            user_embeddings = dropout(user_embeddings, self.dropout_rate, gen)
        valid_mask = (past_ids != 0)[..., None].to(user_embeddings.dtype)
        return past_lengths, user_embeddings * valid_mask, valid_mask


class CombinedItemAndRatingInputFeaturesPreprocessor(nn.Module):
    """Item and rating embeddings interleaved, [i0, r0, i1, r1, ...]: the
    sequence and the lengths double, the valid mask repeats per pair. Both
    tables truncated normal(sqrt(1 / D)); positions over 2 N."""

    def __init__(
        self,
        max_sequence_len: int,  # N, before the interleave
        embedding_dim: int,
        dropout_rate: float,
        num_ratings: int,
        gen: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.embedding_dim = embedding_dim
        self.dropout_rate = dropout_rate
        init = truncated_normal((1.0 / embedding_dim) ** 0.5)
        self.pos_emb = new_param((max_sequence_len * 2, embedding_dim), init, gen)
        self.rating_emb = new_param((num_ratings, embedding_dim), init, gen)

    def forward(
        self,
        past_lengths: torch.Tensor,  # int[B]
        past_ids: torch.Tensor,  # int[B, N]
        past_embeddings: torch.Tensor,  # [B, N, D]
        past_payloads: Dict[str, torch.Tensor],
        deterministic: bool = False,
        gen: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        B, N = past_ids.shape
        D = self.embedding_dim
        ratings = past_payloads["ratings"].long().clamp(0, self.rating_emb.shape[0] - 1)
        user_embeddings = torch.stack([past_embeddings, self.rating_emb[ratings]], dim=2).reshape(B, 2 * N, D)
        user_embeddings = user_embeddings * D**0.5 + self.pos_emb[None, : 2 * N, :]
        if not deterministic:
            user_embeddings = dropout(user_embeddings, self.dropout_rate, gen)
        valid_mask = (past_ids != 0)[:, :, None].repeat_interleave(2, dim=1).to(user_embeddings.dtype)
        return past_lengths * 2, user_embeddings * valid_mask, valid_mask
