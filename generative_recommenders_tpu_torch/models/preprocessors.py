"""Input-features preprocessor of the research stack (port of
`generative_recommenders_tpu/models/preprocessors.py`). The KV-cached
``delta_positions`` path and the two rated preprocessors are not ported yet.
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
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        N = past_ids.shape[1]
        user_embeddings = past_embeddings * self.embedding_dim**0.5 + self.pos_emb[None, :N, :]
        if not deterministic:
            user_embeddings = dropout(user_embeddings, self.dropout_rate, gen)
        valid_mask = (past_ids != 0)[..., None].to(user_embeddings.dtype)
        return past_lengths, user_embeddings * valid_mask, valid_mask
