"""Item embedding module of the research stack (port of
`generative_recommenders_tpu/models/embeddings.py`). Id 0 is padding: it
embeds to 0 and gets no gradient. The sharded-lookup hook (``lookup_fn``) and
`CategoricalEmbeddingModule` are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from generative_recommenders_tpu_torch.modules.mlp import new_param, truncated_normal


class LocalEmbeddingModule(nn.Module):
    """One dense table [num_items + 1, D], truncated normal(0.02)."""

    def __init__(
        self, num_items: int, embedding_dim: int, gen: Optional[torch.Generator] = None
    ) -> None:
        super().__init__()
        self.num_items = num_items
        self.item_emb = new_param((num_items + 1, embedding_dim), truncated_normal(0.02), gen)

    def forward(self, item_ids: torch.Tensor) -> torch.Tensor:
        emb = F.embedding(item_ids.clamp(0, self.num_items), self.item_emb)
        return emb * (item_ids != 0)[..., None].to(emb.dtype)
