"""Item embedding modules of the research stack (port of
`generative_recommenders_tpu/models/embeddings.py`). Id 0 is padding: it
embeds to 0 and gets no gradient. ``lookup_fn(table, ids)``, when bound,
replaces the local gather for ids of rank 2 or more (sequences, sampled
negatives): `parallel/train.DistributedTrainer` binds the all-to-all exchange
(`parallel/embedding.py:sharded_lookup`) there when it row-shards the table.
Rank-1 corpus scans keep the local gather, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from generative_recommenders_tpu_torch.modules.mlp import new_param, truncated_normal

LookupFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def lookup_rows(table: torch.Tensor, ids: torch.Tensor, num_items: int, lookup_fn: Optional[LookupFn]):
    """The clipped ids' rows, through ``lookup_fn`` when bound and the ids
    have a batch dimension."""
    clipped = ids.clamp(0, num_items)
    if lookup_fn is not None and ids.dim() >= 2:
        return lookup_fn(table, clipped)
    return F.embedding(clipped, table)


class LocalEmbeddingModule(nn.Module):
    """One dense table [num_items + 1, D], truncated normal(0.02)."""

    def __init__(
        self, num_items: int, embedding_dim: int, gen: Optional[torch.Generator] = None,
        lookup_fn: Optional[LookupFn] = None,
    ) -> None:
        super().__init__()
        self.num_items = num_items
        self.lookup_fn = lookup_fn
        self.item_emb = new_param((num_items + 1, embedding_dim), truncated_normal(0.02), gen)

    def forward(self, item_ids: torch.Tensor) -> torch.Tensor:
        emb = lookup_rows(self.item_emb, item_ids, self.num_items, self.lookup_fn)
        return emb * (item_ids != 0)[..., None].to(emb.dtype)


class CategoricalEmbeddingModule(nn.Module):
    """Item id -> category id, then a lookup in a [num_items + 1, D] table
    of truncated normal(0.02); ``item_id_to_category_id[i - 1]`` is item i's
    0-based category. The map is a buffer that the state dict leaves out,
    as the JAX package keeps it out of the parameters."""

    def __init__(
        self,
        num_items: int,
        embedding_dim: int,
        item_id_to_category_id,  # int[num_raw_items]
        gen: Optional[torch.Generator] = None,
        lookup_fn: Optional[LookupFn] = None,
    ) -> None:
        super().__init__()
        self.num_items = num_items
        self.lookup_fn = lookup_fn
        self.register_buffer(
            "item_id_to_category_id", torch.as_tensor(item_id_to_category_id, dtype=torch.long),
            persistent=False,
        )
        self.item_emb = new_param((num_items + 1, embedding_dim), truncated_normal(0.02), gen)

    def forward(self, item_ids: torch.Tensor) -> torch.Tensor:
        remap = self.item_id_to_category_id
        cat = remap[(item_ids - 1).clamp(0, remap.shape[0] - 1)] + 1
        emb = lookup_rows(self.item_emb, cat, self.num_items, self.lookup_fn)
        return emb * (item_ids != 0)[..., None].to(emb.dtype)
