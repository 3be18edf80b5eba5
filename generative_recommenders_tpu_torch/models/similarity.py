"""Dot-product similarity of the research stack (port of
`generative_recommenders_tpu/models/similarity.py`). MoL is not ported yet."""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def dot_product_similarity(
    query_embeddings: torch.Tensor,  # [B, D] (or [B * r, D])
    item_embeddings: torch.Tensor,  # [1, X, D] or [B, X, D]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns ([B, X] logits, aux_losses)."""
    B_i, X, D = item_embeddings.shape
    if B_i == 1:
        logits = query_embeddings @ item_embeddings[0].T
    elif query_embeddings.shape[0] != B_i:
        r = query_embeddings.shape[0] // B_i
        logits = torch.einsum(
            "brd,bxd->brx", query_embeddings.reshape(B_i, r, D), item_embeddings
        ).reshape(-1, X)
    else:
        logits = torch.einsum("bxd,bd->bx", item_embeddings, query_embeddings)
    return logits, {}
