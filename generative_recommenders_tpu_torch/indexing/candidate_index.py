"""Candidate index and brute-force maximum-inner-product top-k (port of
`generative_recommenders_tpu/indexing/candidate_index.py`).

`CandidateIndex.get_top_k_outputs` over-fetches k + N0 candidates and drops
each row's invalid ids (its history), keeping the first k valid ones in
score order, with static shapes: no `nonzero`, no host sync. `torch.topk`
stands for ``lax.top_k``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch


def mips_brute_force_top_k(
    query_embeddings: torch.Tensor,  # [B, D]
    item_embeddings: torch.Tensor,  # [X, D]
    item_ids: torch.Tensor,  # int[X]
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exhaustive top-k by inner product: (scores [B, k], ids [B, k]), best
    first."""
    scores = query_embeddings @ item_embeddings.T
    top_scores, top_idx = torch.topk(scores, k, dim=1)
    return top_scores, item_ids[top_idx]


@dataclasses.dataclass
class CandidateIndex:
    """The candidate corpus: ids [X] (positive) and their embeddings [X, D],
    on the device the queries come from."""

    ids: torch.Tensor
    embeddings: torch.Tensor

    @property
    def num_objects(self) -> int:
        return int(self.ids.shape[0])

    def get_top_k_outputs(
        self,
        query_embeddings: torch.Tensor,  # [B, D]
        k: int,
        invalid_ids: Optional[torch.Tensor] = None,  # int[B, N0]: ids to drop per row
        top_k_module: Optional[Callable] = None,  # (queries, k) -> (scores, ids), best first
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k with row-wise filtering: (ids [B, k], scores [B, k]), by
        inner product or by ``top_k_module`` (e.g. `MoLBruteForceTopK`)."""
        max_num_invalid = 0 if invalid_ids is None else invalid_ids.shape[1]
        k_prime = min(k + max_num_invalid, self.num_objects)
        top_k_fn = top_k_module or (
            lambda q, kk: mips_brute_force_top_k(q, self.embeddings, self.ids, kk)
        )
        top_scores, top_ids = top_k_fn(query_embeddings, k_prime)
        if invalid_ids is None:
            return top_ids[:, :k], top_scores[:, :k]
        is_valid = ~(top_ids[:, :, None] == invalid_ids[:, None, :]).any(dim=2)  # [B, k']
        # the first k valid positions: a key that ranks every valid position
        # above every invalid one and, within each, the earlier first
        pos = torch.arange(k_prime, device=top_ids.device)[None, :]
        key = is_valid.long() * (2 * k_prime) - pos
        sel = torch.topk(key, k, dim=1).indices.sort(dim=1).values
        return torch.gather(top_ids, 1, sel), torch.gather(top_scores, 1, sel)
