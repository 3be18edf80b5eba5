"""MoL brute-force top-k retrieval (port of
`generative_recommenders_tpu/indexing/mol_top_k.py`): the corpus's MoL item
side is computed once, then each query batch is scored against it in chunks
of items and the top k kept. Plugs into `CandidateIndex.get_top_k_outputs`
as ``top_k_module``. ``jax.lax.map`` over the chunks becomes a loop.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


class MoLBruteForceTopK:
    """Bound to a trained `SequentialRecommender` with the MoL similarity
    (its weights are the module's own)."""

    def __init__(
        self,
        model,  # SequentialRecommender with interaction_module_type="MoL"
        item_ids: torch.Tensor,  # int[X]
        item_embeddings: torch.Tensor,  # [X, Di]: the raw (pre-MoL) item embeddings
        item_chunk_size: int = 8192,
    ) -> None:
        self._model = model
        self._ids = item_ids
        X = item_embeddings.shape[0]
        self._X = X
        self._chunk = min(item_chunk_size, X)
        padded = torch.cat(
            [item_embeddings, item_embeddings.new_zeros(((-X) % self._chunk, item_embeddings.shape[1]))]
        )
        with torch.no_grad():
            self._i_comp, self._gi = model.mol_item_components(padded)

    @torch.no_grad()
    def scores(
        self, query_embeddings: torch.Tensor, user_ids: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """MoL scores [B, X] of the queries over the corpus."""
        c, gi = self._chunk, self._gi
        s = [
            self._model.mol_score_components(
                query_embeddings, self._i_comp[i : i + c], None if gi is None else gi[i : i + c],
                user_ids,
            )
            for i in range(0, self._i_comp.shape[0], c)
        ]
        return torch.cat(s, dim=1)[:, : self._X]

    def __call__(
        self, query_embeddings: torch.Tensor, k: int, user_ids: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(top-k scores [B, k], their ids [B, k]), best first: the
        `CandidateIndex` top-k interface."""
        top_scores, top_idx = torch.topk(self.scores(query_embeddings, user_ids), k, dim=1)
        return top_scores, self._ids[top_idx]
