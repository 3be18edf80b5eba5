"""Full-corpus retrieval eval: HR@k / NDCG@k / MRR with seen-id filtering
(port of `generative_recommenders_tpu/train/eval_metrics.py`).

The rank is computed directly as

    rank(target) = 1 + #{valid items with score > score(target)}

which equals locating the target in a top-k list up to the order of float
ties, without sorting the corpus. Ranks above k become MAX_K + 1, and a
target that was filtered as seen is a miss.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

MAX_K = 2500


def build_id_to_col(item_ids: np.ndarray, max_item_id: int) -> np.ndarray:
    """Lookup table from item id to its column in the corpus score matrix.
    Ids outside the corpus map to X, the sentinel past the last column."""
    X = item_ids.shape[0]
    col = np.full((max_item_id + 2,), X, dtype=np.int64)
    col[item_ids] = np.arange(X, dtype=np.int64)
    return col


def ranks_from_scores(
    scores: torch.Tensor,  # [B, X] similarity scores over the corpus
    id_to_col: torch.Tensor,  # int64[max_id + 2]
    target_ids: torch.Tensor,  # int[B]
    past_ids: torch.Tensor,  # int[B, N] (0 = padding): the seen ids to filter
    k: int,
) -> torch.Tensor:
    """Rank of each target given corpus scores; misses get MAX_K + 1."""
    B, X = scores.shape
    tcol = id_to_col[target_ids]  # [B]
    tscore = scores.gather(1, tcol.clamp(0, X - 1)[:, None])[:, 0]
    seen_cols = torch.where(past_ids > 0, id_to_col[past_ids], X)  # [B, N]; X = drop
    # the sentinel X writes into one padded column, dropped again
    padded = torch.cat([scores, scores.new_zeros((B, 1))], dim=1)
    padded.scatter_(1, seen_cols, float("-inf"))
    scores = padded[:, :X]
    target_seen = ((past_ids == target_ids[:, None]) & (past_ids > 0)).any(dim=1)
    rank = 1 + (scores > tscore[:, None]).sum(dim=1)
    rank = torch.where(target_seen, MAX_K + 1, rank)
    rank = torch.where(rank > k, MAX_K + 1, rank)
    return rank.to(torch.int32)


def target_ranks(
    query_embeddings: torch.Tensor,  # [B, D]
    item_embeddings: torch.Tensor,  # [X, D] (normalised like eval candidates)
    id_to_col: torch.Tensor,
    target_ids: torch.Tensor,  # int[B]
    past_ids: torch.Tensor,  # int[B, N]
    k: int,
) -> torch.Tensor:
    """Dot-product full-corpus rank (brute-force MIPS)."""
    scores = query_embeddings.float() @ item_embeddings.float().T
    return ranks_from_scores(scores, id_to_col, target_ids, past_ids, k)


def metrics_from_ranks(
    ranks: torch.Tensor,  # int[B]
    target_ratings: Optional[torch.Tensor] = None,  # int[B]
    min_positive_rating: int = 4,
) -> Dict[str, torch.Tensor]:
    """Per-example metric values. The rating-filtered variants come with
    ``_rating_mask``, which the accumulator applies."""
    r = ranks.float()
    dcg = torch.where(ranks <= MAX_K, 1.0 / torch.log2(r + 1.0), 0.0)
    out: Dict[str, torch.Tensor] = {}
    for kk in (1, 10, 50, 100, 200):
        out[f"ndcg@{kk}"] = torch.where(ranks <= kk, dcg, 0.0)
    for kk in (1, 10, 50, 100, 200, 500, 1000):
        out[f"hr@{kk}"] = (ranks <= kk).float()
    out["mrr"] = 1.0 / r
    if target_ratings is not None:
        out["_rating_mask"] = (target_ratings >= min_positive_rating).float()
        out[f"hr@10_>={min_positive_rating}"] = out["hr@10"]
        out[f"hr@50_>={min_positive_rating}"] = out["hr@50"]
        out[f"mrr_>={min_positive_rating}"] = out["mrr"]
        out["ndcg@10_>=4"] = out["ndcg@10"]
    return out


class MetricsAccumulator:
    """Host-side accumulation of per-example metrics across eval batches,
    with rating-filtered averaging for the keys that hold ``_>=``."""

    def __init__(self) -> None:
        self._sums: Dict[str, float] = {}
        self._counts: Dict[str, float] = {}

    def update(self, metrics: Dict[str, torch.Tensor]) -> None:
        m = {k: v.detach().cpu().numpy() for k, v in metrics.items()}
        mask = m.pop("_rating_mask", None)
        for key, vals in m.items():
            if "_>=" in key:
                assert mask is not None
                s, c = float((vals * mask).sum()), float(mask.sum())
            else:
                s, c = float(vals.sum()), float(vals.size)
            self._sums[key] = self._sums.get(key, 0.0) + s
            self._counts[key] = self._counts.get(key, 0.0) + c

    def compute(self) -> Dict[str, float]:
        return {
            k: (self._sums[k] / self._counts[k] if self._counts[k] else float("nan"))
            for k in self._sums
        }
