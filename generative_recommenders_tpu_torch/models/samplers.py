"""Negatives sampler of the research stack (port of
`generative_recommenders_tpu/models/samplers.py`). The random offsets come
from an explicit ``torch.Generator``; the same seed does not draw the JAX
package's negatives. `InBatchNegativesSampler` is not ported yet.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch


def maybe_l2_norm(x: torch.Tensor, l2_norm: bool, eps: float) -> torch.Tensor:
    """x / max(||x||, eps), clamped before the square root so that the
    gradient at x == 0 (padding embeddings) is finite."""
    if not l2_norm:
        return x
    sum_sq = x.square().sum(dim=-1, keepdim=True)
    return x / torch.sqrt(sum_sq.clamp_min(eps * eps))


class LocalNegativesSampler(NamedTuple):
    """Uniform sampling over the whole corpus."""

    all_item_ids: torch.Tensor  # int[X]
    l2_norm: bool
    l2_norm_eps: float

    def __call__(
        self,
        gen: torch.Generator,  # on the ids' device
        positive_ids: torch.Tensor,  # int[...]
        num_to_sample: int,
        item_embedding_fn: Callable[[torch.Tensor], torch.Tensor],
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        shape = tuple(positive_ids.shape) + (num_to_sample,)
        offsets = torch.randint(
            0, self.all_item_ids.shape[0], shape, generator=gen, device=self.all_item_ids.device
        )
        sampled_ids = self.all_item_ids[offsets]
        emb = maybe_l2_norm(item_embedding_fn(sampled_ids), self.l2_norm, self.l2_norm_eps)
        return sampled_ids, emb

    def normalize_embeddings(self, x: torch.Tensor) -> torch.Tensor:
        return maybe_l2_norm(x, self.l2_norm, self.l2_norm_eps)
