"""Negatives samplers of the research stack (port of
`generative_recommenders_tpu/models/samplers.py`): uniform over the corpus
(`LocalNegativesSampler`) or over the batch's own items
(`InBatchNegativesSampler`). The random offsets come from an explicit
``torch.Generator``; the same seed does not draw the JAX package's
negatives.
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


class InBatchState(NamedTuple):
    ids: torch.Tensor  # int[M]: the batch's (maybe deduplicated) ids, valid in [0, count)
    embeddings: torch.Tensor  # [M, D]
    count: torch.Tensor  # int[]: the number of valid entries, on the device


def _compact(values: torch.Tensor, dest: torch.Tensor, M: int) -> torch.Tensor:
    """out[dest[i]] = values[i] into M + 1 zeroed slots, the last of which
    takes every dropped entry (``dest == M``) and is cut off: the JAX
    package's ``.at[dest].set(..., mode="drop")``. Differentiable in
    ``values`` (a dropped entry gets no gradient)."""
    out = values.new_zeros((M + 1,) + tuple(values.shape[1:]))
    return out.index_copy(0, dest, values)[:M]


class InBatchNegativesSampler(NamedTuple):
    """Uniform sampling over the ids present in the batch, with optional
    deduplication; `process_batch` builds the state a step samples from."""

    l2_norm: bool
    l2_norm_eps: float
    dedup_embeddings: bool

    def process_batch(
        self,
        ids: torch.Tensor,  # int[M]
        presences: torch.Tensor,  # bool[M]
        embeddings: torch.Tensor,  # [M, D]
    ) -> InBatchState:
        """Compacts the present entries to the front, in order; with
        ``dedup_embeddings`` sorts the ids and keeps each one's first
        occurrence. Static shapes, no host sync: ``count`` stays on the
        device."""
        M = ids.shape[0]
        if self.dedup_embeddings:
            sentinel = torch.iinfo(ids.dtype).max
            keyed = torch.where(presences, ids, sentinel)
            order = torch.argsort(keyed, stable=True)
            sorted_ids = keyed[order]
            prev = torch.cat([sorted_ids.new_full((1,), -1), sorted_ids[:-1]])
            keep = (sorted_ids != prev) & (sorted_ids != sentinel)
            values, emb = sorted_ids, embeddings[order]
        else:
            keep, values, emb = presences, ids, embeddings
        dest = torch.where(keep, torch.cumsum(keep, 0) - 1, M)
        return InBatchState(
            ids=_compact(values, dest, M),
            embeddings=maybe_l2_norm(_compact(emb, dest, M), self.l2_norm, self.l2_norm_eps),
            count=keep.sum(),
        )

    def __call__(
        self,
        gen: torch.Generator,  # on the state's device
        state: InBatchState,
        positive_ids: torch.Tensor,  # int[...]
        num_to_sample: int,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        shape = tuple(positive_ids.shape) + (num_to_sample,)
        # floor(U * c) for U uniform on [0, 1) is uniform on {0, .., c - 1}:
        # the distribution of the JAX package's randint(0, c), drawn without
        # reading c on the host; the clamp catches a product rounded up to c
        c = state.count.clamp_min(1)
        u = torch.rand(shape, generator=gen, device=state.ids.device)
        offsets = torch.minimum((u * c).long(), c - 1)
        return state.ids[offsets], state.embeddings[offsets]
