"""Output embedding postprocessors of the research stack (port of
`generative_recommenders_tpu/models/postprocessors.py`); both are
parameter-free functions."""

from __future__ import annotations

from typing import Callable

import torch

from generative_recommenders_tpu_torch.ops.normalization import layer_norm


def l2_norm_postprocess(
    output_embeddings: torch.Tensor, embedding_dim: int, eps: float = 1e-6
) -> torch.Tensor:
    x = output_embeddings[..., :embedding_dim]
    # clamped before the square root: the values of x / clamp(||x||, eps)
    # with a finite gradient at x == 0 (padding rows)
    sum_sq = x.square().sum(dim=-1, keepdim=True)
    return x / torch.sqrt(sum_sq.clamp_min(eps * eps))


def layer_norm_postprocess(
    output_embeddings: torch.Tensor, embedding_dim: int, eps: float = 1e-6
) -> torch.Tensor:
    return layer_norm(output_embeddings[..., :embedding_dim], eps=eps)


def make_output_postprocessor(
    kind: str, embedding_dim: int, eps: float = 1e-6
) -> Callable[[torch.Tensor], torch.Tensor]:
    if kind in ("l2_norm", "l2"):
        return lambda x: l2_norm_postprocess(x, embedding_dim, eps)
    if kind in ("layer_norm", "ln"):
        return lambda x: layer_norm_postprocess(x, embedding_dim, eps)
    raise ValueError(f"Unknown output postprocessor {kind}")
