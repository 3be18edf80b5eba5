"""Output postprocessors (port of
`generative_recommenders_tpu/modules/postprocessors.py`): L2 norm, layer
norm, and the layer norm over periodic time features."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from generative_recommenders_tpu_torch.modules.mlp import Dense, new_param, ones, zeros
from generative_recommenders_tpu_torch.ops.normalization import layer_norm


class L2NormPostprocessor(nn.Module):
    def forward(
        self, seq_embeddings: torch.Tensor, seq_timestamps: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        norm = torch.linalg.vector_norm(seq_embeddings, dim=-1, keepdim=True)
        return seq_embeddings / norm.clamp_min(1e-6)


class LayerNormPostprocessor(nn.Module):
    def __init__(self, embedding_dim: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.eps = eps
        self.ln_weight = new_param((embedding_dim,), ones, None)
        self.ln_bias = new_param((embedding_dim,), zeros, None)

    def forward(
        self, seq_embeddings: torch.Tensor, seq_timestamps: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        return layer_norm(seq_embeddings, self.ln_weight, self.ln_bias, eps=self.eps)


class TimestampLayerNormPostprocessor(LayerNormPostprocessor):
    """Polar (cos, sin) encodings of periodic time features, e.g. hour of day
    (3600, 24) and day of week (86400, 7), concatenated to the embedding,
    combined by a dense layer, then layer norm."""

    def __init__(
        self,
        embedding_dim: int,
        time_duration_features: Tuple[Tuple[int, int], ...],
        eps: float = 1e-5,
        gen: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__(embedding_dim, eps)
        self.register_buffer(
            "_period_units",
            torch.tensor([f[0] for f in time_duration_features], dtype=torch.float32),
            persistent=False,
        )
        self.register_buffer(
            "_units_per_period",
            torch.tensor([f[1] for f in time_duration_features], dtype=torch.float32),
            persistent=False,
        )
        self.time_feature_combiner = Dense(
            embedding_dim + 2 * len(time_duration_features), embedding_dim, gen
        )

    def forward(
        self, seq_embeddings: torch.Tensor, seq_timestamps: torch.Tensor
    ) -> torch.Tensor:
        ts = seq_timestamps.to(torch.float32)[..., None]
        units_since_epoch = torch.floor(ts / self._period_units)
        # the reference hardcodes 3.14
        phase = (
            torch.remainder(units_since_epoch, self._units_per_period)
            / self._units_per_period * 2.0 * 3.14
        )
        polar = torch.stack([torch.cos(phase), torch.sin(phase)], dim=-1).flatten(-2)
        combined = torch.cat([seq_embeddings, polar.to(seq_embeddings.dtype)], dim=-1)
        return super().forward(self.time_feature_combiner(combined))
