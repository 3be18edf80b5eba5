"""GLU layers (port of `generative_recommenders_tpu/models/rails/layers.py`):
``x @ w + b`` with ``w`` [in, 2 out] and ``b`` [2 out], the flax names and
layout, split into lhs and rhs; the output is act(lhs) * rhs."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from generative_recommenders_tpu_torch.modules.mlp import new_param, normal, zeros


class _GLUBase(nn.Module):
    def __init__(self, in_features: int, out_features: int, gen: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.w = new_param((in_features, 2 * out_features), normal(0.02), gen)
        self.b = new_param((2 * out_features,), zeros, gen)

    def _lhs_rhs(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return (x @ self.w + self.b).chunk(2, dim=-1)


class GeGLU(_GLUBase):
    """GELU (exact) gated linear unit."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lhs, rhs = self._lhs_rhs(x)
        return F.gelu(lhs) * rhs


class SwiGLU(_GLUBase):
    """SiLU gated linear unit (arXiv:2002.05202)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lhs, rhs = self._lhs_rhs(x)
        return F.silu(lhs) * rhs
