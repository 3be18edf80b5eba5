"""Layer norm (port of `generative_recommenders_tpu/ops/normalization.py`)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def layer_norm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    """LayerNorm over the last dim with float32 statistics: PyTorch's fused
    `F.layer_norm`, one kernel where the JAX package's formula (mean,
    centred square, rsqrt, affine) would take eight."""
    y = F.layer_norm(
        x.float(),
        x.shape[-1:],
        None if weight is None else weight.float(),
        None if bias is None else bias.float(),
        eps,
    )
    return y.to(x.dtype)
