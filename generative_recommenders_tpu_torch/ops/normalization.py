"""Layer norm, RMS norm and swish layer norm (port of
`generative_recommenders_tpu/ops/normalization.py`), float32 statistics.
The per-head group norm is computed inline where the STU uses it
(`ops/hstu_compute.py:norm_mul_dropout`)."""

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


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None, eps: float = 1e-6) -> torch.Tensor:
    """x / sqrt(mean(x^2) + eps) over the last dim, times ``weight``."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)


def swish_layer_norm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    """x * sigmoid(LN(x))."""
    return x * torch.sigmoid(layer_norm(x, weight, bias, eps))
