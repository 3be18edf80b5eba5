"""Small building blocks shared by the modules (port of
`generative_recommenders_tpu/modules/mlp.py`).

Parameters keep the JAX package's names and layouts (a dense kernel is
[in, out], used as ``x @ kernel``), so `convert.params_from_flax` carries
them over unchanged. Each module takes a ``torch.Generator`` for its random
initialisation and creates its tensors on the default device (use
``with torch.device(...)``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn

from generative_recommenders_tpu_torch.ops.normalization import layer_norm

Init = Callable[[torch.Tensor, Optional[torch.Generator]], None]


def ones(t: torch.Tensor, gen: Optional[torch.Generator]) -> None:
    nn.init.ones_(t)


def zeros(t: torch.Tensor, gen: Optional[torch.Generator]) -> None:
    nn.init.zeros_(t)


def normal(std: float) -> Init:
    return lambda t, gen: nn.init.normal_(t, 0.0, std, generator=gen)


def uniform(limit: float) -> Init:
    return lambda t, gen: nn.init.uniform_(t, -limit, limit, generator=gen)


def truncated_normal(std: float) -> Init:
    return lambda t, gen: nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)


def xavier_normal(t: torch.Tensor, gen: Optional[torch.Generator]) -> None:
    nn.init.normal_(t, 0.0, math.sqrt(2.0 / (t.shape[-2] + t.shape[-1])), generator=gen)


def xavier_uniform(t: torch.Tensor, gen: Optional[torch.Generator]) -> None:
    limit = math.sqrt(6.0 / (t.shape[-2] + t.shape[-1]))
    nn.init.uniform_(t, -limit, limit, generator=gen)


def new_param(shape: Sequence[int], init: Init, gen: Optional[torch.Generator]) -> nn.Parameter:
    t = torch.empty(tuple(shape))
    with torch.no_grad():
        init(t, gen)
    return nn.Parameter(t)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` with kernel [in, out]. As
    flax's, it promotes the input and the kernel to their common type: a
    bfloat16 input meets the float32 kernel in float32."""

    def __init__(
        self, in_dim: int, out_dim: int, gen: Optional[torch.Generator] = None,
        use_bias: bool = True,
    ) -> None:
        super().__init__()
        self.kernel = new_param((in_dim, out_dim), xavier_normal, gen)
        self.bias = new_param((out_dim,), zeros, gen) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(torch.promote_types(x.dtype, self.kernel.dtype)) @ self.kernel
        return y if self.bias is None else y + self.bias


class LayerNormModule(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.eps = eps
        self.weight = new_param((dim,), ones, None)
        self.bias = new_param((dim,), zeros, None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, eps=self.eps)


class SwishLayerNorm(LayerNormModule):
    """x * sigmoid(LN(x))."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(super().forward(x))


class SwishMLP(nn.Module):
    """Dense(hidden) -> SwishLN -> Dense(out) -> LN."""

    def __init__(
        self, in_dim: int, hidden_dim: int, output_dim: int,
        gen: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.fc1 = Dense(in_dim, hidden_dim, gen)
        self.sln = SwishLayerNorm(hidden_dim)
        self.fc2 = Dense(hidden_dim, output_dim, gen)
        self.ln = LayerNormModule(output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln(self.fc2(self.sln(self.fc1(x))))
