"""HSTU layer compute around the attention (port of
`generative_recommenders_tpu/ops/hstu_compute.py`), padded-dense [B, N, D].

The uvqk projection and the norm * u + output projection stay plain PyTorch
(one matmul each, as the JAX package left them to XLA). The attention
between them, `delta_hstu_mha` included, is in `ops/cuda/hstu_attention.py`,
whose wrappers pick kernel or plain version by the device of their inputs;
the TPU's VMEM fit gate and its ``kernel="auto"`` length threshold are not
ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from generative_recommenders_tpu_torch.ops.normalization import layer_norm

__all__ = [
    "dropout",
    "hstu_compute_output",
    "hstu_compute_uqvk",
    "norm_mul_dropout",
    "output_projection",
    "split_uvqk",
    "uvqk_projection",
]


def dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: keeps each element with probability 1 - ``rate``
    and scales it by 1 / (1 - rate). The mask comes from ``gen``, which must
    be on ``x``'s device (`F.dropout` takes no generator). The TPU's random
    bits are not reproduced: the same seed gives other masks."""
    if rate <= 0.0:
        return x
    if gen is None:
        raise ValueError("dropout needs a torch.Generator")
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def hstu_compute_uqvk(
    x: torch.Tensor,  # [B, N, D]
    norm_weight: torch.Tensor,  # [D]
    norm_bias: torch.Tensor,  # [D]
    uvqk_weight: torch.Tensor,  # [D, (2*hidden + 2*attn) * H]
    uvqk_bias: torch.Tensor,  # [(2*hidden + 2*attn) * H]
    *,
    num_heads: int,
    attn_dim: int,
    hidden_dim: int,
    norm_eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """LN(x) @ W + b split [u, v, q, k]; returns (silu(u) [B, N, H*hidden],
    q, k [B, N, H, attn], v [B, N, H, hidden]). q, k and v are views of the
    projection."""
    normed_x = layer_norm(x, weight=norm_weight, bias=norm_bias, eps=norm_eps)
    return split_uvqk(
        uvqk_projection(normed_x, uvqk_weight, uvqk_bias, x.dtype),
        num_heads=num_heads, attn_dim=attn_dim, hidden_dim=hidden_dim,
    )


def uvqk_projection(
    normed_x: torch.Tensor, uvqk_weight: torch.Tensor, uvqk_bias: torch.Tensor, dtype: torch.dtype
) -> torch.Tensor:
    """normed_x @ W + b in float32, cast to ``dtype``."""
    return (normed_x.float() @ uvqk_weight.float() + uvqk_bias).to(dtype)


def split_uvqk(
    uvqk: torch.Tensor, *, num_heads: int, attn_dim: int, hidden_dim: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Splits the projection [B, N, (2*hidden + 2*attn) * H] into silu(u), q,
    k and v (views)."""
    B, N, _ = uvqk.shape
    h, a = hidden_dim * num_heads, attn_dim * num_heads
    u, v, q, k = torch.split(uvqk, [h, h, a, a], dim=-1)
    return (
        F.silu(u),
        q.reshape(B, N, num_heads, attn_dim),
        k.reshape(B, N, num_heads, attn_dim),
        v.reshape(B, N, num_heads, hidden_dim),
    )


def norm_mul_dropout(
    attn: torch.Tensor,  # [B, N, H*hidden]
    u: torch.Tensor,  # [B, N, H*hidden]
    weight: torch.Tensor,
    bias: torch.Tensor,
    *,
    eps: float = 1e-6,
    group_norm: bool = False,
    num_heads: int = 1,
    linear_dim: int = -1,
    dropout_ratio: float = 0.0,
    dropout_gen: Optional[torch.Generator] = None,
    training: bool = False,
) -> torch.Tensor:
    """cat([u, attn, u * norm(attn)]) (the STU's concat_ux form), with
    inverted dropout on the concatenation when ``training``."""
    dtype = attn.dtype
    x32, u32 = attn.float(), u.float()
    if group_norm:
        B, N, _ = x32.shape
        g = x32.reshape(B, N, num_heads, linear_dim)
        mean = g.mean(dim=-1, keepdim=True)
        var = (g - mean).square().mean(dim=-1, keepdim=True)
        g = (g - mean) * torch.rsqrt(var + eps)
        g = g * weight.float().reshape(1, 1, num_heads, 1)
        g = g + bias.float().reshape(1, 1, num_heads, 1)
        y = u32 * g.reshape(B, N, num_heads * linear_dim)
    else:
        y = u32 * layer_norm(x32, weight=weight.float(), bias=bias.float(), eps=eps)
    y = torch.cat([u32, x32, y], dim=-1)
    if training:
        y = dropout(y, dropout_ratio, dropout_gen)
    return y.to(dtype)


def hstu_compute_output(
    attn: torch.Tensor,  # [B, N, H*hidden]
    u: torch.Tensor,  # [B, N, H*hidden]
    x: torch.Tensor,  # [B, N, D] (residual)
    norm_weight: torch.Tensor,
    norm_bias: torch.Tensor,
    output_weight: torch.Tensor,  # [3*H*hidden, D]
    *,
    num_heads: int,
    linear_dim: int,
    norm_eps: float = 1e-6,
    group_norm: bool = False,
    dropout_ratio: float = 0.0,
    dropout_gen: Optional[torch.Generator] = None,
    training: bool = False,
) -> torch.Tensor:
    """x + norm_mul_dropout(attn, u) @ W_o."""
    y = norm_mul_dropout(
        attn, u, norm_weight, norm_bias, eps=norm_eps, group_norm=group_norm,
        num_heads=num_heads, linear_dim=linear_dim, dropout_ratio=dropout_ratio,
        dropout_gen=dropout_gen, training=training,
    )
    return output_projection(y, x, output_weight)


def output_projection(y: torch.Tensor, x: torch.Tensor, output_weight: torch.Tensor) -> torch.Tensor:
    """x + y @ W_o, the residual in x's type."""
    return x + (y @ output_weight.to(y.dtype)).to(x.dtype)
