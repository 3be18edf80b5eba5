"""SASRec, the research stack's softmax-attention baseline (port of
`generative_recommenders_tpu/models/sasrec.py`): a pre-LN causal transformer
whose feed-forward is two kernel-1 convolutions, i.e. two dense layers.

  per block:  q = LN(x)
              x = FFN(LN(q + MHA(q, x, x))) * valid_mask

Plain `matmul` and `softmax`, as the JAX package's einsums are; no HSTU
kernel is involved. A bfloat16 input (``compute_dtype="bfloat16"``) stays
bfloat16 through the first block's query layer norm only: the float32 input
projection promotes the attention to float32, and the residual sum with it
the rest of the stack, as flax promotes them. The attention dropout draws
its mask from the caller's generator, which `scaled_dot_product_attention`
would not. Parameter names and layouts are the flax tree's
(``attn_i/in_proj_weight`` [3D, D], ``ffn_i/conv1/kernel`` [in, out]), so
`convert.params_from_flax` carries them over.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from generative_recommenders_tpu_torch.modules.mlp import Dense, new_param, xavier_normal, zeros
from generative_recommenders_tpu_torch.ops.hstu_compute import dropout
from generative_recommenders_tpu_torch.ops.normalization import layer_norm


class SoftmaxMultiheadAttention(nn.Module):
    """``torch.nn.MultiheadAttention`` (batch first) as the JAX package
    writes it: one fused [3D, D] input projection, xavier-normal over the
    whole tensor, zero biases, dropout on the softmax probabilities."""

    def __init__(
        self, embed_dim: int, num_heads: int, dropout_rate: float,
        gen: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        D = embed_dim
        self.num_heads, self.dropout_rate = num_heads, dropout_rate
        self.in_proj_weight = new_param((3 * D, D), xavier_normal, gen)
        self.in_proj_bias = new_param((3 * D,), zeros, gen)
        self.out_proj_weight = new_param((D, D), xavier_normal, gen)
        self.out_proj_bias = new_param((D,), zeros, gen)

    def forward(
        self,
        query: torch.Tensor,  # [B, N, D]
        key: torch.Tensor,
        value: torch.Tensor,
        attn_mask: torch.Tensor,  # bool[N, N]; True = blocked (torch's convention)
        deterministic: bool = False,
        gen: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        B, N, D = query.shape
        H = self.num_heads
        dh = D // H
        w, b = self.in_proj_weight, self.in_proj_bias
        # a bfloat16 input meets the float32 projection in float32, as in flax
        query, key, value = (t.to(torch.promote_types(t.dtype, w.dtype)) for t in (query, key, value))
        q = (query @ w[:D].T + b[:D]).reshape(B, N, H, dh).transpose(1, 2)
        k = (key @ w[D : 2 * D].T + b[D : 2 * D]).reshape(B, N, H, dh).transpose(1, 2)
        v = (value @ w[2 * D :].T + b[2 * D :]).reshape(B, N, H, dh).transpose(1, 2)
        scores = (q @ k.transpose(-1, -2)) / dh**0.5  # [B, H, N, N]
        # the causal mask always keeps the diagonal: no row is all -inf
        p = torch.softmax(scores.masked_fill(attn_mask, float("-inf")), dim=-1)
        if not deterministic:
            p = dropout(p, self.dropout_rate, gen)
        out = (p @ v).transpose(1, 2).reshape(B, N, D)
        return out @ self.out_proj_weight.T + self.out_proj_bias


class StandardAttentionFF(nn.Module):
    """conv1 -> ReLU or exact GELU -> dropout -> conv2 -> dropout, plus the
    input."""

    def __init__(
        self, embedding_dim: int, hidden_dim: int, activation_fn: str, dropout_rate: float,
        gen: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if activation_fn not in ("relu", "gelu"):
            raise ValueError(f"Unknown ffn_activation_fn {activation_fn}")
        self.activation_fn, self.dropout_rate = activation_fn, dropout_rate
        self.conv1 = Dense(embedding_dim, hidden_dim, gen)
        self.conv2 = Dense(hidden_dim, embedding_dim, gen)

    def forward(
        self, inputs: torch.Tensor, deterministic: bool = False,
        gen: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        x = self.conv1(inputs)
        x = F.gelu(x) if self.activation_fn == "gelu" else F.relu(x)
        if not deterministic:
            x = dropout(x, self.dropout_rate, gen)
        x = self.conv2(x)
        if not deterministic:
            x = dropout(x, self.dropout_rate, gen)
        return x + inputs


class SASRecEncoder(nn.Module):
    """``attn_0``, ``ffn_0`` .. ``attn_{n-1}``, ``ffn_{n-1}``; input and output
    padded-dense [B, N, D]."""

    def __init__(
        self,
        embedding_dim: int,
        num_blocks: int,
        num_heads: int,
        ffn_hidden_dim: int,
        ffn_activation_fn: str = "relu",
        ffn_dropout_rate: float = 0.2,
        gen: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"attn_{i}", SoftmaxMultiheadAttention(
                embedding_dim, num_heads, ffn_dropout_rate, gen))
            self.add_module(f"ffn_{i}", StandardAttentionFF(
                embedding_dim, ffn_hidden_dim, ffn_activation_fn, ffn_dropout_rate, gen))

    def forward(
        self,
        user_embeddings: torch.Tensor,  # [B, N, D], already preprocessed
        lengths: torch.Tensor,  # unused: the valid mask zeroes the pads
        all_timestamps: Optional[torch.Tensor] = None,  # unused
        deterministic: bool = False,
        gen: Optional[torch.Generator] = None,
        valid_mask: Optional[torch.Tensor] = None,  # [B, N, 1]
    ) -> torch.Tensor:
        B, N, _ = user_embeddings.shape
        attn_mask = torch.triu(
            torch.ones((N, N), dtype=torch.bool, device=user_embeddings.device), diagonal=1
        )
        x = user_embeddings
        for i in range(self.num_blocks):
            q = layer_norm(x, eps=1e-8)
            mha_out = getattr(self, f"attn_{i}")(q, x, x, attn_mask, deterministic, gen)
            x = getattr(self, f"ffn_{i}")(layer_norm(q + mha_out, eps=1e-8), deterministic, gen)
            if valid_mask is not None:
                x = x * valid_mask
        return x
