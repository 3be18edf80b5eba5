"""HSTU encoder of the research stack (port of
`generative_recommenders_tpu/models/hstu.py`), padded-dense [B, N, D].

  per layer:  x + Dropout(Linear( u * LN(attn) ))
     where    [u, v, q, k] = split(silu(LN(x) @ W_uvqk))
              attn = (silu(q k^T + rel_bias) / N) * mask @ v

The attention goes through the port's wrappers, which pick the CUDA kernel
or its plain version by the tensors' device alone (the JAX package's
``attn_kernel`` choice and its length thresholds are not ported):

* relative bias enabled and timestamps given: the relative-bias pair K6 / K7
  (`ops/cuda/hstu_attention_relbias.py`), which rebuilds the bias from the
  two tables of `RelativeBucketedTimeAndPositionBasedBias` and never builds
  a [B, N, N] tensor on the card;
* relative bias disabled: the dense pair K1 / K2 (`ops/cuda/hstu_attention.py`),
  causal, with ``lengths``.

Both mask by length and give zeros at rows >= length, as the JAX package's
Pallas path does (its XLA path masks causally only and leaves other values
in those rows; nothing downstream reads them). Not ported yet: a relative
bias without timestamps (it needs the dense kernel's [B, N, N] bias
argument), attention dropout (the JAX package has it on its XLA path only),
the KV-cached delta path and activation recomputation; each raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from generative_recommenders_tpu_torch.modules.mlp import (
    Dense,
    new_param,
    normal,
    uniform,
    xavier_uniform,
)
from generative_recommenders_tpu_torch.ops.cuda.hstu_attention import hstu_mha_dense_cuda
from generative_recommenders_tpu_torch.ops.cuda.hstu_attention_relbias import (
    hstu_mha_dense_relbias_cuda,
)
from generative_recommenders_tpu_torch.ops.hstu_compute import dropout
from generative_recommenders_tpu_torch.ops.normalization import layer_norm


class RelativeBucketedTimeAndPositionBasedBias(nn.Module):
    """The two tables of the relative position + bucketed time-span bias:
    ``pos_w`` [2 * max_seq_len - 1] and ``ts_w`` [num_buckets + 1]. The bias
    itself is rebuilt inside the attention (kernel or plain version)."""

    def __init__(
        self, max_seq_len: int, num_buckets: int = 128, gen: Optional[torch.Generator] = None
    ) -> None:
        super().__init__()
        self.num_buckets = num_buckets
        self.ts_w = new_param((num_buckets + 1,), normal(0.02), gen)
        self.pos_w = new_param((2 * max_seq_len - 1,), normal(0.02), gen)


class SequentialTransductionUnit(nn.Module):
    """One HSTU block."""

    def __init__(
        self,
        embedding_dim: int,
        linear_dim: int,  # dv
        attention_dim: int,  # dqk
        num_heads: int,
        dropout_ratio: float,
        attn_dropout_ratio: float = 0.0,
        linear_activation: str = "silu",
        concat_ua: bool = False,
        enable_relative_attention_bias: bool = True,
        relative_bias_num_buckets: int = 128,
        normalization: str = "rel_bias",
        epsilon: float = 1e-6,
        max_total_seq_len: int = 0,  # the position table's Nm
        gen: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if attn_dropout_ratio > 0.0:
            raise NotImplementedError("attn_dropout_rate > 0 is not ported (no kernel serves it)")
        if linear_activation not in ("silu", "none"):
            raise ValueError(f"Unknown linear_activation {linear_activation}")
        self.linear_dim, self.attention_dim, self.num_heads = linear_dim, attention_dim, num_heads
        self.dropout_ratio = dropout_ratio
        self.linear_activation = linear_activation
        self.concat_ua = concat_ua
        self.epsilon = epsilon
        H, dqk, dv = num_heads, attention_dim, linear_dim
        self.uvqk = new_param((embedding_dim, dv * H * 2 + dqk * H * 2), normal(0.02), gen)
        fan_in = dv * H * (3 if concat_ua else 1)
        self.o = Dense(fan_in, embedding_dim)
        with torch.no_grad():
            xavier_uniform(self.o.kernel, gen)
            uniform(1.0 / fan_in**0.5)(self.o.bias, gen)  # torch.nn.Linear's bias init
        self.rel_attn_bias = None
        if normalization in ("rel_bias", "hstu_rel_bias") and enable_relative_attention_bias:
            if max_total_seq_len <= 0:
                raise ValueError("the relative bias needs max_total_seq_len, its table's size")
            self.rel_attn_bias = RelativeBucketedTimeAndPositionBasedBias(
                max_total_seq_len, relative_bias_num_buckets, gen
            )

    def forward(
        self,
        x: torch.Tensor,  # [B, N, D]
        lengths: torch.Tensor,  # int[B]
        all_timestamps: Optional[torch.Tensor],  # int[B, N], full length
        deterministic: bool = False,
        gen: Optional[torch.Generator] = None,  # the dropout masks' generator
    ) -> torch.Tensor:
        B, N, _ = x.shape
        H, dqk, dv = self.num_heads, self.attention_dim, self.linear_dim
        mixed = layer_norm(x, eps=self.epsilon) @ self.uvqk
        if self.linear_activation == "silu":
            mixed = F.silu(mixed)
        u, v, q, k = torch.split(mixed, [dv * H, dv * H, dqk * H, dqk * H], dim=-1)
        # q, k and v stay views of the projection; the kernels read them strided
        q, k, v = q.reshape(B, N, H, dqk), k.reshape(B, N, H, dqk), v.reshape(B, N, H, dv)
        if self.rel_attn_bias is None:
            attn = hstu_mha_dense_cuda(q, k, v, lengths, alpha=1.0, max_seq_len=N, causal=True)
        elif all_timestamps is None:
            raise NotImplementedError(
                "a relative bias without timestamps needs the dense kernel's "
                "[B, N, N] bias argument, which is not ported"
            )
        else:
            attn = hstu_mha_dense_relbias_cuda(
                q, k, v, lengths, all_timestamps, self.rel_attn_bias.pos_w,
                self.rel_attn_bias.ts_w, alpha=1.0, max_seq_len=N,
                num_buckets=self.rel_attn_bias.num_buckets, causal=True,
            )
        attn = attn.reshape(B, N, H * dv)
        a = layer_norm(attn, eps=self.epsilon)
        o_input = torch.cat([u, a, u * a], dim=-1) if self.concat_ua else u * a
        if not deterministic:
            o_input = dropout(o_input, self.dropout_ratio, gen)
        return self.o(o_input) + x


class HSTUEncoder(nn.Module):
    """A stack of `SequentialTransductionUnit`s, ``layer_0`` .. ``layer_{n-1}``.
    Input and output are padded-dense [B, N, D]; nothing downstream reads
    the pads (the loss masks them, `encode` gathers position lengths - 1)."""

    def __init__(
        self,
        embedding_dim: int,
        num_blocks: int,
        num_heads: int,
        attention_dim: int,  # dqk
        linear_dim: int,  # dv
        linear_dropout_rate: float,
        attn_dropout_rate: float = 0.0,
        linear_activation: str = "silu",
        enable_relative_attention_bias: bool = True,
        concat_ua: bool = False,
        normalization: str = "rel_bias",
        max_total_seq_len: int = 0,
        gen: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"layer_{i}", SequentialTransductionUnit(
                embedding_dim=embedding_dim,
                linear_dim=linear_dim,
                attention_dim=attention_dim,
                num_heads=num_heads,
                dropout_ratio=linear_dropout_rate,
                attn_dropout_ratio=attn_dropout_rate,
                linear_activation=linear_activation,
                concat_ua=concat_ua,
                enable_relative_attention_bias=enable_relative_attention_bias,
                normalization=normalization,
                max_total_seq_len=max_total_seq_len,
                gen=gen,
            ))

    def forward(
        self,
        user_embeddings: torch.Tensor,  # [B, N, D], already preprocessed
        lengths: torch.Tensor,
        all_timestamps: Optional[torch.Tensor],
        deterministic: bool = False,
        gen: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        x = user_embeddings
        for i in range(self.num_blocks):
            x = getattr(self, f"layer_{i}")(x, lengths, all_timestamps, deterministic, gen)
        return x
