"""STU, the production HSTU layer, with its KV cache and the M-FALCON delta
path (port of `generative_recommenders_tpu/modules/stu.py`).

Layout is padded-dense [B, N, D] plus lengths; the attention kernels handle
the jaggedness. The KV cache is an explicit `KVCache` value passed through
calls. ``deterministic=False`` turns on the output dropout, drawn from the
``torch.Generator`` passed with it. The dynamic SD/L2 wrappers
(`modules/dynamic_stu.py`), the `nn.remat` recompute policy (it changes
memory, not numbers) and `sort_by_length` are not part of this port yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from generative_recommenders_tpu_torch.modules.mlp import (
    new_param,
    ones,
    xavier_uniform,
    zeros,
)
from generative_recommenders_tpu_torch.ops.cuda.hstu_attention import (
    delta_hstu_mha_cuda,
    hstu_mha_dense_cuda,
)
from generative_recommenders_tpu_torch.ops.hstu_compute import (
    hstu_compute_output,
    hstu_compute_uqvk,
)


@dataclasses.dataclass(frozen=True)
class STULayerConfig:
    embedding_dim: int
    num_heads: int
    hidden_dim: int
    attention_dim: int
    output_dropout_ratio: float = 0.3
    causal: bool = True
    target_aware: bool = True
    max_attn_len: int = 0
    attn_alpha: Optional[float] = None
    use_group_norm: bool = False
    contextual_seq_len: int = 0
    # fixed silu normaliser; 0 => the padded length of each call. M-FALCON
    # serving sets it so the prefill and delta passes normalise alike.
    norm_seq_len: int = 0

    @property
    def alpha(self) -> float:
        return self.attn_alpha or 1.0 / (self.attention_dim**0.5)


class KVCache(NamedTuple):
    """Padded KV cache of one STU layer."""

    k: torch.Tensor  # [B, Nc, H, D]
    v: torch.Tensor  # [B, Nc, H, V]
    lengths: torch.Tensor  # int[B]: valid prefix per row


class STULayer(nn.Module):
    """One HSTU block over padded-dense [B, N, D]."""

    def __init__(self, config: STULayerConfig, gen: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.config = cfg = config
        D, H = cfg.embedding_dim, cfg.num_heads
        h, a = cfg.hidden_dim, cfg.attention_dim
        self.uvqk_weight = new_param((D, (2 * h + 2 * a) * H), xavier_uniform, gen)
        self.uvqk_beta = new_param(((2 * h + 2 * a) * H,), zeros, gen)
        self.input_norm_weight = new_param((D,), ones, gen)
        self.input_norm_bias = new_param((D,), zeros, gen)
        self.output_weight = new_param((h * H * 3, D), xavier_uniform, gen)
        norm_shape = H if cfg.use_group_norm else h * H
        self.output_norm_weight = new_param((norm_shape,), ones, gen)
        self.output_norm_bias = new_param((norm_shape,), zeros, gen)

    def _uqvk(self, x: torch.Tensor):
        cfg = self.config
        return hstu_compute_uqvk(
            x, self.input_norm_weight, self.input_norm_bias,
            self.uvqk_weight, self.uvqk_beta,
            num_heads=cfg.num_heads, attn_dim=cfg.attention_dim,
            hidden_dim=cfg.hidden_dim,
        )

    def _output(
        self, attn: torch.Tensor, u: torch.Tensor, x: torch.Tensor,
        deterministic: bool = True, gen: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        cfg = self.config
        return hstu_compute_output(
            attn, u, x, self.output_norm_weight, self.output_norm_bias,
            self.output_weight, num_heads=cfg.num_heads,
            linear_dim=cfg.hidden_dim, group_norm=cfg.use_group_norm,
            dropout_ratio=cfg.output_dropout_ratio, dropout_gen=gen,
            training=not deterministic,
        )

    def _forward(self, x, lengths, num_targets, deterministic=True, gen=None):
        cfg = self.config
        B, N, _ = x.shape
        u, q, k, v = self._uqvk(x)
        attn = hstu_mha_dense_cuda(
            q, k, v, lengths, alpha=cfg.alpha,
            max_seq_len=cfg.norm_seq_len or N, causal=cfg.causal,
            num_targets=num_targets if cfg.target_aware else None,
            max_attn_len=cfg.max_attn_len,
            contextual_seq_len=cfg.contextual_seq_len,
        ).reshape(B, N, cfg.num_heads * cfg.hidden_dim)
        return self._output(attn, u, x, deterministic, gen), k, v

    def forward(
        self,
        x: torch.Tensor,  # [B, N, D]
        lengths: torch.Tensor,  # int[B]
        num_targets: Optional[torch.Tensor] = None,  # int[B]
        deterministic: bool = True,
        gen: Optional[torch.Generator] = None,  # the dropout's, when not deterministic
    ) -> torch.Tensor:
        return self._forward(x, lengths, num_targets, deterministic, gen)[0]

    def prefill(
        self,
        x: torch.Tensor,  # [B, N, D]
        lengths: torch.Tensor,  # int[B]
        kv_caching_lengths: torch.Tensor,  # int[B]
        num_targets: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, KVCache]:
        """Full forward that also returns the cache of the first
        ``kv_caching_lengths[b]`` positions (zero after)."""
        out, k, v = self._forward(x, lengths, num_targets)
        keep = (
            torch.arange(x.shape[1], device=x.device)[None, :] < kv_caching_lengths[:, None]
        )[:, :, None, None].to(k.dtype)
        return out, KVCache(k=k * keep, v=v * keep, lengths=kv_caching_lengths.to(torch.int32))

    def cached_forward(
        self,
        delta_x: torch.Tensor,  # [B, M, D]: the M newest tokens per row
        cache: KVCache,
        num_targets: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, KVCache]:
        """M-FALCON incremental path: delta uqvk, append to the cache K/V at
        ``cache.lengths + arange(M)``, delta attention, output. Returns
        (delta_out [B, M, D], the extended cache)."""
        cfg = self.config
        B, M, _ = delta_x.shape
        delta_u, delta_q, delta_k, delta_v = self._uqvk(delta_x)
        Nc = cache.k.shape[1]
        full_k = F.pad(cache.k, (0, 0, 0, 0, 0, M))
        full_v = F.pad(cache.v, (0, 0, 0, 0, 0, M))
        rows = torch.arange(B, device=delta_x.device)[:, None]
        cols = cache.lengths.long()[:, None] + torch.arange(M, device=delta_x.device)[None, :]
        full_k[rows, cols] = delta_k.to(full_k.dtype)
        full_v[rows, cols] = delta_v.to(full_v.dtype)
        full_lengths = cache.lengths + M
        delta_attn = delta_hstu_mha_cuda(
            delta_q, full_k, full_v, full_lengths, alpha=cfg.alpha,
            num_targets=num_targets if cfg.target_aware else None,
            max_attn_len=cfg.max_attn_len,
            contextual_seq_len=cfg.contextual_seq_len,
            # must match the prefill forward's normaliser
            norm_len=cfg.norm_seq_len or Nc,
        ).reshape(B, M, cfg.num_heads * cfg.hidden_dim)
        out = self._output(delta_attn, delta_u, delta_x)
        return out, KVCache(k=full_k, v=full_v, lengths=full_lengths)


class STUStack(nn.Module):
    def __init__(
        self, configs: Tuple[STULayerConfig, ...], gen: Optional[torch.Generator] = None
    ) -> None:
        super().__init__()
        self.layers: List[STULayer] = []
        for i, cfg in enumerate(configs):
            layer = STULayer(cfg, gen)
            self.add_module(f"layer_{i}", layer)  # the JAX parameter names
            self.layers.append(layer)

    def forward(
        self,
        x: torch.Tensor,
        lengths: torch.Tensor,
        num_targets: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        gen: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, lengths, num_targets, deterministic, gen)
        return x

    def prefill(
        self,
        x: torch.Tensor,
        lengths: torch.Tensor,
        kv_caching_lengths: torch.Tensor,
        num_targets: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, List[KVCache]]:
        caches: List[KVCache] = []
        for layer in self.layers:
            x, cache = layer.prefill(x, lengths, kv_caching_lengths, num_targets)
            caches.append(cache)
        return x, caches

    def cached_forward(
        self,
        delta_x: torch.Tensor,
        caches: List[KVCache],
        num_targets: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, List[KVCache]]:
        new_caches: List[KVCache] = []
        for layer, cache in zip(self.layers, caches):
            delta_x, new_cache = layer.cached_forward(delta_x, cache, num_targets)
            new_caches.append(new_cache)
        return delta_x, new_caches
