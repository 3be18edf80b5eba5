"""STU, the production HSTU layer, with its KV cache and the M-FALCON delta
path (port of `generative_recommenders_tpu/modules/stu.py`).

Layout is padded-dense [B, N, D] plus lengths; the attention kernels handle
the jaggedness. The KV cache is an explicit `KVCache` value passed through
calls. ``deterministic=False`` turns on the output dropout, drawn from the
``torch.Generator`` passed with it. `sort_by_length` (a Triton load balancer)
has no counterpart.

The recompute policy. The JAX package tags four values of a layer
(``stu_normed_x``, ``stu_uvqk``, ``stu_y`` and the attention output
``stu_attn``) and, when any of ``recompute_normed_x``, ``recompute_uvqk``
and ``recompute_y`` is set (all three are by default), trains each layer
under ``nn.remat`` saving only ``stu_attn`` and the tagged values whose flag
is off. The attention kernel K1 is a ``ctypes`` launch, which no
``torch.utils.checkpoint`` policy can save, so here a layer in training is
one `torch.autograd.Function` (`_RecomputedLayer`): its forward keeps the
layer's input, the attention output and the unflagged values; its backward
recomputes the rest from them (the dropout generator replayed) and runs the
attention's backward kernels itself, so K1 runs once per layer and step
either way. The numbers equal those without recompute (bit for bit on the
CPU); only what lives between the forward and the backward changes. All
three flags off is the plain autograd graph.

`STUStack` wraps layers as the JAX package does (`modules/dynamic_stu.py`):
every layer in `SDSTU` when ``stochastic_depth_ratio > 0``, the upper half in
`L2STU` when ``l2_max_len > 0``. The layers keep their names ``layer_i``
(flax binds a layer created in the stack's ``setup`` to the stack, so the
JAX parameter paths are the same with and without wrappers).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from generative_recommenders_tpu_torch.modules.dynamic_stu import L2STU, SDSTU
from generative_recommenders_tpu_torch.modules.mlp import (
    new_param,
    ones,
    xavier_uniform,
    zeros,
)
from generative_recommenders_tpu_torch.ops.cuda.hstu_attention import (
    delta_hstu_mha_cuda,
    hstu_mha_bwd_cuda,
    hstu_mha_dense_cuda,
)
from generative_recommenders_tpu_torch.ops.hstu_compute import (
    hstu_compute_uqvk,
    norm_mul_dropout,
    output_projection,
    split_uvqk,
    uvqk_projection,
)
from generative_recommenders_tpu_torch.ops.normalization import layer_norm


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
    # what the backward recomputes instead of keeping (module docstring)
    recompute_normed_x: bool = True
    recompute_uvqk: bool = True
    recompute_y: bool = True
    contextual_seq_len: int = 0
    # fixed silu normaliser; 0 => the padded length of each call. M-FALCON
    # serving sets it so the prefill and delta passes normalise alike.
    norm_seq_len: int = 0

    @property
    def alpha(self) -> float:
        return self.attn_alpha or 1.0 / (self.attention_dim**0.5)

    @property
    def recompute(self) -> bool:
        return self.recompute_normed_x or self.recompute_uvqk or self.recompute_y


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
        """x + norm_mul_dropout(attn, u) @ W_o."""
        y = self._norm_mul_dropout(attn, u, self.output_norm_weight, self.output_norm_bias, deterministic, gen)
        return output_projection(y, x, self.output_weight)

    def _norm_mul_dropout(self, attn, u, norm_weight, norm_bias, deterministic: bool, gen) -> torch.Tensor:
        cfg = self.config
        return norm_mul_dropout(
            attn, u, norm_weight, norm_bias, eps=1e-6,
            group_norm=cfg.use_group_norm, num_heads=cfg.num_heads, linear_dim=cfg.hidden_dim,
            dropout_ratio=cfg.output_dropout_ratio, dropout_gen=gen, training=not deterministic,
        )

    def _attention(self, q, k, v, lengths, num_targets):
        """K1 (or its plain version) over [B, N, H, d]; [B, N, H * hidden]."""
        cfg = self.config
        B, N = q.shape[:2]
        return hstu_mha_dense_cuda(
            q, k, v, lengths, **self._attn_kw(N, num_targets)
        ).reshape(B, N, cfg.num_heads * cfg.hidden_dim)

    def _attn_kw(self, N: int, num_targets) -> dict:
        cfg = self.config
        return dict(
            alpha=cfg.alpha, max_seq_len=cfg.norm_seq_len or N, causal=cfg.causal,
            num_targets=num_targets if cfg.target_aware else None,
            max_attn_len=cfg.max_attn_len, contextual_seq_len=cfg.contextual_seq_len,
        )

    def _forward(self, x, lengths, num_targets, deterministic=True, gen=None):
        u, q, k, v = self._uqvk(x)
        attn = self._attention(q, k, v, lengths, num_targets)
        return self._output(attn, u, x, deterministic, gen), k, v

    def forward(
        self,
        x: torch.Tensor,  # [B, N, D]
        lengths: torch.Tensor,  # int[B]
        num_targets: Optional[torch.Tensor] = None,  # int[B]
        deterministic: bool = True,
        gen: Optional[torch.Generator] = None,  # the dropout's, when not deterministic
        sd_gen: Optional[torch.Generator] = None,  # the wrappers' coins; a bare layer draws none
    ) -> torch.Tensor:
        if self.config.recompute and torch.is_grad_enabled():
            params = [getattr(self, n) for n in _PARAM_NAMES]
            if x.requires_grad or any(p.requires_grad for p in params):
                return _RecomputedLayer.apply(self, x, lengths, num_targets, deterministic, gen, *params)
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


_PARAM_NAMES = (
    "uvqk_weight", "uvqk_beta", "input_norm_weight", "input_norm_bias",
    "output_weight", "output_norm_weight", "output_norm_bias",
)


def _leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().requires_grad_(True)


class _RecomputedLayer(torch.autograd.Function):
    """One STU layer whose backward recomputes what the flags name (module
    docstring). The forward keeps x, the attention output and the values
    whose flag is off; the backward rebuilds the rest from them, takes the
    attention's gradient with `hstu_mha_bwd_cuda` (K2, or K3 + K4 under
    deterministic algorithms; the plain backward on the CPU) and the two
    projections' gradients as products, and never runs the attention's
    forward again. The output dropout draws the forward's masks again: the
    generator is set to its state at the forward and put back after."""

    @staticmethod
    def forward(ctx, layer, x, lengths, num_targets, deterministic, gen, *params):
        cfg = layer.config
        p = dict(zip(_PARAM_NAMES, params))
        normed = layer_norm(x, weight=p["input_norm_weight"], bias=p["input_norm_bias"], eps=1e-6)
        uvqk = uvqk_projection(normed, p["uvqk_weight"], p["uvqk_beta"], x.dtype)
        u, q, k, v = split_uvqk(uvqk, num_heads=cfg.num_heads, attn_dim=cfg.attention_dim,
                                hidden_dim=cfg.hidden_dim)
        attn = layer._attention(q, k, v, lengths, num_targets)
        drops = not deterministic and cfg.output_dropout_ratio > 0.0 and gen is not None
        ctx.gen, ctx.gen_state = (gen, gen.get_state()) if drops else (None, None)
        y = layer._norm_mul_dropout(attn, u, p["output_norm_weight"], p["output_norm_bias"], deterministic, gen)
        kept = [t for t, flag in ((normed, cfg.recompute_normed_x), (uvqk, cfg.recompute_uvqk),
                                  (y, cfg.recompute_y)) if not flag]
        ctx.layer, ctx.deterministic = layer, deterministic
        ctx.has_nt = num_targets is not None
        ctx.save_for_backward(x, attn, lengths, *([num_targets] if ctx.has_nt else []), *kept, *params)
        return output_projection(y, x, p["output_weight"])

    @staticmethod
    def backward(ctx, g):
        layer, cfg = ctx.layer, ctx.layer.config
        saved = list(ctx.saved_tensors)
        x, attn, lengths = saved[:3]
        rest = saved[3:]
        num_targets = rest.pop(0) if ctx.has_nt else None
        kept = {
            name: rest.pop(0) for name, flag in (("normed", cfg.recompute_normed_x),
                                                 ("uvqk", cfg.recompute_uvqk), ("y", cfg.recompute_y))
            if not flag
        }
        params = dict(zip(_PARAM_NAMES, rest))
        B, N, _ = x.shape
        with torch.enable_grad():
            x_ = _leaf(x)
            p = {n: _leaf(t) for n, t in params.items()}
            # the input norm, recomputed for its own backward
            normed = layer_norm(x_, weight=p["input_norm_weight"], bias=p["input_norm_bias"], eps=1e-6)
            normed_v = kept.get("normed", normed.detach())
            uvqk_v = kept.get("uvqk")
            if uvqk_v is None:
                uvqk_v = uvqk_projection(normed_v, params["uvqk_weight"], params["uvqk_beta"], x.dtype)
            uvqk = _leaf(uvqk_v)
            attn_ = _leaf(attn)
            u, q, k, v = split_uvqk(uvqk, num_heads=cfg.num_heads, attn_dim=cfg.attention_dim,
                                    hidden_dim=cfg.hidden_dim)
            gen = ctx.gen
            found = None
            if gen is not None:
                found = gen.get_state()
                gen.set_state(ctx.gen_state)
            try:
                y = layer._norm_mul_dropout(attn_, u, p["output_norm_weight"], p["output_norm_bias"],
                                            ctx.deterministic, gen)
            finally:
                if gen is not None:
                    gen.set_state(found)
            y_v = kept.get("y", y.detach())
            # out = x + y @ W_o
            w_o = params["output_weight"].to(y_v.dtype)
            g_y = g.reshape(B * N, -1).to(y_v.dtype)
            dy = g_y.mm(w_o.t()).reshape(y_v.shape)
            d_out_w = y_v.reshape(B * N, -1).t().mm(g_y).to(w_o.dtype)
            d_attn, d_uvqk_u, d_on_w, d_on_b = torch.autograd.grad(
                y, [attn_, uvqk, p["output_norm_weight"], p["output_norm_bias"]], dy
            )
            dq, dk, dv = hstu_mha_bwd_cuda(
                q.detach(), k.detach(), v.detach(), lengths,
                d_attn.reshape(B, N, cfg.num_heads, cfg.hidden_dim),
                split=torch.are_deterministic_algorithms_enabled(), **layer._attn_kw(N, num_targets),
            )
            (d_uvqk_qkv,) = torch.autograd.grad([q, k, v], [uvqk], [dq, dk, dv])
            d_uvqk = d_uvqk_u + d_uvqk_qkv
            # uvqk = normed @ W + b, in float32
            g_p = d_uvqk.reshape(B * N, -1).float()
            d_normed = g_p.mm(params["uvqk_weight"].float().t()).reshape(normed_v.shape)
            d_uvqk_w = normed_v.reshape(B * N, -1).float().t().mm(g_p)
            d_uvqk_b = g_p.sum(0)
            dx, d_in_w, d_in_b = torch.autograd.grad(
                normed, [x_, p["input_norm_weight"], p["input_norm_bias"]], d_normed.to(normed.dtype)
            )
        grads = dict(
            uvqk_weight=d_uvqk_w, uvqk_beta=d_uvqk_b, input_norm_weight=d_in_w,
            input_norm_bias=d_in_b, output_weight=d_out_w, output_norm_weight=d_on_w,
            output_norm_bias=d_on_b,
        )
        return (None, g + dx, None, None, None, None,
                *(grads[n].to(params[n].dtype) for n in _PARAM_NAMES))


class STUStack(nn.Module):
    def __init__(
        self,
        configs: Tuple[STULayerConfig, ...],
        gen: Optional[torch.Generator] = None,
        stochastic_depth_ratio: float = 0.0,
        l2_max_len: int = 0,
    ) -> None:
        super().__init__()
        self.layers: List[STULayer] = []
        self.blocks: List[nn.Module] = []  # the layers as wrapped (not registered twice)
        n = len(configs)
        for i, cfg in enumerate(configs):
            is_l2 = l2_max_len > 0 and i >= n // 2
            # the window leaves the contextual prefix out, so the inner layer
            # must not mask it again
            layer = STULayer(dataclasses.replace(cfg, contextual_seq_len=0) if is_l2 else cfg, gen)
            self.add_module(f"layer_{i}", layer)  # the JAX parameter names
            self.layers.append(layer)
            block: nn.Module = layer
            if stochastic_depth_ratio > 0.0:
                block = SDSTU(block, stochastic_depth_ratio)
            if is_l2:
                block = L2STU(block, l2_max_len, cfg.contextual_seq_len)
            self.blocks.append(block)
        self.dynamic = stochastic_depth_ratio > 0.0 or l2_max_len > 0

    def forward(
        self,
        x: torch.Tensor,
        lengths: torch.Tensor,
        num_targets: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        gen: Optional[torch.Generator] = None,
        sd_gen: Optional[torch.Generator] = None,  # stochastic depth's coins
    ) -> torch.Tensor:
        for block in self.blocks:
            x = block(x, lengths, num_targets, deterministic, gen, sd_gen)
        return x

    def _check_static(self) -> None:
        if self.dynamic:
            raise ValueError("the dynamic STU wrappers do not support the KV-cache prefill and cached paths")

    def prefill(
        self,
        x: torch.Tensor,
        lengths: torch.Tensor,
        kv_caching_lengths: torch.Tensor,
        num_targets: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, List[KVCache]]:
        self._check_static()
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
        self._check_static()
        new_caches: List[KVCache] = []
        for layer, cache in zip(self.layers, caches):
            delta_x, new_cache = layer.cached_forward(delta_x, cache, num_targets)
            new_caches.append(new_cache)
        return delta_x, new_caches
