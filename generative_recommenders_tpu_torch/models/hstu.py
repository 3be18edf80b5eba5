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
* relative bias enabled and no timestamps: the position-only bias of the
  JAX package's `RelativePositionalBias` (``w[j - i + Nm - 1]``, the same
  Toeplitz index as ``pos_w``), on the same pair K6 / K7 given zero
  timestamps and a one-entry zero time table (``num_buckets = 0``, so every
  bucket is 0); the time table's gradient is dropped. The JAX tree names
  that table ``rel_attn_bias/w`` (`convert.py` maps it to ``pos_w``);
* relative bias disabled: the dense pair K1 / K2 (`ops/cuda/hstu_attention.py`),
  causal, with ``lengths``.

Attention dropout (``attn_dropout_ratio > 0``) in a training forward takes
the plain composite on either device: the bias materialised as [B, N, N]
(`relative_bias_plain`), silu, the mask, then each weight kept with
probability 1 - p from the trainer's generator and scaled by 1 / (1 - p)
(`ops/cuda/hstu_attention.py:hstu_mha_dense`). That is the JAX package's own
choice: its Pallas kernels have no dropout, so its model serves attention
dropout on the XLA path only. No kernel runs in such a step; its eval
(no dropout) runs K6 or K1 as above.

Both mask by length and give zeros at rows >= length, as the JAX package's
Pallas path does (its XLA path masks causally only and leaves other values
in those rows; nothing downstream reads them).

The KV-cached encode (``return_caches`` / ``caches``) keeps each layer's k
and v; its delta step (`SequentialTransductionUnit._delta_attend`) attends M
appended queries over the extended cache in plain PyTorch, with the bias
rows gathered for those queries only, as the JAX package's XLA einsums do
(no Pallas kernel serves it there). What depends only on the cache lengths
and the timestamps (the write positions, the delta mask, the bias indices)
is built once per step, with every layer's bias rows in one gather
(`HSTUEncoder._delta_plans`), not in each layer.

Types, as flax promotes them: a block computes LN(x) @ W_uvqk in float32 and
casts the product to x's type, so a bfloat16 input gives bfloat16 u, q, k
and v and the relative-bias kernels run in bfloat16; its output projection
``o`` holds float32 weights, so the block's output, and with it every later
block, is float32. Under ``compute_dtype="bfloat16"`` only the first block
runs in bfloat16, as in the JAX package.

``remat`` recomputes each block in the backward
(`torch.utils.checkpoint`, non-reentrant) instead of keeping its
activations, as the JAX package's ``nn.remat`` per block does, and only
where that does (no KV caches in or out). The dropout masks come from an
explicit generator, which a checkpoint does not restore: the block's
recomputation replays the generator's state from the forward, and leaves the
generator where it found it.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from generative_recommenders_tpu_torch.modules.mlp import (
    Dense,
    new_param,
    normal,
    uniform,
    xavier_uniform,
)
from generative_recommenders_tpu_torch.ops.attention_mask import (
    apply_padding_guard,
    make_delta_attn_mask,
    make_valid_attn_mask,
)
from generative_recommenders_tpu_torch.ops.cuda.hstu_attention import hstu_mha_dense, hstu_mha_dense_cuda
from generative_recommenders_tpu_torch.ops.cuda.hstu_attention_relbias import (
    hstu_mha_dense_relbias_cuda,
    relative_bias_indices,
    relative_bias_plain,
)
from generative_recommenders_tpu_torch.ops.hstu_compute import dropout
from generative_recommenders_tpu_torch.ops.normalization import layer_norm


class RelativeBucketedTimeAndPositionBasedBias(nn.Module):
    """The two tables of the relative position + bucketed time-span bias:
    ``pos_w`` [2 * max_seq_len - 1] and ``ts_w`` [num_buckets + 1]. The full
    attention rebuilds the bias inside the kernel (or its plain version) from
    the tables; `forward` gives the bias rows of chosen queries (the JAX
    module's row branch), and the KV-cached delta step gathers every layer's
    rows at once from the same indices (`HSTUEncoder._delta_plans`)."""

    def __init__(
        self, max_seq_len: int, num_buckets: int = 128, gen: Optional[torch.Generator] = None
    ) -> None:
        super().__init__()
        self.num_buckets = num_buckets
        self.ts_w = new_param((num_buckets + 1,), normal(0.02), gen)
        self.pos_w = new_param((2 * max_seq_len - 1,), normal(0.02), gen)

    def forward(
        self,
        all_timestamps: torch.Tensor,  # [B, N], full length
        row_idx: torch.Tensor,  # int[B, M]: the query rows' absolute positions
    ) -> torch.Tensor:
        """The bias rows [B, M, N] of the queries at ``row_idx``:
        pos_w[j - i + Nm - 1] + ts_w[bucket(ts[min(i + 1, N - 1)] - ts[j])],
        with the kernels' bucket form, so the delta path and a full encode
        read the same buckets."""
        return relative_bias_plain(all_timestamps, self.pos_w, self.ts_w, self.num_buckets, row_idx)

    @property
    def table_len(self) -> int:  # Nm
        return (self.pos_w.shape[0] + 1) // 2


class DeltaPlan(NamedTuple):
    """One layer's share of a KV-cached delta step, built for all layers at
    once by `HSTUEncoder._delta_plans` from the cache lengths, the
    timestamps and the bias tables."""

    width: int  # Nfull = Nc + M, the extended caches' width
    write_idx: torch.Tensor  # int[B * M]: the delta rows' places in the caches viewed [B * Nfull, H, d]
    scaled_mask: torch.Tensor  # float32[B, 1, M, Nfull]: the delta rows of the causal mask, / Nfull
    bias: Optional[torch.Tensor]  # float32[B, 1, M, Nfull]: this layer's bias rows; None without timestamps


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
        if linear_activation not in ("silu", "none"):
            raise ValueError(f"Unknown linear_activation {linear_activation}")
        self.linear_dim, self.attention_dim, self.num_heads = linear_dim, attention_dim, num_heads
        self.dropout_ratio = dropout_ratio
        self.attn_dropout_ratio = attn_dropout_ratio
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
        x: torch.Tensor,  # [B, N, D]; with delta_cache [B, M, D], the M newest tokens
        lengths: torch.Tensor,  # int[B]
        all_timestamps: Optional[torch.Tensor],  # int[B, N], full length
        deterministic: bool = False,
        gen: Optional[torch.Generator] = None,  # the dropout masks' generator
        delta_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # k, v [B, Nc, H, d]
        delta_plan: Optional[DeltaPlan] = None,  # with delta_cache
        return_cache: bool = False,
    ):
        """The block's output; with ``return_cache`` also this layer's (k, v)
        [B, N, H, d]. With ``delta_cache`` only the M newest tokens are
        computed, against the cache extended by them (`_delta_attend`), and
        the extended cache comes back with the output."""
        B, N, _ = x.shape
        H, dqk, dv = self.num_heads, self.attention_dim, self.linear_dim
        # float32 product, cast to x's type: bfloat16 u, q, k, v for a bfloat16 x
        mixed = (layer_norm(x, eps=self.epsilon).float() @ self.uvqk).to(x.dtype)
        if self.linear_activation == "silu":
            mixed = F.silu(mixed)
        u, v, q, k = torch.split(mixed, [dv * H, dv * H, dqk * H, dqk * H], dim=-1)
        # q, k and v stay views of the projection; the kernels read them strided
        q, k, v = q.reshape(B, N, H, dqk), k.reshape(B, N, H, dqk), v.reshape(B, N, H, dv)
        if delta_cache is not None:
            return self._delta_attend(x, u, q, k, v, delta_cache, delta_plan, deterministic, gen)
        attn_dropout = not deterministic and self.attn_dropout_ratio > 0.0
        if self.rel_attn_bias is None:
            if attn_dropout:
                attn = self._plain_attention(q, k, v, lengths, None, gen)
            else:
                attn = hstu_mha_dense_cuda(q, k, v, lengths, alpha=1.0, max_seq_len=N, causal=True)
        else:
            rel = self.rel_attn_bias
            pos_w, ts_w, num_buckets = rel.pos_w, rel.ts_w, rel.num_buckets
            if all_timestamps is None:  # the position-only bias
                all_timestamps = torch.zeros((B, N), dtype=torch.int32, device=x.device)
                ts_w, num_buckets = pos_w.new_zeros(1), 0
            if attn_dropout:
                bias = relative_bias_plain(all_timestamps, pos_w, ts_w, num_buckets)
                attn = self._plain_attention(q, k, v, lengths, bias, gen)
            else:
                attn = hstu_mha_dense_relbias_cuda(
                    q, k, v, lengths, all_timestamps, pos_w, ts_w, alpha=1.0, max_seq_len=N,
                    num_buckets=num_buckets, causal=True,
                )
        out = self._finish(attn.reshape(B, N, H * dv), u, x, deterministic, gen)
        return (out, (k, v)) if return_cache else out

    def _plain_attention(self, q, k, v, lengths, bias, gen) -> torch.Tensor:
        """Causal attention with ``bias`` and attention dropout, in plain
        PyTorch (rows >= length come out 0)."""
        N = q.shape[1]
        mask = apply_padding_guard(make_valid_attn_mask(N, lengths, causal=True), lengths)
        return hstu_mha_dense(
            q, k, v, alpha=1.0, max_seq_len=N, mask=mask, bias=bias,
            dropout_pr=self.attn_dropout_ratio, dropout_gen=gen,
        )

    def _finish(
        self,
        attn: torch.Tensor,  # [B, N, H * dv]
        u: torch.Tensor,
        x: torch.Tensor,  # the residual
        deterministic: bool,
        gen: Optional[torch.Generator],
    ) -> torch.Tensor:
        a = layer_norm(attn, eps=self.epsilon)
        o_input = torch.cat([u, a, u * a], dim=-1) if self.concat_ua else u * a
        if not deterministic:
            o_input = dropout(o_input, self.dropout_ratio, gen)
        # the float32 projection promotes a bfloat16 block's output to float32
        return self.o(o_input) + x

    def _delta_attend(
        self,
        delta_x: torch.Tensor,  # [B, M, D]
        u: torch.Tensor,  # [B, M, H * dv]
        q: torch.Tensor,  # [B, M, H, dqk]
        delta_k: torch.Tensor,  # [B, M, H, dqk]
        delta_v: torch.Tensor,  # [B, M, H, dv]
        cache: Tuple[torch.Tensor, torch.Tensor],  # k, v [B, Nc, H, d]
        plan: DeltaPlan,
        deterministic: bool,
        gen: Optional[torch.Generator],
    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Extends the cache by M zero columns, writes the delta rows' k and
        v at positions cache_lengths .. cache_lengths + M - 1, attends the
        delta queries over the whole width Nfull = Nc + M (silu / Nfull, the
        bias rows of the delta queries, the delta rows of the causal mask)
        and finishes the block. Plain PyTorch: M rows need no attention
        kernel. The write positions, mask and bias rows come from ``plan``."""
        B, M, _ = delta_x.shape
        H, dv = self.num_heads, self.linear_dim
        full_k, full_v = (c.new_zeros((B, plan.width) + tuple(c.shape[2:])) for c in cache)
        full_k[:, : cache[0].shape[1]] = cache[0]
        full_v[:, : cache[1].shape[1]] = cache[1]
        full_k.view(B * plan.width, H, -1).index_copy_(0, plan.write_idx, delta_k.reshape(B * M, H, -1))
        full_v.view(B * plan.width, H, -1).index_copy_(0, plan.write_idx, delta_v.reshape(B * M, H, -1))
        s = torch.einsum("bmhd,bnhd->bhmn", q.float(), full_k.float())
        if self.rel_attn_bias is not None:
            if plan.bias is None:
                raise ValueError("the delta step with the relative bias needs the full timestamps")
            s = s + plan.bias
        p = F.silu(s) * plan.scaled_mask
        attn = torch.einsum("bhmn,bnhv->bmhv", p.to(full_v.dtype).float(), full_v.float())
        attn = attn.reshape(B, M, H * dv).to(delta_x.dtype)
        return self._finish(attn, u, delta_x, deterministic, gen), (full_k, full_v)


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
        remat: bool = False,
        gen: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.num_blocks = num_blocks
        self.remat = remat
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
        caches: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None,
        cache_lengths: Optional[torch.Tensor] = None,
        return_caches: bool = False,
    ):
        """The encoded [B, N, D]; with ``return_caches`` also each layer's
        (k, v); with ``caches`` the KV-cached delta step over the M newest
        tokens, which returns the extended caches."""
        x = user_embeddings
        new_caches: List[Tuple[torch.Tensor, torch.Tensor]] = []
        plans: List[DeltaPlan] = []
        if caches is not None:
            plans = self._delta_plans(cache_lengths, x.shape[1], caches[0][0].shape[1], all_timestamps)
        for i in range(self.num_blocks):
            block = getattr(self, f"layer_{i}")
            if caches is not None:
                x, cache = block(
                    x, lengths, all_timestamps, deterministic, gen,
                    delta_cache=caches[i], delta_plan=plans[i],
                )
                new_caches.append(cache)
            elif return_caches:
                x, cache = block(x, lengths, all_timestamps, deterministic, gen, return_cache=True)
                new_caches.append(cache)
            elif self.remat and torch.is_grad_enabled():
                x = _recomputed(block, x, lengths, all_timestamps, deterministic, gen)
            else:
                x = block(x, lengths, all_timestamps, deterministic, gen)
        if caches is not None or return_caches:
            return x, new_caches
        return x

    def _delta_plans(
        self,
        cache_lengths: torch.Tensor,  # int[B]
        M: int,
        Nc: int,  # the caches' width
        all_timestamps: Optional[torch.Tensor],  # [B, Nc + M]
    ) -> List[DeltaPlan]:
        """Each layer's `DeltaPlan`. The write positions, the mask and the
        bias indices depend only on the cache lengths and the timestamps, so
        they are built once; the bias rows of every layer come from one
        gather over the stacked tables."""
        B, Nfull = cache_lengths.shape[0], Nc + M
        cols = cache_lengths.long()[:, None] + torch.arange(M, device=cache_lengths.device)[None, :]
        rows = torch.arange(B, device=cache_lengths.device)[:, None] * Nfull
        write_idx = (rows + cols).reshape(-1)
        mask = make_delta_attn_mask(Nfull, cache_lengths + M, cols, causal=True)
        scaled_mask = (mask.to(torch.float32) / Nfull)[:, None]
        tables = [getattr(self, f"layer_{i}").rel_attn_bias for i in range(self.num_blocks)]
        if tables[0] is None or all_timestamps is None:
            return [DeltaPlan(Nfull, write_idx, scaled_mask, None)] * self.num_blocks
        rel, bucket = relative_bias_indices(
            all_timestamps, tables[0].table_len, tables[0].num_buckets, cols
        )
        bias = (
            torch.stack([t.pos_w for t in tables])[:, rel]
            + torch.stack([t.ts_w for t in tables])[:, bucket]
        )  # [L, B, M, Nfull]
        return [DeltaPlan(Nfull, write_idx, scaled_mask, b[:, None]) for b in bias]


def _recomputed(
    block: SequentialTransductionUnit,
    x: torch.Tensor,
    lengths: torch.Tensor,
    all_timestamps: Optional[torch.Tensor],
    deterministic: bool,
    gen: Optional[torch.Generator],
) -> torch.Tensor:
    """``block(x, ...)`` under a non-reentrant checkpoint. The recomputation
    draws the forward's dropout masks again: it sets ``gen`` to its state at
    the forward's start and restores the state it found afterwards (the
    checkpoint restores only the global generators, and the blocks draw
    from none of them)."""
    state = None if gen is None else gen.get_state()
    calls = [0]

    def run(inp: torch.Tensor) -> torch.Tensor:
        calls[0] += 1
        if state is None or calls[0] == 1:
            return block(inp, lengths, all_timestamps, deterministic, gen)
        found = gen.get_state()
        gen.set_state(state)
        try:
            return block(inp, lengths, all_timestamps, deterministic, gen)
        finally:
            gen.set_state(found)

    return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)
