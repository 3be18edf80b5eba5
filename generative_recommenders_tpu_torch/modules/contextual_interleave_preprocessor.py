"""Contextual-interleave input preprocessor (port of
`generative_recommenders_tpu/modules/contextual_interleave_preprocessor.py`),
padded-dense.

Content and action encoders run through (optionally parameterized)
contextualized MLPs; with ``enable_interleaving`` the two streams are
interleaved as [c0, a0, c1, a1, ...] instead of summed. In training the
targets are interleaved too (`interleave_targets`); at inference a target
position keeps only its content token. The reference compacts that with a
jagged mask; here it is one gather whose indices depend only on the lengths:
output slot q of row b reads

    q < 2 uih_len[b]   -> (content | action)[q // 2], by the parity of q
    q >= 2 uih_len[b]  -> content[uih_len[b] + (q - 2 uih_len[b])]

Contextual features become C prefix tokens through a [C, Din, Dout] batch of
linear maps, as in `modules/preprocessors.py`. The parameterized MLPs' input
is the flattened contextual features, with dropout in training drawn from
the trainer's generator. `DlrmHSTU` does not wire this module, in either
package.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from generative_recommenders_tpu_torch.modules.action_encoder import ActionEncoder, ContentEncoder
from generative_recommenders_tpu_torch.modules.contextualize_mlps import (
    ParameterizedContextualizedMLP,
    SimpleContextualizedMLP,
)
from generative_recommenders_tpu_torch.modules.mlp import new_param, normal, zeros
from generative_recommenders_tpu_torch.modules.preprocessors import PreprocessorOutput
from generative_recommenders_tpu_torch.ops.hstu_compute import dropout
from generative_recommenders_tpu_torch.ops.padded import prepend_prefix


class ContextualInterleavePreprocessor(nn.Module):
    def __init__(
        self,
        input_embedding_dim: int,
        output_embedding_dim: int,
        contextual_feature_to_max_length: Tuple[Tuple[str, int], ...],
        contextual_feature_to_min_uih_length: Tuple[Tuple[str, int], ...],
        content_encoder: ContentEncoder,
        action_encoder: ActionEncoder,
        use_parameterized_mlps: bool = False,
        mlp_hidden_dim: int = 256,
        pmlp_contextual_dropout_ratio: float = 0.0,
        enable_interleaving: bool = True,
        gen: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.input_embedding_dim = input_embedding_dim
        self.contextual_feature_to_max_length = contextual_feature_to_max_length
        self.min_uih_lengths = dict(contextual_feature_to_min_uih_length)
        self.content_encoder = content_encoder
        self.action_encoder = action_encoder
        self.use_parameterized_mlps = use_parameterized_mlps
        self.pmlp_contextual_dropout_ratio = pmlp_contextual_dropout_ratio
        self.enable_interleaving = enable_interleaving
        C = self.max_contextual_seq_len
        dims = (content_encoder.output_embedding_dim, action_encoder.output_embedding_dim)
        if use_parameterized_mlps:
            self.content_mlp, self.action_mlp = (
                ParameterizedContextualizedMLP(C * input_embedding_dim, d, output_embedding_dim, mlp_hidden_dim, gen)
                for d in dims
            )
        else:
            self.content_mlp, self.action_mlp = (
                SimpleContextualizedMLP(d, output_embedding_dim, mlp_hidden_dim, gen) for d in dims
            )
        if C > 0:
            std = math.sqrt(2.0 / (input_embedding_dim + output_embedding_dim))
            self.batched_contextual_linear_weights = new_param(
                (C, input_embedding_dim, output_embedding_dim), normal(std), gen
            )
            self.batched_contextual_linear_bias = new_param((C, output_embedding_dim), zeros, gen)

    @property
    def max_contextual_seq_len(self) -> int:
        return sum(n for _, n in self.contextual_feature_to_max_length)

    def interleave_targets(self, deterministic: bool) -> bool:
        """Targets are interleaved in training only."""
        return self.enable_interleaving and not deterministic

    def forward(
        self,
        seq_embeddings: torch.Tensor,  # [B, N, Din] merged uih | candidates
        seq_lengths: torch.Tensor,  # int[B]
        seq_timestamps: torch.Tensor,  # [B, N]
        uih_lengths: torch.Tensor,  # int[B]
        num_targets: torch.Tensor,  # int[B]
        seq_payloads: Dict[str, torch.Tensor],
        deterministic: bool = True,
        gen: Optional[torch.Generator] = None,  # the contextual dropout's, in training
    ) -> PreprocessorOutput:
        B, N, _ = seq_embeddings.shape
        C = self.max_contextual_seq_len
        ctx_tokens = pmlp_ctx = None
        if C > 0:
            parts = []
            for name, max_len in self.contextual_feature_to_max_length:
                v = seq_payloads[name].to(seq_embeddings.dtype).reshape(B, max_len, self.input_embedding_dim)
                m = self.min_uih_lengths.get(name, 0)
                if m > 0:
                    v = v * (seq_lengths[:, None, None] >= m).to(v.dtype)
                parts.append(v)
            ctx_in = torch.cat(parts, dim=1)  # [B, C, Din]
            if self.use_parameterized_mlps:
                pmlp_ctx = ctx_in.reshape(B, C * self.input_embedding_dim)
                if not deterministic:
                    pmlp_ctx = dropout(pmlp_ctx, self.pmlp_contextual_dropout_ratio, gen)
            ctx_tokens = (
                torch.einsum("bcd,cde->bce", ctx_in.float(), self.batched_contextual_linear_weights.float())
                + self.batched_contextual_linear_bias[None]
            ).to(seq_embeddings.dtype)

        content = self.content_mlp(self.content_encoder(seq_embeddings, uih_lengths, seq_payloads), pmlp_ctx)
        action = self.action_mlp(self.action_encoder(uih_lengths, seq_payloads), pmlp_ctx)

        if not self.enable_interleaving:
            out, out_ts = content + action, seq_timestamps
            out_lengths, out_uih_lengths, out_num_targets = seq_lengths, uih_lengths, num_targets
        else:
            q = torch.arange(2 * N, device=seq_embeddings.device)[None, :]
            if self.interleave_targets(deterministic):
                seq_pos, which = (q // 2).expand(B, -1), (q % 2).expand(B, -1)
                out_lengths, out_num_targets = seq_lengths * 2, num_targets * 2
            else:
                two_uih = 2 * uih_lengths.long()[:, None]
                is_pair = q < two_uih
                seq_pos = torch.where(is_pair, q // 2, uih_lengths.long()[:, None] + (q - two_uih))
                which = torch.where(is_pair, q % 2, 0)
                out_lengths, out_num_targets = 2 * uih_lengths + num_targets, num_targets
            out_uih_lengths = uih_lengths * 2
            seq_pos = seq_pos.clamp(0, N - 1)
            gat = lambda a: torch.gather(a, 1, seq_pos[..., None].expand(B, 2 * N, a.shape[-1]))  # noqa: E731
            out = torch.where((which == 0)[..., None], gat(content), gat(action))
            valid = q < out_lengths[:, None]
            out = out * valid[..., None].to(out.dtype)
            out_ts = torch.where(valid, torch.gather(seq_timestamps, 1, seq_pos), 0).to(seq_timestamps.dtype)

        if C > 0:
            out = prepend_prefix(out, ctx_tokens)
            out_ts = prepend_prefix(out_ts, out_ts.new_zeros((B, C)))
            out_lengths = out_lengths + C
            out_uih_lengths = out_uih_lengths + C
        return PreprocessorOutput(
            seq_embeddings=out,
            seq_lengths=out_lengths,
            seq_timestamps=out_ts,
            uih_lengths=out_uih_lengths,
            num_targets=out_num_targets,
            contextual_seq_len=C,
        )
