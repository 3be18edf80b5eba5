"""Contextual input preprocessor (port of
`generative_recommenders_tpu/modules/preprocessors.py`), padded-dense.

Content MLP on item embeddings, plus the action encoder's MLP; contextual
features go through per-position linear maps (a [C, Din, Dout] weight batch)
and are prepended as C extra tokens, shifting lengths by C.
`delta_candidates` is the M-FALCON twin for a chunk of candidate tokens.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from generative_recommenders_tpu_torch.modules.action_encoder import ActionEncoder
from generative_recommenders_tpu_torch.modules.mlp import SwishMLP, new_param, normal, zeros
from generative_recommenders_tpu_torch.ops.padded import prepend_prefix


@dataclasses.dataclass(frozen=True)
class PreprocessorOutput:
    seq_embeddings: torch.Tensor  # [B, C + N, Dout]
    seq_lengths: torch.Tensor  # int[B]
    seq_timestamps: torch.Tensor  # [B, C + N]
    uih_lengths: torch.Tensor  # int[B] (incl. the contextual prefix)
    num_targets: torch.Tensor  # int[B]
    contextual_seq_len: int = 0


class ContextualPreprocessor(nn.Module):
    def __init__(
        self,
        input_embedding_dim: int,
        output_embedding_dim: int,
        contextual_feature_to_max_length: Tuple[Tuple[str, int], ...] = (),
        contextual_feature_to_min_uih_length: Tuple[Tuple[str, int], ...] = (),
        action_embedding_dim: int = 8,
        action_feature_name: str = "",
        action_weights: Optional[Tuple[int, ...]] = None,
        hidden_dim: int = 256,
        gen: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.input_embedding_dim = input_embedding_dim
        self.contextual_feature_to_max_length = contextual_feature_to_max_length
        self.min_uih_lengths = dict(contextual_feature_to_min_uih_length)
        self.content_mlp = SwishMLP(input_embedding_dim, hidden_dim, output_embedding_dim, gen)
        self.action_encoder = None
        if action_weights is not None:
            self.action_encoder = ActionEncoder(
                action_embedding_dim, action_feature_name, tuple(action_weights), gen=gen
            )
            self.action_mlp = SwishMLP(
                self.action_encoder.output_embedding_dim, hidden_dim,
                output_embedding_dim, gen,
            )
        C = self.max_contextual_seq_len
        if C > 0:
            std = math.sqrt(2.0 / (input_embedding_dim + output_embedding_dim))
            self.batched_contextual_linear_weights = new_param(
                (C, input_embedding_dim, output_embedding_dim), normal(std), gen
            )
            self.batched_contextual_linear_bias = new_param(
                (C, output_embedding_dim), zeros, gen
            )

    @property
    def max_contextual_seq_len(self) -> int:
        return sum(n for _, n in self.contextual_feature_to_max_length)

    def forward(
        self,
        seq_embeddings: torch.Tensor,  # [B, N, Din] merged uih | candidates
        seq_lengths: torch.Tensor,  # int[B]
        seq_timestamps: torch.Tensor,  # [B, N]
        uih_lengths: torch.Tensor,  # int[B]
        num_targets: torch.Tensor,  # int[B]
        seq_payloads: Dict[str, torch.Tensor],
    ) -> PreprocessorOutput:
        B = seq_embeddings.shape[0]
        out = self.content_mlp(seq_embeddings)
        if self.action_encoder is not None:
            out = out + self.action_mlp(self.action_encoder(uih_lengths, seq_payloads))

        C = self.max_contextual_seq_len
        if C > 0:
            # each feature padded to its max length; zeroed where the row is
            # shorter than the feature's min uih length
            parts = []
            for name, max_len in self.contextual_feature_to_max_length:
                v = seq_payloads[name].to(seq_embeddings.dtype)
                v = v.reshape(B, max_len, self.input_embedding_dim)
                min_uih = self.min_uih_lengths.get(name, 0)
                if min_uih > 0:
                    v = v * (seq_lengths[:, None, None] >= min_uih).to(v.dtype)
                parts.append(v)
            ctx_in = torch.cat(parts, dim=1)  # [B, C, Din]
            ctx = (
                torch.einsum("bcd,cde->bce", ctx_in, self.batched_contextual_linear_weights)
                + self.batched_contextual_linear_bias[None]
            ).to(out.dtype)
            out = prepend_prefix(out, ctx)
            seq_timestamps = prepend_prefix(
                seq_timestamps, seq_timestamps.new_zeros((B, C))
            )
            seq_lengths = seq_lengths + C
            uih_lengths = uih_lengths + C

        return PreprocessorOutput(
            seq_embeddings=out,
            seq_lengths=seq_lengths,
            seq_timestamps=seq_timestamps,
            uih_lengths=uih_lengths,
            num_targets=num_targets,
            contextual_seq_len=C,
        )

    def delta_candidates(self, cand_embeddings: torch.Tensor) -> torch.Tensor:
        """M-FALCON preprocessing of candidate tokens [B, m, Din]: what
        `forward` produces at candidate positions (content MLP + target
        action MLP), without the contextual prefix."""
        out = self.content_mlp(cand_embeddings)
        if self.action_encoder is not None:
            B, m, _ = cand_embeddings.shape
            target = self.action_encoder.target_embedding()  # [1, A*d]
            out = out + self.action_mlp(target[None].expand(B, m, target.shape[-1]))
        return out
