"""HSTU transducer (port of
`generative_recommenders_tpu/modules/hstu_transducer.py`), padded-dense.

Input preprocessor -> positional encoder -> input dropout -> STU stack ->
candidate embeddings -> output postprocessor. Dropout runs only when the
caller passes ``deterministic=False`` and a generator; ``listwise`` turns
the target-aware masking off in training. The M-FALCON path: `prefill`
encodes the uih prefix once and returns per-layer KV caches; `cached_score`
scores a candidate chunk against them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from generative_recommenders_tpu_torch.modules.positional_encoder import (
    HSTUPositionalEncoder,
)
from generative_recommenders_tpu_torch.modules.preprocessors import ContextualPreprocessor
from generative_recommenders_tpu_torch.modules.stu import KVCache, STUStack
from generative_recommenders_tpu_torch.ops.hstu_compute import dropout
from generative_recommenders_tpu_torch.ops.padded import gather_tail
from generative_recommenders_tpu_torch.utils.profiling import span


class HSTUTransducer(nn.Module):
    def __init__(
        self,
        stu_module: STUStack,
        input_preprocessor: ContextualPreprocessor,
        output_postprocessor: nn.Module,
        positional_encoder: HSTUPositionalEncoder,
        input_dropout_ratio: float = 0.0,
        listwise: bool = False,
    ) -> None:
        super().__init__()
        self.stu_module = stu_module
        self.input_preprocessor = input_preprocessor
        self.output_postprocessor = output_postprocessor
        self.positional_encoder = positional_encoder
        self.input_dropout_ratio = input_dropout_ratio
        self.listwise = listwise

    def forward(
        self,
        seq_embeddings: torch.Tensor,  # [B, N, Din] merged uih | candidates
        seq_lengths: torch.Tensor,  # int[B]
        seq_timestamps: torch.Tensor,  # [B, N]
        uih_lengths: torch.Tensor,  # int[B]
        num_targets: torch.Tensor,  # int[B]
        seq_payloads: Dict[str, torch.Tensor],
        max_targets: int,
        deterministic: bool = True,
        gen: Optional[torch.Generator] = None,  # the dropout's, when not deterministic
        sd_gen: Optional[torch.Generator] = None,  # stochastic depth's coins
    ) -> torch.Tensor:
        """Postprocessed candidate embeddings [B, max_targets, D]."""
        pre = self.input_preprocessor(
            seq_embeddings, seq_lengths, seq_timestamps, uih_lengths,
            num_targets, seq_payloads,
        )
        nt = None if (self.listwise and not deterministic) else pre.num_targets
        x = self.positional_encoder(pre.seq_embeddings, pre.seq_lengths, pre.seq_timestamps, nt)
        if not deterministic:
            x = dropout(x, self.input_dropout_ratio, gen)
        with span("dlrm.stu"):
            encoded = self.stu_module(x, pre.seq_lengths, nt, deterministic, gen, sd_gen)
        cand = gather_tail(encoded, pre.uih_lengths, max_targets)
        cand_ts = gather_tail(pre.seq_timestamps, pre.uih_lengths, max_targets)
        return self.output_postprocessor(cand, cand_ts)

    def prefill(
        self,
        uih_embeddings: torch.Tensor,  # [B, Nu, Din]
        uih_lengths: torch.Tensor,  # int[B]
        uih_timestamps: torch.Tensor,  # [B, Nu]
        query_time: torch.Tensor,  # int[B]: the candidates' query time
        seq_payloads: Dict[str, torch.Tensor],
    ) -> Tuple[List[KVCache], torch.Tensor]:
        """Encodes the uih prefix once; returns the per-layer KV caches and
        the contextual-shifted uih lengths."""
        B = uih_embeddings.shape[0]
        pre = self.input_preprocessor(
            uih_embeddings, uih_lengths, uih_timestamps, uih_lengths,
            torch.zeros(B, dtype=torch.int32, device=uih_embeddings.device),
            seq_payloads,
        )
        # no targets in the prefix; time buckets measured against the query
        # time, as the full pass does
        x = self.positional_encoder(
            pre.seq_embeddings, pre.seq_lengths, pre.seq_timestamps, None, query_time
        )
        _, caches = self.stu_module.prefill(x, pre.seq_lengths, pre.seq_lengths)
        return caches, pre.seq_lengths

    def cached_score(
        self,
        cand_embeddings: torch.Tensor,  # [B, m, Din]: a candidate chunk
        cand_timestamps: torch.Tensor,  # [B, m]
        caches: List[KVCache],
        query_time: torch.Tensor,  # int[B]
    ) -> torch.Tensor:
        """Postprocessed embeddings [B, m, D] of one candidate chunk scored
        against the prefilled caches."""
        B, m, _ = cand_embeddings.shape
        x = self.input_preprocessor.delta_candidates(cand_embeddings)
        x = self.positional_encoder.delta(x, cand_timestamps, query_time)
        nt = torch.full((B,), m, dtype=torch.int32, device=x.device)
        delta_out, _ = self.stu_module.cached_forward(x, caches, nt)
        return self.output_postprocessor(delta_out, cand_timestamps)
