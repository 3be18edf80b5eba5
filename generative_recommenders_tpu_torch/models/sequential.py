"""Top-level sequential recommender of the research stack: embedding, input
preprocessor, encoder, output postprocessor and similarity (port of
`generative_recommenders_tpu/models/sequential.py`).

Ported: ``main_module="HSTU"`` with the ``DotProduct`` similarity, in
float32. SASRec, MoL, ``compute_dtype="bfloat16"``, ``remat`` and the
KV-cached `encode_with_cache` / `encode_delta` are not ported yet; asking
for them raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from generative_recommenders_tpu_torch.models.embeddings import LocalEmbeddingModule
from generative_recommenders_tpu_torch.models.hstu import HSTUEncoder
from generative_recommenders_tpu_torch.models.postprocessors import make_output_postprocessor
from generative_recommenders_tpu_torch.models.preprocessors import (
    LearnablePositionalEmbeddingInputFeaturesPreprocessor,
)
from generative_recommenders_tpu_torch.models.seq_utils import get_current_embeddings
from generative_recommenders_tpu_torch.models.similarity import dot_product_similarity


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The encoder's parameters, field for field the JAX package's
    `ModelConfig`, so that its presets carry over."""

    main_module: str = "HSTU"  # "HSTU" | "SASRec" (not ported)
    num_items: int = 1000
    max_sequence_len: int = 200
    gr_output_length: int = 10  # extra output slots; total N = max_seq + gr + 1
    item_embedding_dim: int = 50
    num_blocks: int = 8
    num_heads: int = 2
    dqk: int = 25
    dv: int = 25
    linear_dropout_rate: float = 0.2
    attn_dropout_rate: float = 0.0
    dropout_rate: float = 0.2  # input preprocessor dropout
    user_embedding_norm: str = "l2_norm"
    enable_relative_attention_bias: bool = True
    linear_activation: str = "silu"
    concat_ua: bool = False
    # SASRec only
    ffn_hidden_dim: int = 64
    ffn_activation_fn: str = "relu"
    # the JAX package's kernel choice; the port picks by the tensors' device
    # and does not read it
    attn_kernel: str = "xla"
    compute_dtype: str = "float32"  # "bfloat16" is not ported
    remat: bool = False  # not ported
    interaction_module_type: str = "DotProduct"  # "MoL" is not ported
    mol_config: Optional[Any] = None

    @property
    def total_seq_len(self) -> int:
        return self.max_sequence_len + self.gr_output_length + 1


class SequentialRecommender(nn.Module):
    """Encoder + similarity retrieval model: `get_item_embeddings(ids)`,
    `forward(...)` -> [B, N, D], `encode(...)` -> [B, D],
    `similarity_fn(query, items)`. The weights are drawn from ``gen``."""

    def __init__(self, config: ModelConfig, gen: Optional[torch.Generator] = None) -> None:
        super().__init__()
        cfg = self.config = config
        if cfg.main_module != "HSTU":
            if cfg.main_module == "SASRec":
                raise NotImplementedError("main_module='SASRec' is not ported yet")
            raise ValueError(f"Unknown main_module {cfg.main_module}")
        if cfg.interaction_module_type != "DotProduct":
            if cfg.interaction_module_type == "MoL":
                raise NotImplementedError("interaction_module_type='MoL' is not ported yet")
            raise ValueError(f"Unknown interaction_module_type {cfg.interaction_module_type}")
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(f"compute_dtype={cfg.compute_dtype!r} is not ported yet")
        if cfg.remat:
            raise NotImplementedError("remat (activation recomputation) is not ported yet")
        self.embedding_module = LocalEmbeddingModule(cfg.num_items, cfg.item_embedding_dim, gen)
        self.input_preproc = LearnablePositionalEmbeddingInputFeaturesPreprocessor(
            max_sequence_len=cfg.total_seq_len,
            embedding_dim=cfg.item_embedding_dim,
            dropout_rate=cfg.dropout_rate,
            pos_emb_init="xavier_normal",
            gen=gen,
        )
        self.encoder = HSTUEncoder(
            embedding_dim=cfg.item_embedding_dim,
            num_blocks=cfg.num_blocks,
            num_heads=cfg.num_heads,
            attention_dim=cfg.dqk,
            linear_dim=cfg.dv,
            linear_dropout_rate=cfg.linear_dropout_rate,
            attn_dropout_rate=cfg.attn_dropout_rate,
            linear_activation=cfg.linear_activation,
            enable_relative_attention_bias=cfg.enable_relative_attention_bias,
            concat_ua=cfg.concat_ua,
            max_total_seq_len=cfg.total_seq_len,
            gen=gen,
        )
        self.output_postproc = make_output_postprocessor(
            cfg.user_embedding_norm, cfg.item_embedding_dim
        )

    def get_item_embeddings(self, item_ids: torch.Tensor) -> torch.Tensor:
        return self.embedding_module(item_ids)

    def forward(
        self,
        past_lengths: torch.Tensor,  # int[B]
        past_ids: torch.Tensor,  # int[B, N]
        past_embeddings: torch.Tensor,  # [B, N, D]
        past_payloads: Dict[str, torch.Tensor],
        deterministic: bool = False,
        gen: Optional[torch.Generator] = None,  # the dropout masks' generator
    ) -> torch.Tensor:
        """The user embeddings [B, N, D] at every position."""
        cfg = self.config
        lengths, user_embeddings, _ = self.input_preproc(
            past_lengths, past_ids, past_embeddings, past_payloads,
            deterministic=deterministic, gen=gen,
        )
        timestamps = (
            past_payloads.get("timestamps") if cfg.enable_relative_attention_bias else None
        )
        encoded = self.encoder(
            user_embeddings, lengths, timestamps, deterministic=deterministic, gen=gen
        )
        return self.output_postproc(encoded.float())

    def encode(
        self,
        past_lengths: torch.Tensor,
        past_ids: torch.Tensor,
        past_embeddings: torch.Tensor,
        past_payloads: Dict[str, torch.Tensor],
        deterministic: bool = True,
        gen: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """The user embedding [B, D] at each row's last position."""
        encoded = self(past_lengths, past_ids, past_embeddings, past_payloads, deterministic, gen)
        return get_current_embeddings(past_lengths, encoded)

    def encode_with_cache(self, *args, **kwargs):
        raise NotImplementedError("the KV-cached encode is not ported yet")

    def encode_delta(self, *args, **kwargs):
        raise NotImplementedError("the KV-cached encode is not ported yet")

    def similarity_fn(
        self,
        query_embeddings: torch.Tensor,  # [B, D]
        item_embeddings: torch.Tensor,  # [1 or B, X, D]
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return dot_product_similarity(query_embeddings, item_embeddings)
