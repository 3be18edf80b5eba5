"""Top-level sequential recommender of the research stack: embedding, input
preprocessor, encoder, output postprocessor and similarity (port of
`generative_recommenders_tpu/models/sequential.py`).

Ported: ``main_module="HSTU"`` and ``"SASRec"`` with the ``DotProduct``
or the ``MoL`` similarity (`models/rails/mol.py`), HSTU's KV-cached
`encode_with_cache` / `encode_delta`, ``remat`` (per-block recomputation,
`models/hstu.py`) and ``compute_dtype="bfloat16"``.

Under ``compute_dtype="bfloat16"`` the preprocessed input is cast to
bfloat16 before the encoder and the encoder's output back to float32 before
the output postprocessor, as in the JAX package. What runs in bfloat16
follows flax's type promotion layer by layer: in HSTU only the first block
(its float32 output projection promotes the residual stream to float32), in
SASRec only the first block's query layer norm (its float32 input
projection promotes the rest).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from generative_recommenders_tpu_torch.models.embeddings import LocalEmbeddingModule, LookupFn
from generative_recommenders_tpu_torch.models.hstu import HSTUEncoder
from generative_recommenders_tpu_torch.models.postprocessors import make_output_postprocessor
from generative_recommenders_tpu_torch.models.preprocessors import (
    LearnablePositionalEmbeddingInputFeaturesPreprocessor,
)
from generative_recommenders_tpu_torch.models.rails.mol import MoLConfig, MoLSimilarity
from generative_recommenders_tpu_torch.models.sasrec import SASRecEncoder
from generative_recommenders_tpu_torch.models.seq_utils import get_current_embeddings
from generative_recommenders_tpu_torch.models.similarity import dot_product_similarity


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The encoder's parameters, field for field the JAX package's
    `ModelConfig`, so that its presets carry over."""

    main_module: str = "HSTU"  # "HSTU" | "SASRec"
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
    compute_dtype: str = "float32"  # | "bfloat16"
    remat: bool = False  # per-block activation recomputation (HSTU)
    interaction_module_type: str = "DotProduct"  # | "MoL"
    mol_config: Optional[MoLConfig] = None  # None: MoLConfig(D, D)

    @property
    def total_seq_len(self) -> int:
        return self.max_sequence_len + self.gr_output_length + 1


class SequentialRecommender(nn.Module):
    """Encoder + similarity retrieval model: `get_item_embeddings(ids)`,
    `forward(...)` -> [B, N, D], `encode(...)` -> [B, D],
    `similarity_fn(query, items)`. The weights are drawn from ``gen``."""

    def __init__(
        self, config: ModelConfig, gen: Optional[torch.Generator] = None, lookup_fn: Optional[LookupFn] = None
    ) -> None:
        super().__init__()
        cfg = self.config = config
        if cfg.main_module not in ("HSTU", "SASRec"):
            raise ValueError(f"Unknown main_module {cfg.main_module}")
        if cfg.interaction_module_type not in ("DotProduct", "MoL"):
            raise ValueError(f"Unknown interaction_module_type {cfg.interaction_module_type}")
        if cfg.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"Unknown compute_dtype {cfg.compute_dtype}")
        self.embedding_module = LocalEmbeddingModule(
            cfg.num_items, cfg.item_embedding_dim, gen, lookup_fn=lookup_fn
        )
        self.input_preproc = LearnablePositionalEmbeddingInputFeaturesPreprocessor(
            max_sequence_len=cfg.total_seq_len,
            embedding_dim=cfg.item_embedding_dim,
            dropout_rate=cfg.dropout_rate,
            pos_emb_init="xavier_normal" if cfg.main_module == "HSTU" else "truncated_normal",
            gen=gen,
        )
        if cfg.main_module == "HSTU":
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
                remat=cfg.remat,
                gen=gen,
            )
        else:
            self.encoder = SASRecEncoder(
                embedding_dim=cfg.item_embedding_dim,
                num_blocks=cfg.num_blocks,
                num_heads=cfg.num_heads,
                ffn_hidden_dim=cfg.ffn_hidden_dim,
                ffn_activation_fn=cfg.ffn_activation_fn,
                ffn_dropout_rate=cfg.linear_dropout_rate,
                gen=gen,
            )
        self.output_postproc = make_output_postprocessor(
            cfg.user_embedding_norm, cfg.item_embedding_dim
        )
        if cfg.interaction_module_type == "MoL":
            self.mol = MoLSimilarity(
                cfg.mol_config
                or MoLConfig(
                    query_embedding_dim=cfg.item_embedding_dim,
                    item_embedding_dim=cfg.item_embedding_dim,
                ),
                gen,
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
        lengths, user_embeddings, valid_mask = self.input_preproc(
            past_lengths, past_ids, past_embeddings, past_payloads,
            deterministic=deterministic, gen=gen,
        )
        user_embeddings = self._to_compute_dtype(user_embeddings)
        if cfg.main_module == "SASRec":
            encoded = self.encoder(
                user_embeddings, lengths, None, deterministic, gen, valid_mask=valid_mask
            )
        else:
            encoded = self.encoder(
                user_embeddings, lengths, self._timestamps(past_payloads), deterministic, gen
            )
        return self.output_postproc(encoded.float())

    def _to_compute_dtype(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.bfloat16) if self.config.compute_dtype == "bfloat16" else x

    def _timestamps(self, payloads: Dict[str, torch.Tensor]) -> Optional[torch.Tensor]:
        return payloads.get("timestamps") if self.config.enable_relative_attention_bias else None

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

    # ------------------------------------------------------ KV-cached encode
    # Encode a prefix once, then each appended token at O(M N) instead of
    # O(N^2): the research twin of M-FALCON. HSTU only.

    def _check_hstu(self) -> None:
        if self.config.main_module != "HSTU":
            raise ValueError("the KV-cached encode is HSTU-only")

    def encode_with_cache(
        self,
        past_lengths: torch.Tensor,  # int[B]
        past_ids: torch.Tensor,  # int[B, N]
        past_embeddings: torch.Tensor,  # [B, N, D]
        past_payloads: Dict[str, torch.Tensor],
        reserved_slots: int = 0,
    ) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
        """A full encode (dropout off) that also returns each layer's (k, v)
        [B, N - reserved_slots, H, d], and the embedding [B, D] at each row's
        last position.

        ``reserved_slots`` must be the number M of tokens a later
        `encode_delta` appends: the caches lose their last M columns, so that
        the delta step runs at this call's width N (the silu normaliser is
        1 / width and the bias table is read by width). Those columns are
        padding as long as every row has lengths <= N - M, which the
        ``gr_output_length`` tail slots give the research batch layout.

        With the relative bias, row i's time bucket reads ts[i + 1], so
        ``past_payloads["timestamps"]`` must hold the first appended token's
        timestamp at position ``past_lengths`` (the layout
        `seq_features_from_row` gives by scattering the target's timestamp
        there); otherwise the cached prefix differs from a full encode."""
        self._check_hstu()
        lengths, user_embeddings, _ = self.input_preproc(
            past_lengths, past_ids, past_embeddings, past_payloads, deterministic=True
        )
        encoded, caches = self.encoder(
            self._to_compute_dtype(user_embeddings), lengths, self._timestamps(past_payloads),
            deterministic=True, return_caches=True,
        )
        if reserved_slots > 0:
            caches = [(k[:, :-reserved_slots], v[:, :-reserved_slots]) for k, v in caches]
        out = self.output_postproc(encoded.float())
        return get_current_embeddings(past_lengths, out), caches

    def encode_delta(
        self,
        cache_lengths: torch.Tensor,  # int[B]: each row's cached prefix
        delta_ids: torch.Tensor,  # int[B, M]: the appended tokens
        delta_embeddings: torch.Tensor,  # [B, M, D]
        full_payloads: Dict[str, torch.Tensor],  # timestamps over prefix and delta
        caches: List[Tuple[torch.Tensor, torch.Tensor]],
    ) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
        """Encodes only the M appended tokens against the cached prefix.
        Returns the embedding [B, D] after the append and the extended
        caches [B, Nc + M, H, d]."""
        self._check_hstu()
        M = delta_ids.shape[1]
        positions = cache_lengths.long()[:, None] + torch.arange(M, device=delta_ids.device)[None, :]
        _, delta_emb, _ = self.input_preproc(
            cache_lengths, delta_ids, delta_embeddings, full_payloads,
            deterministic=True, delta_positions=positions,
        )
        encoded, new_caches = self.encoder(
            self._to_compute_dtype(delta_emb), cache_lengths + M, self._timestamps(full_payloads),
            deterministic=True, caches=caches, cache_lengths=cache_lengths,
        )
        return self.output_postproc(encoded.float())[:, -1, :], new_caches

    def similarity_fn(
        self,
        query_embeddings: torch.Tensor,  # [B, D]
        item_embeddings: torch.Tensor,  # [1 or B, X, D]
        user_ids: Optional[torch.Tensor] = None,  # int[B]: MoL's uid tables
        deterministic: bool = True,
        gen: Optional[torch.Generator] = None,  # MoL's dropout masks
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """([B, X] logits, aux losses) by DotProduct or MoL."""
        if self.config.interaction_module_type == "MoL":
            return self.mol(query_embeddings, item_embeddings, user_ids, deterministic, gen)
        return dot_product_similarity(query_embeddings, item_embeddings)

    def mol_item_components(
        self, item_embeddings: torch.Tensor  # [X, D]
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """MoL's item side of a corpus, computed once for every query:
        (components [X, P_X, d], item gate [X, E] or None)."""
        i_comp = self.mol.item_components(item_embeddings[None])[0]
        gi = self.mol.gating_item_partial(item_embeddings[None])
        return i_comp, (None if gi is None else gi[0])

    def mol_score_components(
        self,
        query_embeddings: torch.Tensor,  # [B, D]
        i_comp: torch.Tensor,  # [X, P_X, d]
        gi: Optional[torch.Tensor],  # [X, E]
        user_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """MoL's scores [B, X] of queries against precomputed item
        components, dropout off."""
        q_comp, _ = self.mol.query_components(query_embeddings, user_ids, True)
        logits, _ = self.mol.score_components(
            query_embeddings, q_comp, i_comp[None], None if gi is None else gi[None], True
        )
        return logits
