"""DlrmHSTU, the production multitask ranker (port of
`generative_recommenders_tpu/modules/dlrm_hstu.py`).

Embedding lookup of uih + candidate features -> merge into one
[uih | candidates] sequence -> item tower MLP and user tower
(HSTUTransducer) -> multitask predictions and, for training, the
supervision decoded from the candidates' action bitmasks and watch time and
the per-task losses; plus the M-FALCON prefill and chunk scoring. The tables
are parameters named ``embedding_tables_<name>`` as in the JAX package.

Batch layout, padded-dense:
  uih_features:        Dict[name, [B, max_uih_len]]        + uih_lengths int[B]
  candidates_features: Dict[name, [B, max_num_candidates]] + num_candidates
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from generative_recommenders_tpu_torch.modules.hstu_transducer import HSTUTransducer
from generative_recommenders_tpu_torch.modules.mlp import SwishMLP, new_param, truncated_normal
from generative_recommenders_tpu_torch.modules.multitask_module import (
    DefaultMultitaskModule,
    TaskConfig,
    get_supervision_labels_and_weights,
)
from generative_recommenders_tpu_torch.modules.positional_encoder import (
    HSTUPositionalEncoder,
)
from generative_recommenders_tpu_torch.modules.postprocessors import (
    L2NormPostprocessor,
    LayerNormPostprocessor,
    TimestampLayerNormPostprocessor,
)
from generative_recommenders_tpu_torch.modules.preprocessors import ContextualPreprocessor
from generative_recommenders_tpu_torch.modules.stu import KVCache, STULayerConfig, STUStack
from generative_recommenders_tpu_torch.ops.padded import concat_tail, valid_mask
from generative_recommenders_tpu_torch.utils.profiling import span

Lookup = Callable[[str, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class EmbeddingTableConfig:
    name: str
    num_embeddings: int
    embedding_dim: int
    feature_names: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class DlrmHSTUConfig:
    """The JAX package's `DlrmHSTUConfig` without the attention-kernel
    choice (a TPU option). The two dynamic STU knobs (`modules/dynamic_stu.py`)
    do not work with the M-FALCON cached path."""

    max_uih_len: int = 256
    max_num_candidates: int = 10
    max_num_candidates_inference: int = 5
    hstu_num_heads: int = 1
    hstu_attn_linear_dim: int = 256
    hstu_attn_qk_dim: int = 128
    hstu_attn_num_layers: int = 12
    hstu_embedding_table_dim: int = 192
    hstu_transducer_embedding_dim: int = 0
    hstu_group_norm: bool = False
    hstu_input_dropout_ratio: float = 0.2
    hstu_linear_dropout_rate: float = 0.2
    contextual_feature_to_max_length: Tuple[Tuple[str, int], ...] = ()
    contextual_feature_to_min_uih_length: Tuple[Tuple[str, int], ...] = ()
    candidates_weight_feature_name: str = ""
    candidates_watchtime_feature_name: str = ""
    candidates_querytime_feature_name: str = ""
    causal_multitask_weights: float = 0.2
    multitask_configs: Tuple[TaskConfig, ...] = ()
    user_embedding_feature_names: Tuple[str, ...] = ()
    item_embedding_feature_names: Tuple[str, ...] = ()
    uih_post_id_feature_name: str = ""
    uih_action_time_feature_name: str = ""
    uih_weight_feature_name: str = ""
    merge_uih_candidate_feature_mapping: Tuple[Tuple[str, str], ...] = ()
    action_weights: Optional[Tuple[int, ...]] = None
    enable_postprocessor: bool = True
    use_layer_norm_postprocessor: bool = False
    num_position_buckets: int = 8192
    num_time_buckets: int = 2048
    hstu_stochastic_depth_ratio: float = 0.0
    hstu_l2_max_len: int = 0


class DlrmHSTU(nn.Module):
    def __init__(
        self,
        cfg: DlrmHSTUConfig,
        embedding_tables: Tuple[EmbeddingTableConfig, ...],
        gen: Optional[torch.Generator] = None,
        lookup_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    ) -> None:
        super().__init__()
        self.cfg = cfg
        # the tables' lookup when bound (the trainers' sharded exchange,
        # `parallel/embedding.py`), else a local gather
        self.lookup_fn = lookup_fn
        self.embedding_tables = embedding_tables
        self.feature_to_table: Dict[str, str] = {}
        for t in embedding_tables:
            self.register_parameter(
                f"embedding_tables_{t.name}",
                new_param((t.num_embeddings, t.embedding_dim), truncated_normal(0.02), gen),
            )
            for f in t.feature_names:
                self.feature_to_table[f] = t.name

        D = cfg.hstu_transducer_embedding_dim
        ctx_len = sum(n for _, n in cfg.contextual_feature_to_max_length)
        stu_cfg = STULayerConfig(
            embedding_dim=D,
            num_heads=cfg.hstu_num_heads,
            hidden_dim=cfg.hstu_attn_linear_dim,
            attention_dim=cfg.hstu_attn_qk_dim,
            output_dropout_ratio=cfg.hstu_linear_dropout_rate,
            use_group_norm=cfg.hstu_group_norm,
            contextual_seq_len=ctx_len,
            # the training-time padded length, so that the M-FALCON prefill
            # and delta passes normalise like the full forward
            norm_seq_len=ctx_len + cfg.max_uih_len + cfg.max_num_candidates,
        )
        if not cfg.enable_postprocessor:
            postproc = L2NormPostprocessor()
        elif cfg.use_layer_norm_postprocessor:
            postproc = LayerNormPostprocessor(D)
        else:  # hour of day, day of week
            postproc = TimestampLayerNormPostprocessor(D, ((3600, 24), (86400, 7)), gen=gen)
        self.hstu_transducer = HSTUTransducer(
            stu_module=STUStack(
                tuple(stu_cfg for _ in range(cfg.hstu_attn_num_layers)), gen,
                stochastic_depth_ratio=cfg.hstu_stochastic_depth_ratio,
                l2_max_len=cfg.hstu_l2_max_len,
            ),
            input_preprocessor=ContextualPreprocessor(
                input_embedding_dim=cfg.hstu_embedding_table_dim,
                output_embedding_dim=D,
                contextual_feature_to_max_length=cfg.contextual_feature_to_max_length,
                contextual_feature_to_min_uih_length=cfg.contextual_feature_to_min_uih_length,
                action_feature_name=cfg.uih_weight_feature_name,
                action_weights=cfg.action_weights,
                gen=gen,
            ),
            output_postprocessor=postproc,
            positional_encoder=HSTUPositionalEncoder(
                cfg.num_position_buckets, cfg.num_time_buckets, D, ctx_len, gen
            ),
            input_dropout_ratio=cfg.hstu_input_dropout_ratio,
        )
        self.item_embedding_mlp = SwishMLP(
            cfg.hstu_embedding_table_dim * len(cfg.item_embedding_feature_names), 512, D, gen
        )
        self.multitask_module = DefaultMultitaskModule(
            cfg.multitask_configs, D, cfg.causal_multitask_weights, gen=gen
        )

    def table(self, name: str) -> torch.Tensor:
        return getattr(self, f"embedding_tables_{name}")

    def _lookup(self, feature: str, ids: torch.Tensor) -> torch.Tensor:
        table = self.table(self.feature_to_table[feature])
        if self.lookup_fn is not None:
            return self.lookup_fn(table, ids.long())
        return table[ids.long()]

    def _item_forward(self, embeddings: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Item tower on the candidate-side embeddings [B, M, D]."""
        return self.item_embedding_mlp(
            torch.cat([embeddings[n] for n in self.cfg.item_embedding_feature_names], dim=-1)
        )

    def main_forward(
        self,
        seq_embeddings: Dict[str, torch.Tensor],
        payload_features: Dict[str, torch.Tensor],
        uih_lengths: torch.Tensor,
        num_candidates: torch.Tensor,
        deterministic: bool = True,
        compute_losses: bool = True,
        gen: Optional[torch.Generator] = None,
        sd_gen: Optional[torch.Generator] = None,
    ):
        """Returns (user_embeddings, item_embeddings, aux_losses {task: loss},
        preds [T, B, M], labels, weights), as the JAX package does; without
        ``compute_losses`` aux_losses is empty and labels and weights are
        None. ``deterministic=False`` turns dropout on, drawn from ``gen``,
        and stochastic depth, its coins drawn from ``sd_gen``."""
        cfg = self.cfg
        M = cfg.max_num_candidates
        item_embeddings = self._item_forward(seq_embeddings)
        user_embeddings = self.hstu_transducer(
            seq_embeddings[cfg.uih_post_id_feature_name],
            uih_lengths + num_candidates,
            # merged timestamps: uih action time | candidate query time
            payload_features[cfg.uih_action_time_feature_name],
            uih_lengths,
            num_candidates,
            {**payload_features, **seq_embeddings},
            max_targets=M,
            deterministic=deterministic,
            gen=gen,
            sd_gen=sd_gen,
        )
        labels, weights = get_supervision_labels_and_weights(
            payload_features[cfg.candidates_weight_feature_name],
            payload_features[cfg.candidates_watchtime_feature_name],
            cfg.multitask_configs,
        )
        preds, mt_labels, mt_weights, mt_losses = self.multitask_module(
            user_embeddings, item_embeddings, labels, weights,
            valid_mask(num_candidates, M), compute_losses=compute_losses,
        )
        aux_losses = {}
        if compute_losses:
            aux_losses = {t.task_name: mt_losses[i] for i, t in enumerate(cfg.multitask_configs)}
        return user_embeddings, item_embeddings, aux_losses, preds, mt_labels, mt_weights

    def forward(
        self,
        uih_features: Dict[str, torch.Tensor],
        uih_lengths: torch.Tensor,
        candidates_features: Dict[str, torch.Tensor],
        num_candidates: torch.Tensor,
        deterministic: bool = True,
        compute_losses: bool = True,
        gen: Optional[torch.Generator] = None,
        sd_gen: Optional[torch.Generator] = None,
    ):
        """Lookup and merge, then `main_forward` (same return)."""
        seq_embeddings, payload_features = lookup_and_merge_features(
            self.cfg, self.feature_to_table, self._lookup,
            uih_features, uih_lengths, candidates_features,
        )
        return self.main_forward(
            seq_embeddings, payload_features, uih_lengths, num_candidates,
            deterministic=deterministic, compute_losses=compute_losses, gen=gen, sd_gen=sd_gen,
        )

    def _split(self, features: Dict[str, torch.Tensor]):
        emb, payloads = {}, {}
        for f, v in features.items():
            if f in self.feature_to_table:
                emb[f] = self._lookup(f, v)
            else:
                payloads[f] = v
        return emb, payloads

    def mfalcon_prefill(
        self,
        uih_features: Dict[str, torch.Tensor],
        uih_lengths: torch.Tensor,
        query_time: torch.Tensor,  # int[B]: the candidates' query time
    ) -> Tuple[List[KVCache], torch.Tensor]:
        """Encodes the uih once; returns (per-layer KV caches, contextual-
        shifted uih lengths)."""
        cfg = self.cfg
        emb, payloads = self._split(uih_features)
        return self.hstu_transducer.prefill(
            emb[cfg.uih_post_id_feature_name], uih_lengths,
            payloads[cfg.uih_action_time_feature_name], query_time,
            {**payloads, **emb},
        )

    def mfalcon_score_chunk(
        self,
        caches: List[KVCache],
        candidates_features: Dict[str, torch.Tensor],  # [B, m] chunk
        query_time: torch.Tensor,  # int[B]
    ) -> torch.Tensor:
        """Predictions [T, B, m] of one m-candidate chunk scored against the
        caches."""
        cfg = self.cfg
        emb, payloads = self._split(candidates_features)
        # the candidate twin of uih_post_id, through the merge mapping
        cand_input = emb[dict(cfg.merge_uih_candidate_feature_mapping)[cfg.uih_post_id_feature_name]]
        cand_ts = payloads[cfg.candidates_querytime_feature_name]
        user_embeddings = self.hstu_transducer.cached_score(cand_input, cand_ts, caches, query_time)
        return self.multitask_module(
            user_embeddings, self._item_forward(emb), {}, {},
            torch.ones(cand_ts.shape, dtype=torch.bool, device=cand_ts.device),
            compute_losses=False,
        )[0]


def lookup_and_merge_features(
    cfg: DlrmHSTUConfig,
    feature_to_table: Dict[str, str],
    lookup_fn: Lookup,
    uih_features: Dict[str, torch.Tensor],
    uih_lengths: torch.Tensor,
    candidates_features: Dict[str, torch.Tensor],
):
    """Lookup + uih/candidate merge, shared by `DlrmHSTU.preprocess` and the
    serving sparse stage (which looks up the quantized tables). Returns
    (seq_embeddings, payload_features)."""
    seq_embeddings: Dict[str, torch.Tensor] = {}
    payload_features: Dict[str, torch.Tensor] = {}
    with span("dlrm.lookup"):
        for f, ids in list(uih_features.items()) + list(candidates_features.items()):
            if f in feature_to_table:
                seq_embeddings[f] = lookup_fn(f, ids)
            else:
                payload_features[f] = ids
        for uih_name, cand_name in cfg.merge_uih_candidate_feature_mapping:
            for d in (seq_embeddings, payload_features):
                if uih_name in d:
                    d[uih_name] = concat_tail(d[uih_name], uih_lengths, d[cand_name])
                    break
    return seq_embeddings, payload_features
