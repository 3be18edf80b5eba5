"""The Mixture-of-Logits (MoL) learned similarity of RAILS (port of
`generative_recommenders_tpu/models/rails/mol.py`).

    similarity(q, x) = sum_{p, m} pi_pm(q, x) <q_p, x_m>

over P_Q query-side and P_X item-side component embeddings; the gate pi is
a softmax over the P_Q * P_X logits of the query, item and query-item gating
MLPs, combined by ``gating_combination_type``. The item side
(`MoLSimilarity.item_components`, `gating_item_partial`) does not depend on
the query, so a corpus is projected once and scored in chunks
(`indexing/mol_top_k.py`).

Module and parameter names are the flax tree's (``query_proj/glu/w``,
``query_proj/out/kernel``, ``gating_qi/fc1/bias``, ``uid_embeddings_0``,
...), so `convert.params_from_flax` carries them over. Dropout draws from an
explicit ``torch.Generator``: the same seed does not give the JAX package's
masks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from generative_recommenders_tpu_torch.models.rails.layers import SwiGLU
from generative_recommenders_tpu_torch.modules.mlp import Dense, new_param, normal, xavier_uniform
from generative_recommenders_tpu_torch.ops.hstu_compute import dropout
from generative_recommenders_tpu_torch.ops.normalization import layer_norm
from generative_recommenders_tpu_torch.parallel.distributed import batch_ranks, batch_sum


@dataclasses.dataclass(frozen=True)
class MoLConfig:
    """Field for field the JAX package's `MoLConfig`, defaults included."""

    query_embedding_dim: int
    item_embedding_dim: int
    dot_product_dimension: int = 32
    query_dot_product_groups: int = 4
    item_dot_product_groups: int = 4
    temperature: float = 0.05
    dot_product_l2_norm: bool = True
    query_dropout_rate: float = 0.0
    query_hidden_dim: int = 128
    item_dropout_rate: float = 0.0
    item_hidden_dim: int = 128
    gating_query_hidden_dim: int = 128
    gating_item_hidden_dim: int = 128
    gating_qi_hidden_dim: int = 128
    softmax_dropout_rate: float = 0.0
    gating_query_fn: bool = True
    gating_item_fn: bool = True
    gating_combination_type: str = "glu_silu"  # | "glu_silu_ln" | "none"
    uid_embedding_hash_sizes: Tuple[int, ...] = ()
    uid_dropout_rate: float = 0.5
    uid_embedding_level_dropout: bool = False
    eps: float = 1e-6

    @property
    def num_logits(self) -> int:
        return self.query_dot_product_groups * self.item_dot_product_groups


def load_balancing_mi_loss(gating_prs: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The mutual-information load-balancing loss of the gate: minus the
    entropy of the mean utilisation plus the mean per-example entropy, both
    over the global batch. On a mesh this is the rank's share: its rows'
    entropies and 1 / ranks of the (global) utilisation's."""
    flat = gating_prs.reshape(-1, gating_prs.shape[-1])
    n = batch_sum(flat.new_tensor(float(flat.shape[0])))
    util = batch_sum(flat.sum(0)) / n
    util_entropy = -(util * torch.log(util + eps)).sum()
    per_example_entropy = -(flat * torch.log(flat + eps)).sum() / n
    return -util_entropy / batch_ranks() + per_example_entropy


def softmax_dropout_combiner(
    gating_weights: torch.Tensor,  # [..., E]
    logits: torch.Tensor,  # [..., E]
    dropout_rate: float,
    gen: Optional[torch.Generator],
    training: bool,
    eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gate, combined [...]): the softmax of the gating weights, in training
    with dropout on its entries and renormalised to sum 1, and its sum of
    the logits."""
    prs = torch.softmax(gating_weights, dim=-1)
    if training and dropout_rate > 0.0:
        keep = torch.rand(prs.shape, generator=gen, device=prs.device) < 1.0 - dropout_rate
        prs = torch.where(keep, prs / (1.0 - dropout_rate), 0.0)
        prs = prs / prs.sum(-1, keepdim=True).clamp_min(eps)
    return prs, (prs * logits).sum(-1)


def _dense(in_dim: int, out_dim: int, gen: Optional[torch.Generator], use_bias: bool = True) -> Dense:
    """A flax Dense with xavier-uniform kernel and zero bias."""
    d = Dense(in_dim, out_dim, gen, use_bias=use_bias)
    with torch.no_grad():
        xavier_uniform(d.kernel, gen)
    return d


class _ProjMLP(nn.Module):
    """Dropout -> SwiGLU(hidden) -> Dense(out)."""

    def __init__(
        self, in_dim: int, hidden_dim: int, output_dim: int, dropout_rate: float,
        gen: Optional[torch.Generator],
    ) -> None:
        super().__init__()
        self.dropout_rate = dropout_rate
        self.glu = SwiGLU(in_dim, hidden_dim, gen)
        self.out = _dense(hidden_dim, output_dim, gen)

    def forward(self, x: torch.Tensor, deterministic: bool, gen: Optional[torch.Generator]) -> torch.Tensor:
        if not deterministic:
            x = dropout(x, self.dropout_rate, gen)
        return self.out(self.glu(x))


class _GatingMLP(nn.Module):
    """Dense(hidden) -> SiLU -> Dense(out); without a hidden layer one Dense."""

    def __init__(
        self, in_dim: int, hidden_dim: int, output_dim: int, gen: Optional[torch.Generator],
        out_bias: bool = True,
    ) -> None:
        super().__init__()
        self.fc1 = _dense(in_dim, hidden_dim, gen) if hidden_dim > 0 else None
        self.fc2 = _dense(hidden_dim if hidden_dim > 0 else in_dim, output_dim, gen, out_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fc1 is not None:
            x = torch.nn.functional.silu(self.fc1(x))
        return self.fc2(x)


class MoLSimilarity(nn.Module):
    """(query [B, Dq], items [1 or B, X, Di]) -> (logits [B, X], aux losses).
    The weights are drawn from ``gen``."""

    def __init__(self, config: MoLConfig, gen: Optional[torch.Generator] = None) -> None:
        super().__init__()
        cfg = self.config = config
        self._n_emb_groups = cfg.query_dot_product_groups - len(cfg.uid_embedding_hash_sizes)
        d, E = cfg.dot_product_dimension, cfg.num_logits
        self.query_proj = _ProjMLP(
            cfg.query_embedding_dim, cfg.query_hidden_dim, d * self._n_emb_groups,
            cfg.query_dropout_rate, gen,
        )
        self.item_proj = _ProjMLP(
            cfg.item_embedding_dim, cfg.item_hidden_dim, d * cfg.item_dot_product_groups,
            cfg.item_dropout_rate, gen,
        )
        for i, hash_size in enumerate(cfg.uid_embedding_hash_sizes):
            self.register_parameter(f"uid_embeddings_{i}", new_param((hash_size + 1, d), normal(1.0), gen))
        self.gating_query = (
            _GatingMLP(cfg.query_embedding_dim, cfg.gating_query_hidden_dim, E, gen, out_bias=False)
            if cfg.gating_query_fn else None
        )
        self.gating_item = (
            _GatingMLP(cfg.item_embedding_dim, cfg.gating_item_hidden_dim, E, gen, out_bias=False)
            if cfg.gating_item_fn else None
        )
        self.gating_qi = _GatingMLP(E, cfg.gating_qi_hidden_dim, E, gen)

    def _l2(self, x: torch.Tensor) -> torch.Tensor:
        # x / max(||x||, eps) as the JAX package writes it: the squared sum is
        # clamped, not the norm, which gives another gradient at the clamp
        # than F.normalize
        sq = (x * x).sum(-1, keepdim=True)
        return x * torch.rsqrt(sq.clamp_min(self.config.eps**2))

    # ------------------------------------------------------------ components
    def query_components(
        self,
        query_embeddings: torch.Tensor,  # [B, Dq]
        user_ids: Optional[torch.Tensor],  # int[B]
        deterministic: bool,
        gen: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The query's components [B, P_Q, d]: the projection's groups, then
        one row of each uid table (hashed by ``(uid % size) + 1``)."""
        cfg = self.config
        B = query_embeddings.shape[0]
        aux: Dict[str, torch.Tensor] = {}
        q_comp = self.query_proj(query_embeddings, deterministic, gen).reshape(
            B, self._n_emb_groups, cfg.dot_product_dimension
        )
        if cfg.uid_embedding_hash_sizes:
            if user_ids is None:
                raise ValueError("MoL with uid embeddings needs user_ids")
            parts = [q_comp]
            for i, hash_size in enumerate(cfg.uid_embedding_hash_sizes):
                uid_emb = getattr(self, f"uid_embeddings_{i}")[(user_ids.long() % hash_size) + 1]
                if not deterministic:
                    l2 = (uid_emb * uid_emb).sum(-1).mean()
                    aux["uid_embedding_l2_norm"] = aux.get("uid_embedding_l2_norm", 0.0) + l2
                    if cfg.uid_dropout_rate > 0.0:
                        shape = (B, 1) if cfg.uid_embedding_level_dropout else tuple(uid_emb.shape)
                        keep = torch.rand(shape, generator=gen, device=uid_emb.device) < 1.0 - cfg.uid_dropout_rate
                        uid_emb = torch.where(keep, uid_emb / (1.0 - cfg.uid_dropout_rate), 0.0)
                parts.append(uid_emb[:, None, :])
            q_comp = torch.cat(parts, dim=1)
        if cfg.dot_product_l2_norm:
            q_comp = self._l2(q_comp)
        return q_comp, aux

    def item_components(
        self,
        item_embeddings: torch.Tensor,  # [..., Di]
        deterministic: bool = True,
        gen: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """The items' components [..., P_X, d]."""
        cfg = self.config
        i_comp = self.item_proj(item_embeddings, deterministic, gen).reshape(
            *item_embeddings.shape[:-1], cfg.item_dot_product_groups, cfg.dot_product_dimension
        )
        return self._l2(i_comp) if cfg.dot_product_l2_norm else i_comp

    def gating_item_partial(self, item_embeddings: torch.Tensor) -> Optional[torch.Tensor]:
        """The item gate [..., E], or None without one."""
        return None if self.gating_item is None else self.gating_item(item_embeddings)

    # --------------------------------------------------------------- scoring
    def score_components(
        self,
        query_embeddings: torch.Tensor,  # [B, Dq]: raw, for the query gate
        q_comp: torch.Tensor,  # [B, P_Q, d]
        i_comp: torch.Tensor,  # [1 or B, X, P_X, d]
        gi: Optional[torch.Tensor],  # [1 or B, X, E]: the item gate
        deterministic: bool,
        gen: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(combined logits [B, X], aux): in training ``mi_loss``."""
        cfg = self.config
        B, X, E = q_comp.shape[0], i_comp.shape[1], cfg.num_logits
        if i_comp.shape[0] == 1:
            logits = torch.einsum("bnd,xmd->bxnm", q_comp, i_comp[0])
        else:
            logits = torch.einsum("bnd,bxmd->bxnm", q_comp, i_comp)
        logits = logits.reshape(B, X, E) / cfg.temperature
        gq = None if self.gating_query is None else self.gating_query(query_embeddings)[:, None, :]
        gqi = self.gating_qi(logits)
        kind = cfg.gating_combination_type
        if kind == "glu_silu":
            gate_in = gq * gi + gqi
            gating_weights = gate_in * torch.sigmoid(gate_in)
        elif kind == "glu_silu_ln":
            gate_in = gq * gi + gqi
            gating_weights = gate_in * torch.sigmoid(layer_norm(gate_in))
        elif kind == "none":
            gating_weights = gqi
            if gq is not None:
                gating_weights = gating_weights + gq
            if gi is not None:
                gating_weights = gating_weights + gi
        else:
            raise ValueError(f"Unknown combination_type {kind}")
        prs, combined = softmax_dropout_combiner(
            gating_weights, logits, cfg.softmax_dropout_rate, gen,
            training=not deterministic, eps=cfg.eps,
        )
        aux: Dict[str, torch.Tensor] = {}
        if not deterministic:
            aux["mi_loss"] = load_balancing_mi_loss(prs, cfg.eps)
        return combined, aux

    def forward(
        self,
        query_embeddings: torch.Tensor,  # [B, Dq]
        item_embeddings: torch.Tensor,  # [1 or B, X, Di]
        user_ids: Optional[torch.Tensor] = None,  # int[B]
        deterministic: bool = True,
        gen: Optional[torch.Generator] = None,  # the dropout masks' generator
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        q_comp, aux = self.query_components(query_embeddings, user_ids, deterministic, gen)
        i_comp = self.item_components(item_embeddings, deterministic, gen)
        gi = self.gating_item_partial(item_embeddings)
        logits, score_aux = self.score_components(
            query_embeddings, q_comp, i_comp, gi, deterministic, gen
        )
        return logits, {**aux, **score_aux}
