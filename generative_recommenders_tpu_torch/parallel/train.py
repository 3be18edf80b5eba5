"""The research trainer on a mesh (port of
`generative_recommenders_tpu/parallel/train.py`).

Each rank trains on its contiguous rows of every global batch. On a mesh
with a model axis the item table is row-sharded (when its rows divide the
axis) and every batch-shaped lookup goes through the all-to-all exchange
(`parallel/embedding.py:sharded_lookup`), so no rank holds or gathers the
whole table during a step. AdamW steps the shard alone, which is exact
because its update is elementwise. The losses divide by the global batch's
weights, the in-batch negatives' pool is the global batch's and MoL's load
balancing reads the global utilisation (`parallel/distributed.py:batch_sum`,
`batch_rows`), so each rank's loss is its share of the global loss, and
every gradient but the table shard's is summed over the world after the
backward. The eval gathers the table's shards for the corpus' embeddings
(GSPMD does the same in the JAX package) and every rank's ranks, so each
rank computes the global batch's metrics.

Each rank's dropout masks, stochastic lengths and negatives come from its
own generators (rank 0's are a run without a mesh's); the JAX trainer draws
them for the global batch.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import numpy as np
import torch

from generative_recommenders_tpu_torch.data.dataset import SequenceDataset
from generative_recommenders_tpu_torch.models.embeddings import lookup_rows
from generative_recommenders_tpu_torch.models.samplers import maybe_l2_norm
from generative_recommenders_tpu_torch.parallel.distributed import (
    all_gather_tensor,
    sharded_batch,
    sum_gradients,
)
from generative_recommenders_tpu_torch.parallel.embedding import sharded_lookup
from generative_recommenders_tpu_torch.parallel.mesh import Mesh, make_mesh
from generative_recommenders_tpu_torch.parallel.sharding import rank_rows, shard_rows, shard_tables
from generative_recommenders_tpu_torch.train.train_loop import ResearchTrainer, TrainConfig, run_epochs
from generative_recommenders_tpu_torch.utils.checkpoint import save_checkpoint

logger = logging.getLogger(__name__)

_TABLE = "embedding_module.item_emb"
_ADAMW_MOMENTS = ("exp_avg", "exp_avg_sq")


def rank_seed(seed: int, rank: int) -> int:
    """A generator's seed on one rank; rank 0 keeps ``seed``."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(1, np.uint64)[0] >> 1)


class DistributedTrainer(ResearchTrainer):
    """`ResearchTrainer` for one rank of ``mesh``."""

    def __init__(self, cfg: TrainConfig, all_item_ids: np.ndarray, mesh: Mesh, device: str = "cuda") -> None:
        super().__init__(cfg, all_item_ids, device=device)
        self.mesh = mesh
        seed = cfg.random_seed
        self.dropout_gen.manual_seed(rank_seed(seed + 1, mesh.rank))
        self.negatives_gen.manual_seed(rank_seed(seed + 2, mesh.rank))
        self.length_gen.manual_seed(rank_seed(self.length_gen.initial_seed(), mesh.rank))
        self.sharded = shard_tables(self.model, [_TABLE], mesh)
        if self.sharded:
            self.model.embedding_module.lookup_fn = lambda table, ids: sharded_lookup(table, ids, mesh)

    # ------------------------------------------------------------- train step
    def train_step(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        """One optimizer step on this rank's rows; returns the global loss."""
        cfg = self.cfg
        if (cfg.seq_len_buckets or cfg.runtime_bucketing) and self.mesh.size > 1:
            # as the JAX trainer refuses them in multi-process training
            raise ValueError(
                "seq_len_buckets/runtime_bucketing are unsupported on a mesh of several ranks: bucket widths "
                "computed from each rank's rows would diverge across ranks"
            )
        return super().train_step(batch)

    def _batch_scope(self):
        return sharded_batch()

    def _sum_gradients(self, loss: torch.Tensor) -> torch.Tensor:
        named = [(n, p) for n, p in self.model.named_parameters() if n not in self.sharded]
        return sum_gradients([p for n, p in named if n != _TABLE], [p for n, p in named if n == _TABLE], loss)

    def to_global_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """This rank's rows ``[k b, (k + 1) b)`` of a global batch (the JAX
        trainer assembles global arrays from them; here each rank keeps its
        slice)."""
        return rank_rows(batch, self.mesh.size, self.mesh.rank)

    # -------------------------------------------------------------- eval step
    def _whole_table(self) -> torch.Tensor:
        table = self.model.embedding_module.item_emb.detach()
        return all_gather_tensor(table, self.mesh.model_group) if self.sharded else table

    @torch.no_grad()
    def item_embeddings(self) -> torch.Tensor:
        """The corpus' embeddings from the whole table (the shards
        gathered)."""
        if not self.sharded:
            return super().item_embeddings()
        ids = self.all_item_ids
        embs = lookup_rows(self._whole_table(), ids, self.cfg.model.num_items, None)
        embs = embs * (ids != 0)[..., None].to(embs.dtype)
        return maybe_l2_norm(embs, self.cfg.item_l2_norm, self.cfg.l2_norm_eps)

    @torch.no_grad()
    def encode_step(self, batch: Dict[str, np.ndarray], item_embs: torch.Tensor):
        """The global batch's (ranks, target ratings), every rank's rows in
        rank order."""
        ranks, ratings = super().encode_step(batch, item_embs)
        return all_gather_tensor(ranks), all_gather_tensor(ratings)

    # ------------------------------------------------------------ checkpoint
    def _table_index(self) -> int:
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        table = self.model.embedding_module.item_emb
        return next(i for i, p in enumerate(params) if p is table)

    def checkpoint_state(self) -> Dict[str, Any]:
        """A one-rank run's ``{params, opt_state}``: the table and its AdamW
        moments gathered whole (a collective, every rank calls it)."""
        state = super().checkpoint_state()
        if self.sharded:
            state["params"][_TABLE] = self._whole_table()
            self._map_moments(state, lambda t: all_gather_tensor(t, self.mesh.model_group))
        return state

    def _map_moments(self, state: Dict[str, Any], fn) -> None:
        """Replaces the table's AdamW moments in ``state`` by ``fn`` of them
        (a new dict: the optimizer's own is left as it is)."""
        opt = state["opt_state"]["adamw"]["state"]
        i = self._table_index()
        if i in opt:
            opt[i] = {k: fn(v) if k in _ADAMW_MOMENTS else v for k, v in opt[i].items()}

    def save(self, ckpt_dir: str, step: int) -> None:
        """Rank 0 writes the gathered state; every rank calls it."""
        state = self.checkpoint_state()
        if self.mesh.rank == 0:
            save_checkpoint(ckpt_dir, state, step)

    def load_checkpoint_state(self, state: Dict[str, Any]) -> None:
        """Restores a one-rank checkpoint, keeping this rank's rows of the
        table and of its moments."""
        if self.sharded:
            state["params"][_TABLE] = shard_rows(state["params"][_TABLE], self.mesh)
            self._map_moments(state, lambda t: shard_rows(t, self.mesh))
        super().load_checkpoint_state(state)


def distributed_train_loop(
    cfg: TrainConfig,
    train_dataset: SequenceDataset,
    eval_dataset: SequenceDataset,
    mesh: Optional[Mesh] = None,
    log_every: int = 100,
    max_steps: Optional[int] = None,
    tb_log_dir: Optional[str] = None,
    ckpt_dir: Optional[str] = None,
    save_ckpt_every_n: int = 0,
    device: str = "cuda",
) -> Dict[str, Any]:
    """`train_loop` on every rank of ``mesh`` (default: every rank on the
    data axis). ``cfg.local_batch_size`` and ``cfg.eval_batch_size`` are the
    global batches' sizes, of which each rank takes its rows; the eval's
    metrics are the global batch's (each rank's ranks gathered), the same on
    every rank. Rank 0 writes the TensorBoard scalars and the checkpoints.
    (The JAX loop caps every eval at ``partial_eval_num_iters`` batches;
    this one evaluates as `train_loop` does.)"""
    mesh = mesh or make_mesh()
    if cfg.local_batch_size % mesh.size or cfg.eval_batch_size % mesh.size:
        raise ValueError(f"the batch sizes of {cfg} do not split over {mesh.size} ranks")
    trainer = DistributedTrainer(cfg, train_dataset.all_item_ids(), mesh, device=device)
    logger.info("rank %d of mesh %s: table %s", mesh.rank, mesh.shape, "sharded" if trainer.sharded else "whole")
    return run_epochs(
        trainer, train_dataset, eval_dataset, log_every, max_steps,
        tb_log_dir if mesh.rank == 0 else None, ckpt_dir, save_ckpt_every_n,
        num_shards=mesh.size, shard_index=mesh.rank,
    )
