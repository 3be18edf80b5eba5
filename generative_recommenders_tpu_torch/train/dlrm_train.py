"""DLRM-v3 ranker training and eval loops, on one device or on a mesh (port of
`generative_recommenders_tpu/train/dlrm_train.py`).

A step is: zero the gradients, forward with dropout (and stochastic depth)
on, sum the per-task losses, backward (through the HSTU attention kernels on
the card), give every parameter without a gradient a zero one (a layer that
stochastic depth skipped), then step the row-wise Adagrad of the tables and
the Adam of the rest.

Each step's random draws come from generators seeded by (seed, stream,
step): the dropout masks on the model's device, stochastic depth's coins on
the host. So a run resumed from a checkpoint draws what an uninterrupted run
draws at the same step, as the JAX trainer's ``fold_in(rng, step)`` does
(the masks themselves differ from the JAX package's: the two random
streams differ).

With ``ckpt_dir`` the loop restores the model's parameters (tables
included) from the latest checkpoint there before its first step, saves
them every ``save_every`` steps and once at the end (`utils/checkpoint.py`);
the optimizers' state is not saved, as in the JAX package. Every
checkpoint is numbered by the count of steps trained before it, and a
restored trainer goes on from that count, so a run resumed from any
checkpoint draws what an uninterrupted run draws. (The JAX loop writes the
state after step s under s, one step behind its end-of-run checkpoint's
numbering.) Unlike the JAX loop, a resumed run numbers its steps and
checkpoints on from the restored one's number, so that the latest
checkpoint stays the newest. With ``output_trace`` the loop runs
`utils/profiling.Profiler` (steps 30 to 34 of the run, as a Chrome trace
under ``tmp/trace``).

With a ``mesh`` (`parallel/mesh.py`) each rank trains on its own rows of
the global batch. Its tables are row-sharded over the model axis and read
through the all-to-all exchange (`parallel/embedding.py:sharded_lookup`);
row-wise Adagrad steps each shard alone, which is exact because the rule
reads each row alone. A table that does not divide the model axis stays
whole. Each rank's loss is its share of the global batch's (the losses
divide by the global weight sums), so the gradients are summed, not
averaged: after the backward every dense gradient and every whole table's
is all-reduced over the world, the dense ones flattened into one buffer in
a fixed order (with the loss, so every rank reports the global loss), then
each whole table in order. This is explicit rather than DDP's reducer: a
layer that stochastic depth skipped gets its zero gradient after the
backward, and the STU recompute policy computes gradients outside the graph
that DDP hooks. Stochastic depth's coins are drawn alike on every rank
(every rank skips the same layer); the dropout masks are seeded by (seed,
stream, step, rank), where the JAX trainer draws the global batch's masks,
so the two agree only with dropout off. Predictions, labels and weights
come back gathered in rank order. A checkpoint holds the whole tables in a
one-rank run's format: rank 0 gathers the shards and writes, and a restore
takes each rank's rows of the file.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from generative_recommenders_tpu_torch.data.dataset import background_prefetch
from generative_recommenders_tpu_torch.modules.dlrm_hstu import (
    DlrmHSTU,
    DlrmHSTUConfig,
    EmbeddingTableConfig,
)
from generative_recommenders_tpu_torch.parallel.distributed import (
    all_gather_tensor,
    sharded_batch,
    sum_gradients,
)
from generative_recommenders_tpu_torch.parallel.embedding import sharded_lookup
from generative_recommenders_tpu_torch.parallel.mesh import Mesh
from generative_recommenders_tpu_torch.parallel.optimizers import make_dlrm_optimizer
from generative_recommenders_tpu_torch.parallel.sharding import shard_rows, shard_tables
from generative_recommenders_tpu_torch.train.dlrm_metrics import MetricsLogger
from generative_recommenders_tpu_torch.utils.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from generative_recommenders_tpu_torch.utils.profiling import Profiler, span
from generative_recommenders_tpu_torch.utils.tb import SummaryLogger

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class DlrmTrainConfig:
    """The learning rates, how often `train_loop` logs, where it writes
    TensorBoard scalars (None: nowhere) and checkpoints (None: nowhere;
    ``save_every`` steps, 0 = only at the end), and whether it writes a
    trace. The batch size and the number of steps are
    those of the batches the loop is given."""

    dense_lr: float = 1e-3
    sparse_lr: float = 0.01
    log_every: int = 10
    ckpt_dir: Optional[str] = None
    save_every: int = 0
    output_trace: bool = False
    tb_log_dir: Optional[str] = None


def to_device(batch: Tuple, device: torch.device) -> Tuple:
    """A numpy (uih_features, uih_lengths, cand_features, num_candidates)
    batch as tensors on ``device``."""
    uih, ul, cands, nc = batch
    t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    return {k: t(v) for k, v in uih.items()}, t(ul), {k: t(v) for k, v in cands.items()}, t(nc)


# the streams of a step's generators
_DROPOUT, _STOCHASTIC_DEPTH = 0, 1


def step_seed(seed: int, stream: int, step: int, rank: int = 0) -> int:
    """A 63-bit seed for one stream of one step on one rank (rank 0 draws
    what a run without a mesh draws)."""
    key = [seed, stream, step] + ([rank] if rank else [])
    return int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0] >> 1)


class DlrmTrainer:
    """Owns the model and its two optimizers on ``device`` ("cuda" unless
    the caller asks for the CPU; without a card it raises). The weights are
    drawn from ``seed`` (alike on every rank of a ``mesh``), each step's
    dropout masks and stochastic-depth coins from generators seeded by
    (``seed``, stream, step)."""

    def __init__(
        self,
        hstu_cfg: DlrmHSTUConfig,
        tables: Tuple[EmbeddingTableConfig, ...],
        cfg: DlrmTrainConfig,
        device: str = "cuda",
        seed: int = 0,
        mesh: Optional[Mesh] = None,
    ) -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            # never a silent fall back to the CPU
            raise RuntimeError("no CUDA device is available; train on the CPU with device='cpu'")
        self.mesh = mesh
        with torch.device(self.device):
            self.model = DlrmHSTU(hstu_cfg, tables, torch.Generator(self.device).manual_seed(seed))
        self.sharded: Tuple[str, ...] = ()
        if mesh is not None:
            self.sharded = shard_tables(self.model, [f"embedding_tables_{t.name}" for t in tables], mesh)
            shards = {id(p) for n, p in self.model.named_parameters() if n in self.sharded}
            if shards:
                # the sharded tables through the exchange, a whole one locally
                self.model.lookup_fn = lambda table, ids: (
                    sharded_lookup(table, ids, mesh) if id(table) in shards else table[ids]
                )
        self.cfg = cfg
        self.hstu_cfg = hstu_cfg
        self.seed = seed
        self.step = 0  # the number of the next training step
        self.sparse_opt, self.dense_opt = make_dlrm_optimizer(
            self.model, dense_lr=cfg.dense_lr, sparse_lr=cfg.sparse_lr
        )

    @property
    def rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.rank

    def generators(self, step: int) -> Tuple[torch.Generator, torch.Generator]:
        """(the dropout's generator on the model's device, stochastic depth's
        on the host) of training step ``step``; the dropout's differs by
        rank, stochastic depth's does not."""
        return (
            torch.Generator(self.device).manual_seed(step_seed(self.seed, _DROPOUT, step, self.rank)),
            torch.Generator().manual_seed(step_seed(self.seed, _STOCHASTIC_DEPTH, step)),
        )

    def loss(self, batch: Tuple, deterministic: bool = False):
        """(the sum of the per-task losses, preds, labels, weights); a
        training forward draws from the next step's generators."""
        uih, ul, cands, nc = batch
        gen = sd_gen = None
        if not deterministic:
            gen, sd_gen = self.generators(self.step)
        with sharded_batch() if self.mesh is not None else contextlib.nullcontext():
            _, _, aux_losses, preds, labels, weights = self.model(
                uih, ul, cands, nc, deterministic=deterministic, compute_losses=True,
                gen=gen, sd_gen=sd_gen,
            )
        return sum(aux_losses.values()), preds, labels, weights

    def train_step(self, batch: Tuple):
        """One optimizer step on a device batch (this rank's rows); returns
        (loss, preds, labels, weights), detached, of the global batch."""
        self.sparse_opt.zero_grad(set_to_none=True)
        self.dense_opt.zero_grad(set_to_none=True)
        loss, preds, labels, weights = self.loss(batch)
        with span("train.backward"):
            loss.backward()
        for p in self.model.parameters():
            if p.grad is None:  # a layer stochastic depth skipped: optax sees zeros
                p.grad = torch.zeros_like(p)
        loss = loss.detach()
        if self.mesh is not None:
            loss = self._sum_gradients(loss)
        self.sparse_opt.step()
        self.dense_opt.step()
        self.step += 1
        return (loss,) + self._gathered(preds.detach(), labels, weights)

    def _sum_gradients(self, loss: torch.Tensor) -> torch.Tensor:
        """Sums every gradient but the table shards' (the exchange summed
        those) over the world; returns the global loss."""
        named = [(n, p) for n, p in self.model.named_parameters() if n not in self.sharded]
        is_table = lambda n: n.startswith("embedding_tables_")  # noqa: E731
        return sum_gradients([p for n, p in named if not is_table(n)], [p for n, p in named if is_table(n)], loss)

    def _gathered(self, preds, labels, weights):
        """[T, B, M] tensors of this rank's rows as the global batch's."""
        if self.mesh is None:
            return preds, labels, weights
        return tuple(all_gather_tensor(t.contiguous(), dim=1) for t in (preds, labels, weights))

    def restore(self, ckpt_dir: str, step: Optional[int] = None) -> None:
        """Loads the model's parameters from a checkpoint (default: the
        latest under ``ckpt_dir``); training goes on from the checkpoint's
        step number."""
        step = latest_step(ckpt_dir) if step is None else step
        state = restore_checkpoint(ckpt_dir, self.device, step)
        for name in self.sharded:
            state[name] = shard_rows(state[name], self.mesh)
        self.model.load_state_dict(state)
        self.step = step

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's parameters with every table whole (gathered from its
        shards: a collective, every rank calls it)."""
        state = self.model.state_dict()
        for name in self.sharded:
            state[name] = all_gather_tensor(state[name], self.mesh.model_group)
        return state

    def save(self, ckpt_dir: str) -> None:
        """Writes the checkpoint of the steps trained so far: rank 0 writes,
        every rank calls it."""
        state = self.state_dict()
        if self.rank == 0:
            save_checkpoint(ckpt_dir, state, self.step)

    @torch.no_grad()
    def eval_step(self, batch: Tuple):
        """(preds, labels, weights) of the global batch, without dropout."""
        return self._gathered(*self.loss(batch, deterministic=True)[1:])


def train_loop(trainer: DlrmTrainer, batches: Iterator[Tuple]) -> Dict[str, Any]:
    """Trains on every batch of ``batches`` (numpy, made on a background
    thread), from the latest checkpoint under ``cfg.ckpt_dir`` if there is
    one. Returns the metrics, ``examples_per_s``, and each step's loss and
    wall time (``losses``, ``step_s``; a step ends when its predictions
    reach the host for the metrics). ``examples_per_s`` counts the examples
    of the steps after the first over the time from the first step's end to
    the last's, so that the prefetch thread's start and the first step's
    warm-up stay out; a loop of one step counts its examples over the whole
    loop."""
    cfg = trainer.cfg
    # a resumed run numbers its steps and checkpoints on from the one it restored
    if cfg.ckpt_dir and latest_step(cfg.ckpt_dir) is not None:
        trainer.restore(cfg.ckpt_dir)
        logger.info("restored checkpoint %d from %s", trainer.step, cfg.ckpt_dir)
    metrics = MetricsLogger(trainer.hstu_cfg.multitask_configs)
    tb = SummaryLogger(cfg.tb_log_dir)
    profiler = Profiler() if cfg.output_trace else None
    losses, step_s = [], []
    saved = None  # the step of the last checkpoint this run wrote
    n_examples = n_first = 0  # the examples of every step, of the first
    t0 = time.perf_counter()
    t_first = t_last = t0  # the ends of the first and the last step
    for step, raw in enumerate(background_prefetch(batches, size=8)):
        t_step = time.perf_counter()
        loss, preds, labels, weights = trainer.train_step(to_device(raw, trainer.device))
        metrics.update(preds, labels, weights)
        losses.append(float(loss))
        t_last = time.perf_counter()
        step_s.append(t_last - t_step)
        n_examples += int(raw[1].shape[0]) * (1 if trainer.mesh is None else trainer.mesh.size)
        if step == 0:
            t_first, n_first = t_last, n_examples
        if profiler is not None:
            profiler.step()
        if step % cfg.log_every == 0:
            logger.info(
                "step %d: loss %.5f (%.1f ex/s)",
                step, losses[-1], n_examples / (time.perf_counter() - t0),
            )
            tb.scalar("losses/total", losses[-1], step)
            tb.scalars(metrics.compute_and_log(step), step, prefix="train/")
        if cfg.ckpt_dir and cfg.save_every and trainer.step % cfg.save_every == 0:
            trainer.save(cfg.ckpt_dir)
            saved = trainer.step
    if profiler is not None:
        profiler.close()
    if cfg.ckpt_dir and saved != trainer.step:
        trainer.save(cfg.ckpt_dir)
    tb.close()
    if len(losses) > 1:
        examples_per_s = (n_examples - n_first) / (t_last - t_first)
    else:
        examples_per_s = n_examples / (time.perf_counter() - t0)
    return {
        "metrics": metrics.compute(),
        "examples_per_s": examples_per_s,
        "losses": losses,
        "step_s": step_s,
        "trace_paths": [] if profiler is None else profiler.paths,
    }


def eval_loop(trainer: DlrmTrainer, batches: Iterator[Tuple]) -> Dict[str, float]:
    metrics = MetricsLogger(trainer.hstu_cfg.multitask_configs)
    for raw in batches:
        metrics.update(*trainer.eval_step(to_device(raw, trainer.device)))
    return metrics.compute()
