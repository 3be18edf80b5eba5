"""DLRM-v3 ranker training and eval loops on one device (port of
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
under ``tmp/trace``). Not ported yet: the device mesh and the sharded
table lookup (`sharded_lookup`) and multi-host batches (`_to_global`).
"""

from __future__ import annotations

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
from generative_recommenders_tpu_torch.parallel.optimizers import make_dlrm_optimizer
from generative_recommenders_tpu_torch.train.dlrm_metrics import MetricsLogger
from generative_recommenders_tpu_torch.utils.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from generative_recommenders_tpu_torch.utils.profiling import Profiler
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


def step_seed(seed: int, stream: int, step: int) -> int:
    """A 63-bit seed for one stream of one step."""
    return int(np.random.SeedSequence([seed, stream, step]).generate_state(1, np.uint64)[0] >> 1)


class DlrmTrainer:
    """Owns the model and its two optimizers on ``device`` ("cuda" unless
    the caller asks for the CPU; without a card it raises). The weights are
    drawn from ``seed``, each step's dropout masks and stochastic-depth
    coins from generators seeded by (``seed``, stream, step)."""

    def __init__(
        self,
        hstu_cfg: DlrmHSTUConfig,
        tables: Tuple[EmbeddingTableConfig, ...],
        cfg: DlrmTrainConfig,
        device: str = "cuda",
        seed: int = 0,
    ) -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            # never a silent fall back to the CPU
            raise RuntimeError("no CUDA device is available; train on the CPU with device='cpu'")
        with torch.device(self.device):
            self.model = DlrmHSTU(hstu_cfg, tables, torch.Generator(self.device).manual_seed(seed))
        self.cfg = cfg
        self.hstu_cfg = hstu_cfg
        self.seed = seed
        self.step = 0  # the number of the next training step
        self.sparse_opt, self.dense_opt = make_dlrm_optimizer(
            self.model, dense_lr=cfg.dense_lr, sparse_lr=cfg.sparse_lr
        )

    def generators(self, step: int) -> Tuple[torch.Generator, torch.Generator]:
        """(the dropout's generator on the model's device, stochastic depth's
        on the host) of training step ``step``."""
        return (
            torch.Generator(self.device).manual_seed(step_seed(self.seed, _DROPOUT, step)),
            torch.Generator().manual_seed(step_seed(self.seed, _STOCHASTIC_DEPTH, step)),
        )

    def loss(self, batch: Tuple, deterministic: bool = False):
        """(the sum of the per-task losses, preds, labels, weights); a
        training forward draws from the next step's generators."""
        uih, ul, cands, nc = batch
        gen = sd_gen = None
        if not deterministic:
            gen, sd_gen = self.generators(self.step)
        _, _, aux_losses, preds, labels, weights = self.model(
            uih, ul, cands, nc, deterministic=deterministic, compute_losses=True,
            gen=gen, sd_gen=sd_gen,
        )
        return sum(aux_losses.values()), preds, labels, weights

    def train_step(self, batch: Tuple):
        """One optimizer step on a device batch; returns (loss, preds,
        labels, weights), detached."""
        self.sparse_opt.zero_grad(set_to_none=True)
        self.dense_opt.zero_grad(set_to_none=True)
        loss, preds, labels, weights = self.loss(batch)
        loss.backward()
        for p in self.model.parameters():
            if p.grad is None:  # a layer stochastic depth skipped: optax sees zeros
                p.grad = torch.zeros_like(p)
        self.sparse_opt.step()
        self.dense_opt.step()
        self.step += 1
        return loss.detach(), preds.detach(), labels, weights

    def restore(self, ckpt_dir: str, step: Optional[int] = None) -> None:
        """Loads the model's parameters from a checkpoint (default: the
        latest under ``ckpt_dir``); training goes on from the checkpoint's
        step number."""
        step = latest_step(ckpt_dir) if step is None else step
        self.model.load_state_dict(restore_checkpoint(ckpt_dir, self.device, step))
        self.step = step

    @torch.no_grad()
    def eval_step(self, batch: Tuple):
        """(preds, labels, weights) without dropout."""
        return self.loss(batch, deterministic=True)[1:]


def train_loop(trainer: DlrmTrainer, batches: Iterator[Tuple]) -> Dict[str, Any]:
    """Trains on every batch of ``batches`` (numpy, made on a background
    thread), from the latest checkpoint under ``cfg.ckpt_dir`` if there is
    one. Returns the metrics, ``examples_per_s`` over the whole loop, and
    each step's loss and wall time (``losses``, ``step_s``; a step ends when
    its predictions reach the host for the metrics)."""
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
    n_examples = 0
    t0 = time.time()
    for step, raw in enumerate(background_prefetch(batches, size=8)):
        t_step = time.perf_counter()
        loss, preds, labels, weights = trainer.train_step(to_device(raw, trainer.device))
        metrics.update(preds, labels, weights)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t_step)
        n_examples += int(raw[1].shape[0])
        if profiler is not None:
            profiler.step()
        if step % cfg.log_every == 0:
            logger.info(
                "step %d: loss %.5f (%.1f ex/s)",
                step, losses[-1], n_examples / (time.time() - t0),
            )
            tb.scalar("losses/total", losses[-1], step)
            tb.scalars(metrics.compute_and_log(step), step, prefix="train/")
        if cfg.ckpt_dir and cfg.save_every and trainer.step % cfg.save_every == 0:
            save_checkpoint(cfg.ckpt_dir, trainer.model.state_dict(), trainer.step)
            saved = trainer.step
    if profiler is not None:
        profiler.close()
    if cfg.ckpt_dir and saved != trainer.step:
        save_checkpoint(cfg.ckpt_dir, trainer.model.state_dict(), trainer.step)
    tb.close()
    return {
        "metrics": metrics.compute(),
        "examples_per_s": n_examples / (time.time() - t0),
        "losses": losses,
        "step_s": step_s,
        "trace_paths": [] if profiler is None else profiler.paths,
    }


def eval_loop(trainer: DlrmTrainer, batches: Iterator[Tuple]) -> Dict[str, float]:
    metrics = MetricsLogger(trainer.hstu_cfg.multitask_configs)
    for raw in batches:
        metrics.update(*trainer.eval_step(to_device(raw, trainer.device)))
    return metrics.compute()
