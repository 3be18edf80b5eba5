"""DLRM-v3 ranker training and eval loops on one device (port of
`generative_recommenders_tpu/train/dlrm_train.py`).

A step is: zero the gradients, forward with dropout on, sum the per-task
losses, backward (through the HSTU attention kernels on the card), then
step the row-wise Adagrad of the tables and the Adam of the rest.

With ``ckpt_dir`` the loop restores the model's parameters (tables
included) from the latest checkpoint there before its first step, saves them
every ``save_every`` steps and once at the end (`utils/checkpoint.py`); the
optimizers' state is not saved, as in the JAX package. Unlike the JAX loop,
a resumed run numbers its checkpoints on from the restored one's step, so
that the latest checkpoint stays the newest. Not ported yet: the
device mesh and the sharded table lookup (`sharded_lookup`), multi-host
batches (`_to_global`) and the profiler. The JAX trainer folds the step number into its dropout key
(`jax.random.fold_in`); here one `torch.Generator`, seeded once, advances
from step to step instead, so a run is reproducible from its seed but does
not draw the JAX package's masks.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, Iterator, Optional, Tuple

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
from generative_recommenders_tpu_torch.utils.tb import SummaryLogger

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class DlrmTrainConfig:
    """The learning rates, how often `train_loop` logs, where it writes
    TensorBoard scalars (None: nowhere) and checkpoints (None: nowhere;
    ``save_every`` steps, 0 = only at the end). The batch size and the
    number of steps are those of the batches the loop is given."""

    dense_lr: float = 1e-3
    sparse_lr: float = 0.01
    log_every: int = 10
    ckpt_dir: Optional[str] = None
    save_every: int = 0
    tb_log_dir: Optional[str] = None


def to_device(batch: Tuple, device: torch.device) -> Tuple:
    """A numpy (uih_features, uih_lengths, cand_features, num_candidates)
    batch as tensors on ``device``."""
    uih, ul, cands, nc = batch
    t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    return {k: t(v) for k, v in uih.items()}, t(ul), {k: t(v) for k, v in cands.items()}, t(nc)


class DlrmTrainer:
    """Owns the model, its two optimizers and the dropout generator, on
    ``device`` ("cuda" unless the caller asks for the CPU; without a card
    it raises). The weights are drawn from ``seed``, the dropout masks
    from ``seed + 1``."""

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
        self.sparse_opt, self.dense_opt = make_dlrm_optimizer(
            self.model, dense_lr=cfg.dense_lr, sparse_lr=cfg.sparse_lr
        )
        self.dropout_gen = torch.Generator(self.device).manual_seed(seed + 1)

    def loss(self, batch: Tuple, deterministic: bool = False):
        """(the sum of the per-task losses, preds, labels, weights)."""
        uih, ul, cands, nc = batch
        _, _, aux_losses, preds, labels, weights = self.model(
            uih, ul, cands, nc, deterministic=deterministic, compute_losses=True,
            gen=self.dropout_gen,
        )
        return sum(aux_losses.values()), preds, labels, weights

    def train_step(self, batch: Tuple):
        """One optimizer step on a device batch; returns (loss, preds,
        labels, weights), detached."""
        self.sparse_opt.zero_grad(set_to_none=True)
        self.dense_opt.zero_grad(set_to_none=True)
        loss, preds, labels, weights = self.loss(batch)
        loss.backward()
        self.sparse_opt.step()
        self.dense_opt.step()
        return loss.detach(), preds.detach(), labels, weights

    def restore(self, ckpt_dir: str, step: Optional[int] = None) -> None:
        """Loads the model's parameters from a checkpoint (default: the
        latest under ``ckpt_dir``)."""
        self.model.load_state_dict(restore_checkpoint(ckpt_dir, self.device, step))

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
    # a resumed run numbers its checkpoints on from the one it restored
    start = (latest_step(cfg.ckpt_dir) if cfg.ckpt_dir else None) or 0
    if cfg.ckpt_dir and latest_step(cfg.ckpt_dir) is not None:
        trainer.restore(cfg.ckpt_dir)
        logger.info("restored checkpoint %d from %s", start, cfg.ckpt_dir)
    metrics = MetricsLogger(trainer.hstu_cfg.multitask_configs)
    tb = SummaryLogger(cfg.tb_log_dir)
    losses, step_s = [], []
    n_examples = 0
    t0 = time.time()
    step = -1
    for step, raw in enumerate(background_prefetch(batches, size=8)):
        t_step = time.perf_counter()
        loss, preds, labels, weights = trainer.train_step(to_device(raw, trainer.device))
        metrics.update(preds, labels, weights)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t_step)
        n_examples += int(raw[1].shape[0])
        if step % cfg.log_every == 0:
            logger.info(
                "step %d: loss %.5f (%.1f ex/s)",
                step, losses[-1], n_examples / (time.time() - t0),
            )
            tb.scalar("losses/total", losses[-1], step)
            tb.scalars(metrics.compute_and_log(step), step, prefix="train/")
        if cfg.ckpt_dir and cfg.save_every and step and step % cfg.save_every == 0:
            save_checkpoint(cfg.ckpt_dir, trainer.model.state_dict(), start + step)
    if cfg.ckpt_dir:
        save_checkpoint(cfg.ckpt_dir, trainer.model.state_dict(), start + step + 1)
    tb.close()
    return {
        "metrics": metrics.compute(),
        "examples_per_s": n_examples / (time.time() - t0),
        "losses": losses,
        "step_s": step_s,
    }


def eval_loop(trainer: DlrmTrainer, batches: Iterator[Tuple]) -> Dict[str, float]:
    metrics = MetricsLogger(trainer.hstu_cfg.multitask_configs)
    for raw in batches:
        metrics.update(*trainer.eval_step(to_device(raw, trainer.device)))
    return metrics.compute()
