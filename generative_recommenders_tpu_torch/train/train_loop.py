"""Research training loop on one device: train and eval steps and the epoch
loop (port of `generative_recommenders_tpu/train/train_loop.py`).

A train step is: batch -> features, the target scattered into the ids, item
embeddings, the encoder (dropout on; on the card through the attention
kernels), sampled negatives, the loss, backward, AdamW. Eval ranks each
row's target against the whole item corpus.

Ported: ``sampling_strategy="local"`` with `SampledSoftmaxLoss` or
`BCELoss`, AdamW beta = (0.9, 0.98) with the linear warm-up, the mid-epoch
partial eval, ``max_steps`` and TensorBoard scalars. Not ported yet, and
refused by `ResearchTrainer` / `train_loop`: stochastic length, sequence
length buckets, ``loss_activation_checkpoint``, `BCELossWithRatings`,
in-batch negatives, MoL and checkpoints. The JAX trainer folds the step
number into one key for dropout and negatives; here two `torch.Generator`s,
seeded once, advance from step to step, so a run is reproducible from its
seed but does not draw the JAX package's masks and negatives.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from generative_recommenders_tpu_torch.data.dataset import (
    SequenceDataset,
    batch_iterator,
    prefetched_batch_iterator,
)
from generative_recommenders_tpu_torch.data.features import (
    scatter_target_into_ids,
    seq_features_from_row,
)
from generative_recommenders_tpu_torch.models.losses import bce_loss, sampled_softmax_loss
from generative_recommenders_tpu_torch.models.samplers import LocalNegativesSampler, maybe_l2_norm
from generative_recommenders_tpu_torch.models.sequential import ModelConfig, SequentialRecommender
from generative_recommenders_tpu_torch.train.eval_metrics import (
    MAX_K,
    MetricsAccumulator,
    build_id_to_col,
    metrics_from_ranks,
    target_ranks,
)
from generative_recommenders_tpu_torch.utils.tb import SummaryLogger

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Field for field the JAX package's `TrainConfig`, so that its presets
    carry over; the fields of what is not ported must keep their defaults."""

    model: ModelConfig
    local_batch_size: int = 128
    eval_batch_size: int = 128
    num_epochs: int = 101
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    num_warmup_steps: int = 0
    sampling_strategy: str = "local"  # "in-batch" is not ported
    loss_module: str = "SampledSoftmaxLoss"  # | "BCELoss"
    num_negatives: int = 128
    temperature: float = 0.05
    item_l2_norm: bool = True
    l2_norm_eps: float = 1e-6
    eval_interval: int = 100
    full_eval_every_n: int = 1
    partial_eval_num_iters: int = 32
    random_seed: int = 42
    # weights of auxiliary losses, by name; no ported module returns one yet
    loss_weights: Tuple[Tuple[str, float], ...] = ()
    eval_item_chunk_size: int = 8192  # MoL eval only (not ported)
    stochastic_length_alpha: float = 0.0  # not ported; must stay 0
    seq_len_buckets: Tuple[int, ...] = ()  # not ported; must stay empty
    runtime_bucketing: bool = False  # not ported
    # host data pipeline: batch-building threads and their window; 0 = synchronous
    num_workers: int = 4
    prefetch_factor: int = 16
    loss_activation_checkpoint: bool = False  # not ported


def _refuse_unported(cfg: TrainConfig) -> None:
    if cfg.sampling_strategy != "local":
        if cfg.sampling_strategy == "in-batch":
            raise NotImplementedError("sampling_strategy='in-batch' is not ported yet")
        raise ValueError(f"Unknown sampling_strategy {cfg.sampling_strategy}")
    if cfg.loss_module not in ("SampledSoftmaxLoss", "BCELoss"):
        if cfg.loss_module == "BCELossWithRatings":
            raise NotImplementedError("loss_module='BCELossWithRatings' is not ported yet")
        raise ValueError(f"Unknown loss_module {cfg.loss_module}")
    for name, off in (
        ("stochastic_length_alpha", cfg.stochastic_length_alpha == 0.0),
        ("seq_len_buckets", not cfg.seq_len_buckets),
        ("runtime_bucketing", not cfg.runtime_bucketing),
        ("loss_activation_checkpoint", not cfg.loss_activation_checkpoint),
    ):
        if not off:
            raise NotImplementedError(f"{name} is not ported yet")


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


class ResearchTrainer:
    """Owns the model, the optimizer, the sampler and the eval state, on
    ``device`` ("cuda" unless the caller asks for the CPU; without a card it
    raises). The weights are drawn from ``cfg.random_seed``, the dropout
    masks from the seed + 1, the negatives from the seed + 2."""

    def __init__(self, cfg: TrainConfig, all_item_ids: np.ndarray, device: str = "cuda") -> None:
        _refuse_unported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            # never a silent fall back to the CPU
            raise RuntimeError("no CUDA device is available; train on the CPU with device='cpu'")
        seed = cfg.random_seed
        with torch.device(self.device):
            self.model = SequentialRecommender(
                cfg.model, torch.Generator(self.device).manual_seed(seed)
            )
        ids = np.asarray(all_item_ids, dtype=np.int64)
        self.all_item_ids = torch.as_tensor(ids, device=self.device)
        self._id_to_col = torch.as_tensor(
            build_id_to_col(ids, cfg.model.num_items), device=self.device
        )
        self.optimizer = torch.optim.AdamW(
            self.model.parameters(), lr=cfg.learning_rate, betas=(0.9, 0.98), eps=1e-8,
            weight_decay=cfg.weight_decay,
        )
        self.schedule = None
        if cfg.num_warmup_steps > 0:
            # from lr / W at step 0 linearly to lr at step W, then constant
            W = cfg.num_warmup_steps
            self.schedule = torch.optim.lr_scheduler.LambdaLR(
                self.optimizer, lambda s: 1.0 / W + (1.0 - 1.0 / W) * s / W if s < W else 1.0
            )
        self.sampler = LocalNegativesSampler(
            all_item_ids=self.all_item_ids, l2_norm=cfg.item_l2_norm, l2_norm_eps=cfg.l2_norm_eps
        )
        self.dropout_gen = torch.Generator(self.device).manual_seed(seed + 1)
        self.negatives_gen = torch.Generator(self.device).manual_seed(seed + 2)

    # ------------------------------------------------------------- train step
    def loss(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The autoregressive loss of one device batch, dropout on."""
        cfg, model = self.cfg, self.model
        features, target_ids, _ = seq_features_from_row(
            batch, max_output_length=cfg.model.gr_output_length + 1
        )
        past_ids = scatter_target_into_ids(features.past_ids, features.past_lengths, target_ids)
        input_embeddings = model.get_item_embeddings(past_ids)
        seq_embeddings = model(
            features.past_lengths, past_ids, input_embeddings, features.past_payloads,
            deterministic=False, gen=self.dropout_gen,
        )  # [B, N, D]

        output = seq_embeddings[:, :-1, :]
        sup_ids = past_ids[:, 1:]
        sup_emb = input_embeddings[:, 1:, :]
        ar_mask = (sup_ids != 0).float()
        neg_ids, neg_emb = self.sampler(
            self.negatives_gen, sup_ids,
            1 if cfg.loss_module == "BCELoss" else cfg.num_negatives,
            model.get_item_embeddings,
        )
        pos_emb = maybe_l2_norm(sup_emb, cfg.item_l2_norm, cfg.l2_norm_eps)
        if cfg.loss_module == "SampledSoftmaxLoss":
            loss, aux = sampled_softmax_loss(
                output, pos_emb, sup_ids, ar_mask, neg_ids, neg_emb,
                softmax_temperature=cfg.temperature,
            )
        else:
            loss, aux = bce_loss(
                output, pos_emb, sup_ids, ar_mask, neg_ids, neg_emb, temperature=cfg.temperature
            )
        for key, weight in cfg.loss_weights:
            if key in aux:
                loss = loss + weight * aux[key]
        return loss, aux

    def train_step(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        """One optimizer step on a numpy batch; returns the loss, detached."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, _ = self.loss(to_device(batch, self.device))
        loss.backward()
        self.optimizer.step()
        if self.schedule is not None:
            self.schedule.step()
        return loss.detach()

    # -------------------------------------------------------------- eval step
    @torch.no_grad()
    def item_embeddings(self) -> torch.Tensor:
        """The candidate corpus' embeddings [X, D], normalised."""
        embs = self.model.get_item_embeddings(self.all_item_ids)
        return maybe_l2_norm(embs, self.cfg.item_l2_norm, self.cfg.l2_norm_eps)

    @torch.no_grad()
    def encode_step(
        self, batch: Dict[str, np.ndarray], item_embs: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(each row's target rank in the corpus, its target rating)."""
        features, target_ids, target_ratings = seq_features_from_row(
            to_device(batch, self.device),
            max_output_length=self.cfg.model.gr_output_length + 1,
        )
        input_embeddings = self.model.get_item_embeddings(features.past_ids)
        query = self.model.encode(
            features.past_lengths, features.past_ids, input_embeddings, features.past_payloads
        )
        k = min(MAX_K, int(self.all_item_ids.shape[0]))
        ranks = target_ranks(
            query, item_embs, self._id_to_col, target_ids[:, 0], features.past_ids, k=k
        )
        return ranks, target_ratings[:, 0]

    def eval_epoch(
        self,
        eval_batches: Iterator[Dict[str, np.ndarray]],
        max_iters: Optional[int] = None,
    ) -> Dict[str, float]:
        item_embs = self.item_embeddings()
        acc = MetricsAccumulator()
        for i, batch in enumerate(eval_batches):
            ranks, ratings = self.encode_step(batch, item_embs)
            acc.update(metrics_from_ranks(ranks, ratings))
            if max_iters is not None and i + 1 >= max_iters:
                break
        return acc.compute()


def train_loop(
    cfg: TrainConfig,
    train_dataset: SequenceDataset,
    eval_dataset: SequenceDataset,
    log_every: int = 100,
    max_steps: Optional[int] = None,
    tb_log_dir: Optional[str] = None,
    ckpt_dir: Optional[str] = None,
    device: str = "cuda",
) -> Dict[str, Any]:
    """Epoch loop: trains ``cfg.num_epochs`` epochs (or ``max_steps``
    steps), with a partial eval every ``cfg.eval_interval`` batches and an
    eval after each epoch. Returns the trainer, the per-epoch eval
    ``history``, each step's loss and host wall time (``losses``,
    ``step_s``; a step ends when its loss reaches the host), and
    ``examples_per_s`` over the train steps."""
    if ckpt_dir:
        raise NotImplementedError("checkpoints are not ported yet")
    tb = SummaryLogger(tb_log_dir)
    trainer = ResearchTrainer(cfg, train_dataset.all_item_ids(), device=device)

    def eval_batches(seed: int) -> Iterator[Dict[str, np.ndarray]]:
        return batch_iterator(eval_dataset, cfg.eval_batch_size, shuffle=True, seed=seed)

    batch_id = 0
    history, losses, step_s = [], [], []
    t0 = time.time()
    for epoch in range(cfg.num_epochs):
        if cfg.num_workers > 0:
            epoch_batches = prefetched_batch_iterator(
                train_dataset, cfg.local_batch_size, shuffle=True,
                seed=cfg.random_seed + epoch,
                num_workers=cfg.num_workers, prefetch_factor=cfg.prefetch_factor,
            )
        else:
            epoch_batches = batch_iterator(
                train_dataset, cfg.local_batch_size, shuffle=True, seed=cfg.random_seed + epoch
            )
        for batch in epoch_batches:
            if cfg.eval_interval > 0 and batch_id > 0 and batch_id % cfg.eval_interval == 0:
                m = trainer.eval_epoch(
                    eval_batches(cfg.random_seed + batch_id), max_iters=cfg.partial_eval_num_iters
                )
                tb.scalars(m, batch_id, prefix="eval_interval/")
                logger.info(
                    "step %d partial eval: HR@10 %.4f NDCG@10 %.4f",
                    batch_id, m.get("hr@10", float("nan")), m.get("ndcg@10", float("nan")),
                )
            t_step = time.perf_counter()
            losses.append(float(trainer.train_step(batch)))
            step_s.append(time.perf_counter() - t_step)
            if batch_id % log_every == 0:
                logger.info(
                    "step %d (epoch %d, %.1fs): loss %.6f",
                    batch_id, epoch, time.time() - t0, losses[-1],
                )
                tb.scalar("losses/ar_loss", losses[-1], batch_id)
            batch_id += 1
            if max_steps is not None and batch_id >= max_steps:
                break

        is_full = (epoch % cfg.full_eval_every_n) == 0
        metrics = trainer.eval_epoch(
            eval_batches(cfg.random_seed + epoch),
            max_iters=None if is_full else cfg.partial_eval_num_iters,
        )
        metrics["epoch"] = epoch
        history.append(metrics)
        tb.scalars(metrics, batch_id, prefix="eval/")
        logger.info(
            "eval epoch %d: NDCG@10 %.4f HR@10 %.4f HR@50 %.4f MRR %.4f",
            epoch,
            metrics.get("ndcg@10", float("nan")), metrics.get("hr@10", float("nan")),
            metrics.get("hr@50", float("nan")), metrics.get("mrr", float("nan")),
        )
        if max_steps is not None and batch_id >= max_steps:
            break
    tb.close()
    return {
        "trainer": trainer,
        "history": history,
        "losses": losses,
        "step_s": step_s,
        "examples_per_s": cfg.local_batch_size * len(step_s) / max(sum(step_s), 1e-9),
    }
