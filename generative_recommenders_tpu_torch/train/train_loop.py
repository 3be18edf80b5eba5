"""Research training loop: train and eval steps and the epoch loop (port of
`generative_recommenders_tpu/train/train_loop.py`); `parallel/train.py`
runs it on every rank of a mesh.

A train step is: the host batch sliced to its length bucket, features,
stochastic length, the target scattered into the ids, item embeddings, the
encoder (dropout on; on the card through the attention kernels), sampled
negatives, the loss, backward, AdamW. Eval ranks each row's target against
the whole item corpus.

Ported: HSTU and SASRec, ``sampling_strategy="local"`` or ``"in-batch"``
with `SampledSoftmaxLoss`, `BCELoss` or `BCELossWithRatings`, stochastic
length, length buckets (static or runtime), AdamW beta = (0.9, 0.98) with the
linear warm-up, the mid-epoch partial eval, ``max_steps``, TensorBoard
scalars and checkpoints of ``{params, opt_state}`` every
``save_ckpt_every_n`` epochs (`utils/checkpoint.py`); the MoL similarity
(`SampledSoftmaxLoss` over MoL logits, the ``mi_loss`` weighted in by
``loss_weights``, and a full-corpus MoL eval scored in chunks of
``eval_item_chunk_size`` items); ``compute_dtype="bfloat16"`` (the local
negatives then come from a bfloat16 copy of the item table, whose gradient
flows back to the float32 table through the cast); and
``loss_activation_checkpoint`` (the dot-product sampled softmax recomputed
in the backward, as the JAX trainer does; not the MoL branch).

The MoL branch reads the batch's ``"user_ids"``, as the JAX trainer does,
and the dataset yields ``"user_id"``: a MoL configuration with uid tables
therefore fails on its first step, in both packages (ROADMAP.md, findings
about the reference).
The JAX trainer folds the step number into one key and splits it for
dropout, stochastic length and negatives; here three `torch.Generator`s,
seeded once, advance from step to step, so a run is reproducible from its
seed but does not draw the JAX package's masks, lengths and negatives.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from generative_recommenders_tpu_torch.data.dataset import (
    SequenceDataset,
    batch_iterator,
    prefetched_batch_iterator,
)
from generative_recommenders_tpu_torch.data.features import (
    scatter_target_into_ids,
    seq_features_from_row,
)
from generative_recommenders_tpu_torch.models.embeddings import lookup_rows
from generative_recommenders_tpu_torch.models.losses import (
    bce_loss,
    bce_loss_with_ratings,
    sampled_softmax_loss,
    sampled_softmax_loss_from_logits,
)
from generative_recommenders_tpu_torch.models.samplers import (
    InBatchNegativesSampler,
    LocalNegativesSampler,
    maybe_l2_norm,
)
from generative_recommenders_tpu_torch.models.sequential import ModelConfig, SequentialRecommender
from generative_recommenders_tpu_torch.parallel.distributed import batch_rows
from generative_recommenders_tpu_torch.parallel.sharding import shard_batches
from generative_recommenders_tpu_torch.train.eval_metrics import (
    MAX_K,
    MetricsAccumulator,
    build_id_to_col,
    metrics_from_ranks,
    ranks_from_scores,
    target_ranks,
)
from generative_recommenders_tpu_torch.utils.bucketing import (
    apply_stochastic_length,
    bucket_batch,
    truncate_to_stochastic_length,
)
from generative_recommenders_tpu_torch.utils.checkpoint import save_checkpoint
from generative_recommenders_tpu_torch.utils.profiling import span
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
    sampling_strategy: str = "local"  # | "in-batch"
    loss_module: str = "SampledSoftmaxLoss"  # | "BCELoss" | "BCELossWithRatings"
    num_negatives: int = 128
    temperature: float = 0.05
    item_l2_norm: bool = True
    l2_norm_eps: float = 1e-6
    eval_interval: int = 100
    full_eval_every_n: int = 1
    partial_eval_num_iters: int = 32
    random_seed: int = 42
    # weights of auxiliary losses, by name, e.g. (("mi_loss", 0.001),) for
    # MoL's load balancing
    loss_weights: Tuple[Tuple[str, float], ...] = ()
    eval_item_chunk_size: int = 8192  # MoL eval: corpus items scored at once
    # stochastic length: rows longer than N^(alpha / 2) are cut to that
    # threshold with probability 1 - N^alpha / n^2; 0 = off
    stochastic_length_alpha: float = 0.0
    # length buckets: each batch is sliced to the smallest bucket that holds
    # its longest history; runtime_bucketing takes the next power of 2
    seq_len_buckets: Tuple[int, ...] = ()
    runtime_bucketing: bool = False
    # host data pipeline: batch-building threads and their window; 0 = synchronous
    num_workers: int = 4
    prefetch_factor: int = 16
    # recompute the dot-product sampled softmax in the backward
    loss_activation_checkpoint: bool = False


def _refuse_unported(cfg: TrainConfig) -> None:
    if cfg.sampling_strategy not in ("local", "in-batch"):
        raise ValueError(f"Unknown sampling_strategy {cfg.sampling_strategy}")
    if cfg.stochastic_length_alpha > 0.0 and cfg.loss_module == "BCELossWithRatings":
        raise ValueError(
            "stochastic length cuts the features' ratings; BCELossWithRatings reads the raw batch's"
        )
    if cfg.loss_module not in ("SampledSoftmaxLoss", "BCELoss", "BCELossWithRatings"):
        raise ValueError(f"Unknown loss_module {cfg.loss_module}")
    if cfg.model.interaction_module_type == "MoL" and cfg.loss_module != "SampledSoftmaxLoss":
        # the JAX trainer asserts the same in its loss
        raise ValueError(f"{cfg.loss_module} + MoL is not wired up")


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


class ResearchTrainer:
    """Owns the model, the optimizer, the sampler and the eval state, on
    ``device`` ("cuda" unless the caller asks for the CPU; without a card it
    raises). The weights are drawn from ``cfg.random_seed``, the dropout
    masks from the seed + 1, the negatives from the seed + 2, the stochastic
    lengths from a seed drawn from the dropout masks' seed."""

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
        if cfg.sampling_strategy == "local":
            self.sampler = LocalNegativesSampler(
                all_item_ids=self.all_item_ids, l2_norm=cfg.item_l2_norm,
                l2_norm_eps=cfg.l2_norm_eps,
            )
        else:
            self.sampler = InBatchNegativesSampler(
                l2_norm=cfg.item_l2_norm, l2_norm_eps=cfg.l2_norm_eps, dedup_embeddings=True
            )
        self.dropout_gen = torch.Generator(self.device).manual_seed(seed + 1)
        self.negatives_gen = torch.Generator(self.device).manual_seed(seed + 2)
        # split off the dropout seed, as the JAX trainer splits its dropout key
        length_seed = torch.randint(
            2**62, (1,), generator=torch.Generator().manual_seed(seed + 1)
        ).item()
        self.length_gen = torch.Generator(self.device).manual_seed(length_seed)

    # ------------------------------------------------------------- train step
    def loss(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The autoregressive loss of one device batch, dropout on."""
        cfg, model = self.cfg, self.model
        features, target_ids, _ = seq_features_from_row(
            batch, max_output_length=cfg.model.gr_output_length + 1
        )
        if cfg.stochastic_length_alpha > 0.0:
            old_len = features.past_lengths
            new_len = apply_stochastic_length(
                old_len, cfg.stochastic_length_alpha, cfg.model.max_sequence_len, self.length_gen
            )
            payloads = features.past_payloads
            features = features._replace(
                past_lengths=new_len,
                past_ids=truncate_to_stochastic_length(features.past_ids, old_len, new_len),
                past_payloads={
                    # the target's timestamp sits at position `old_len`; the
                    # shift moves it to `new_len`: keep that slot
                    "timestamps": truncate_to_stochastic_length(
                        payloads["timestamps"], old_len, new_len, extra_positions=1
                    ),
                    "ratings": truncate_to_stochastic_length(payloads["ratings"], old_len, new_len),
                },
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
        pos_emb = maybe_l2_norm(sup_emb, cfg.item_l2_norm, cfg.l2_norm_eps)
        if cfg.loss_module == "BCELossWithRatings":
            # supervised by the raw batch's ratings, > 3 as the label; no
            # negatives (the JAX trainer draws them and leaves them unused)
            ratings = batch["historical_ratings"].long()
            sup_ratings = torch.cat(
                [ratings, ratings.new_zeros(ratings.shape[0], cfg.model.gr_output_length + 1)], dim=1
            )[:, 1 : output.shape[1] + 1]
            with span("research.loss"):
                loss, aux = bce_loss_with_ratings(
                    output, pos_emb, (sup_ratings > 3).float(), ar_mask, temperature=cfg.temperature
                )
            return self._weighted(loss, aux)
        num_to_sample = 1 if cfg.loss_module == "BCELoss" else cfg.num_negatives
        if cfg.sampling_strategy == "in-batch":
            # the pool is the global batch's ids, as the JAX trainer's
            # process_batch sees them under a mesh
            flat_ids = batch_rows(past_ids.reshape(-1))
            state = self.sampler.process_batch(
                ids=flat_ids, presences=flat_ids != 0,
                embeddings=batch_rows(input_embeddings.reshape(-1, input_embeddings.shape[-1])),
            )
            with span("research.negatives"):
                neg_ids, neg_emb = self.sampler(self.negatives_gen, state, sup_ids, num_to_sample)
        else:
            with span("research.negatives"):
                neg_ids, neg_emb = self.sampler(
                    self.negatives_gen, sup_ids, num_to_sample, self._negatives_embedding_fn()
                )
        with span("research.loss"):
            if cfg.loss_module == "SampledSoftmaxLoss" and cfg.model.interaction_module_type == "MoL":
                loss, aux = self._mol_loss(batch, output, pos_emb, sup_ids, ar_mask, neg_ids, neg_emb)
            elif cfg.loss_module == "SampledSoftmaxLoss":
                args = (output, pos_emb, sup_ids, ar_mask, neg_ids, neg_emb, cfg.temperature)
                if cfg.loss_activation_checkpoint:
                    loss, aux = torch.utils.checkpoint.checkpoint(
                        sampled_softmax_loss, *args, use_reentrant=False, preserve_rng_state=False
                    )
                else:
                    loss, aux = sampled_softmax_loss(*args)
            else:
                loss, aux = bce_loss(
                    output, pos_emb, sup_ids, ar_mask, neg_ids, neg_emb, temperature=cfg.temperature
                )
        return self._weighted(loss, aux)

    def _negatives_embedding_fn(self):
        """The local negatives' lookup: the model's table, or under
        ``compute_dtype="bfloat16"`` a bfloat16 copy of it, gathered (through
        the table's exchange when it is sharded) and zeroed at id 0; the
        gradient reaches the float32 table through the cast."""
        model = self.model
        if self.cfg.model.compute_dtype != "bfloat16":
            return model.get_item_embeddings
        emb_module = model.embedding_module
        table16 = emb_module.item_emb.to(torch.bfloat16)
        num_items = self.cfg.model.num_items

        def lookup(ids: torch.Tensor) -> torch.Tensor:
            e = lookup_rows(table16, ids, num_items, emb_module.lookup_fn)
            return e * (ids != 0)[..., None].to(e.dtype)

        return lookup

    def _mol_loss(self, batch, output, pos_emb, sup_ids, ar_mask, neg_ids, neg_emb):
        """Sampled softmax over MoL logits: queries [B (N - 1), D] against
        their positive and R negatives [B (N - 1), 1 + R, D], user ids
        repeated N - 1 times."""
        B, Nm1, D = output.shape
        R = neg_emb.shape[2]
        items = torch.cat([pos_emb[:, :, None, :], neg_emb.to(pos_emb.dtype)], dim=2)
        uid = batch.get("user_ids")
        uid_flat = None if uid is None else uid.reshape(-1).repeat_interleave(Nm1)
        logits, aux = self.model.similarity_fn(
            output.reshape(B * Nm1, D), items.reshape(B * Nm1, 1 + R, D), uid_flat,
            deterministic=False, gen=self.dropout_gen,
        )
        loss = sampled_softmax_loss_from_logits(
            logits[:, 0].reshape(B, Nm1), logits[:, 1:].reshape(B, Nm1, R),
            sup_ids, ar_mask, neg_ids, softmax_temperature=self.cfg.temperature,
        )
        return loss, aux

    def _weighted(self, loss: torch.Tensor, aux: Dict[str, torch.Tensor]):
        for key, weight in self.cfg.loss_weights:
            if key in aux:
                loss = loss + weight * aux[key]
        return loss, aux

    def train_step(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        """One optimizer step on a numpy batch, sliced to its length bucket
        when buckets are on; returns the loss, detached."""
        cfg = self.cfg
        if cfg.seq_len_buckets or cfg.runtime_bucketing:
            batch = bucket_batch(batch, cfg.seq_len_buckets, cfg.runtime_bucketing)
        self.optimizer.zero_grad(set_to_none=True)
        # the backward too: the loss checkpoint recomputes the loss in it
        with self._batch_scope():
            loss, _ = self.loss(to_device(batch, self.device))
            with span("train.backward"):
                loss.backward()
        loss = self._sum_gradients(loss.detach())
        self.optimizer.step()
        if self.schedule is not None:
            self.schedule.step()
        return loss

    def _batch_scope(self):
        """The context the loss runs in (a mesh's trainer spreads the batch
        over its ranks)."""
        return contextlib.nullcontext()

    def _sum_gradients(self, loss: torch.Tensor) -> torch.Tensor:
        """The gradients of the whole batch, and its loss (a mesh's trainer
        sums the ranks')."""
        return loss

    # ------------------------------------------------------------ checkpoint
    def checkpoint_state(self) -> Dict[str, Any]:
        """``{"params", "opt_state"}``, as the JAX trainer saves them; the
        optimizer's state holds AdamW's and the warm-up schedule's."""
        return {
            "params": self.model.state_dict(),
            "opt_state": {
                "adamw": self.optimizer.state_dict(),
                "schedule": None if self.schedule is None else self.schedule.state_dict(),
            },
        }

    def save(self, ckpt_dir: str, step: int) -> None:
        """Writes `checkpoint_state` as checkpoint ``step`` under ``ckpt_dir``."""
        save_checkpoint(ckpt_dir, self.checkpoint_state(), step)

    def load_checkpoint_state(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"]["adamw"])
        if self.schedule is not None:
            self.schedule.load_state_dict(state["opt_state"]["schedule"])

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
        if self.cfg.model.interaction_module_type == "MoL":
            scores = self._mol_corpus_scores(query, item_embs, batch.get("user_ids"))
            ranks = ranks_from_scores(
                scores, self._id_to_col, target_ids[:, 0], features.past_ids, k=k
            )
        else:
            ranks = target_ranks(
                query, item_embs, self._id_to_col, target_ids[:, 0], features.past_ids, k=k
            )
        return ranks, target_ratings[:, 0]

    def _mol_corpus_scores(
        self, query: torch.Tensor, item_embs: torch.Tensor, user_ids
    ) -> torch.Tensor:
        """MoL scores [B, X] over the whole corpus: the item side computed
        once over the corpus padded to a multiple of the chunk, then scored
        chunk by chunk."""
        X = item_embs.shape[0]
        chunk = min(self.cfg.eval_item_chunk_size, X)
        padded = torch.cat([item_embs, item_embs.new_zeros(((-X) % chunk, item_embs.shape[1]))])
        i_comp, gi = self.model.mol_item_components(padded)
        uid = None if user_ids is None else torch.as_tensor(user_ids, device=self.device).reshape(-1)
        scores = [
            self.model.mol_score_components(
                query, i_comp[c : c + chunk], None if gi is None else gi[c : c + chunk], uid
            )
            for c in range(0, padded.shape[0], chunk)
        ]
        return torch.cat(scores, dim=1)[:, :X]

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
    save_ckpt_every_n: int = 0,  # epochs; 0 = never
    device: str = "cuda",
) -> Dict[str, Any]:
    """Epoch loop: trains ``cfg.num_epochs`` epochs (or ``max_steps``
    steps), with a partial eval every ``cfg.eval_interval`` batches and an
    eval after each epoch, and saves the trainer's ``{params, opt_state}``
    under ``ckpt_dir`` after every ``save_ckpt_every_n``-th epoch (its step
    is the epoch). Returns the trainer, the per-epoch eval ``history``, each
    step's loss and host wall time (``losses``, ``step_s``; a step ends when
    its loss reaches the host), and ``examples_per_s`` over the train
    steps."""
    trainer = ResearchTrainer(cfg, train_dataset.all_item_ids(), device=device)
    return run_epochs(trainer, train_dataset, eval_dataset, log_every, max_steps, tb_log_dir, ckpt_dir,
                      save_ckpt_every_n)


def run_epochs(
    trainer: ResearchTrainer,
    train_dataset: SequenceDataset,
    eval_dataset: SequenceDataset,
    log_every: int = 100,
    max_steps: Optional[int] = None,
    tb_log_dir: Optional[str] = None,
    ckpt_dir: Optional[str] = None,
    save_ckpt_every_n: int = 0,
    num_shards: int = 1,
    shard_index: int = 0,
) -> Dict[str, Any]:
    """`train_loop`'s epochs for ``trainer``. With ``num_shards`` > 1 every
    rank reads the same global batches and keeps its rows ``[k b, (k + 1)
    b)`` of each (k = ``shard_index``)."""
    cfg = trainer.cfg
    tb = SummaryLogger(tb_log_dir)

    def shard(batches: Iterator[Dict[str, np.ndarray]]) -> Iterator[Dict[str, np.ndarray]]:
        return batches if num_shards == 1 else shard_batches(batches, num_shards, shard_index)

    def eval_batches(seed: int) -> Iterator[Dict[str, np.ndarray]]:
        return shard(batch_iterator(eval_dataset, cfg.eval_batch_size, shuffle=True, seed=seed))

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
        for batch in shard(epoch_batches):
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
        if ckpt_dir and save_ckpt_every_n and (epoch + 1) % save_ckpt_every_n == 0:
            trainer.save(ckpt_dir, epoch)
            logger.info("checkpoint @ epoch %d -> %s", epoch, ckpt_dir)
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
