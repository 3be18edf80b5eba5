"""Driver: the research stack's training (`train/train_loop.py`,
`ResearchTrainer.train_step`) over an in-memory corpus, fed by the port's own
threaded batching (`data/dataset.py:prefetched_batch_iterator`), epoch after
epoch.

Set-up builds one trainer, loads the harness's weights into it, and drives
it through the window's own feed and call for its first steps: the first
three are the ones the reference follows (the first step's gradients as
AdamW holds them, the parameters' change after the third), the rest warm up.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Dict, List

import numpy as np
import torch

from harness import synth
from harness.runner import Check, Window, log, train_window, training_checks

REFERENCE_STEPS = 3


def _epoch_seed(seed: int, epoch: int) -> int:
    return seed * 1009 + epoch


def setup(cell, seed: int, device: str) -> Dict[str, Any]:
    from generative_recommenders_tpu_torch.data.dataset import (
        SequenceDataset,
        UserSequences,
        prefetched_batch_iterator,
    )
    from generative_recommenders_tpu_torch.models.sequential import ModelConfig
    from generative_recommenders_tpu_torch.ops.cuda import hstu_attention_relbias as relbias
    from generative_recommenders_tpu_torch.train.train_loop import ResearchTrainer, TrainConfig

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg, t, ref = cell.config, cell.traffic, cell.reference
    m = cfg["model"]
    corpus = synth.research_corpus(
        t["num_users"], m["num_items"], t["max_len"], t["min_len"], t["latent_dim"], seed, device
    )
    log(f"corpus {time.perf_counter() - t0:.2f} s")
    dataset = SequenceDataset(
        UserSequences(corpus.user_ids, corpus.item_ids, corpus.ratings, corpus.timestamps),
        m["max_sequence_len"], ignore_last_n=cfg["train"]["ignore_last_n"],
    )
    train = {k: v for k, v in cfg["train"].items() if k != "ignore_last_n"}
    tcfg = TrainConfig(model=ModelConfig(**m), random_seed=seed, **train)
    trainer = ResearchTrainer(tcfg, dataset.all_item_ids(), device=device)
    names = [n for n, _ in trainer.model.named_parameters()]
    W = ref.make_weights(cfg, seed, device)
    if sorted(W) != sorted(names):
        raise RuntimeError(f"the reference's leaves {sorted(W)} are not the program's {sorted(names)}")
    with torch.no_grad():
        for n, p in trainer.model.named_parameters():
            p.copy_(W[n])
    del W
    B = tcfg.local_batch_size

    def feed():
        epoch = 0
        while True:
            yield from prefetched_batch_iterator(
                dataset, B, shuffle=True, seed=_epoch_seed(seed, epoch),
                num_workers=t["num_workers"], prefetch_factor=t["prefetch_factor"],
            )
            epoch += 1

    batches = feed()
    log(f"trainer and weights {time.perf_counter() - t0:.2f} s")
    beta1 = trainer.optimizer.param_groups[0]["betas"][0]
    losses, grad_norms, change_norms = [], {}, {}
    for step in range(1, REFERENCE_STEPS + t["warmup_steps"] + 1):
        losses.append(float(trainer.train_step(next(batches))))
        params = dict(trainer.model.named_parameters())
        with torch.no_grad():
            if step == 1:
                # the gradient as AdamW got it: its first moment is (1 - beta1) g
                # (0 where AdamW holds no state: it took no step)
                state = trainer.optimizer.state
                grad_norms = {
                    n: (state[p]["exp_avg"].norm() / (1.0 - beta1)).item() if state.get(p) else 0.0
                    for n, p in params.items()
                }
            if step == REFERENCE_STEPS:
                W0 = ref.make_weights(cfg, seed, device)
                change_norms = {n: (p - W0[n]).norm().item() for n, p in params.items()}
                del W0
    log(f"{REFERENCE_STEPS + t['warmup_steps']} first steps {time.perf_counter() - t0:.2f} s in all")
    launches = [
        relbias.hstu_mha_dense_relbias_cuda.launches, relbias.hstu_mha_dense_relbias_cuda.launches_bf16,
        relbias.hstu_mha_relbias_bwd_cuda.launches, relbias.hstu_mha_relbias_bwd_cuda.launches_bf16,
        relbias.hstu_mha_relbias_bwd_cuda.launches_det, relbias.hstu_mha_relbias_bwd_cuda.launches_det_bf16,
    ]
    order = synth.epoch_order(len(dataset), _epoch_seed(seed, 0))
    return dict(
        cell=cell, seed=seed, device=device, trainer=trainer, batches=batches, corpus=corpus,
        losses=losses[:REFERENCE_STEPS], grad_norms=grad_norms, change_norms=change_norms,
        launches=launches, first_rows=[order[i * B : (i + 1) * B] for i in range(REFERENCE_STEPS)],
    )


def window(state: Dict[str, Any], seconds: float, trace: bool) -> Window:
    cell, trainer, ref = state["cell"], state["trainer"], state["cell"].reference
    cfg = cell.config
    sync = torch.cuda.synchronize if state["device"] != "cpu" else (lambda: None)

    def work(batch) -> Dict[str, Any]:
        lengths = np.asarray(batch["history_lengths"])
        return {
            "model_flops": ref.step_flops(cfg, lengths),
            "attention_calls": ref.attention_calls(cfg, lengths),
        }

    win = train_window(
        state["batches"],
        lambda batch: float(trainer.train_step(batch)),
        lambda batch: int(batch["history_lengths"].shape[0]),
        work,
        lambda: sum(c.count for c in state["launches"]),
        seconds,
        cell.traffic["trace_steps"] if trace else 0,
        sync,
    )
    state["batches"].close()
    return win


def _reference(cell, seed: int, device: str, corpus, first_rows, tf32: bool = False, rows_kept=None):
    ref, cfg = cell.reference, cell.config
    batches = [ref.rows(corpus, idx[:rows_kept], cfg) for idx in first_rows]
    W0 = ref.make_weights(cfg, seed, device)
    t = time.perf_counter()
    out = ref.train_steps(cfg, W0, batches, corpus, seed, device, tf32=tf32)
    log(f"reference{' (TF32)' if tf32 else ''}{'' if rows_kept is None else f' ({rows_kept} rows)'}: "
         f"{time.perf_counter() - t:.2f} s")
    return out


def check(state: Dict[str, Any]) -> List[Check]:
    for k in ("trainer", "batches"):
        state.pop(k, None)
    gc.collect()
    if state["device"] != "cpu":
        torch.cuda.empty_cache()
    cell = state["cell"]
    out = _reference(cell, state["seed"], state["device"], state["corpus"], state["first_rows"])
    return training_checks(state, out, cell.reference.LIMITS)


def control(cell, seed: int, device: str) -> Dict[str, Dict[str, float]]:
    """The comparison's numbers for the control and a planted fault, with no
    program run: the reference in TF32 and the reference on half of each
    batch (its loss the mean over that half), each read against the float32
    reference on the full batches, as the program is."""
    t = cell.traffic
    m = cell.config["model"]
    corpus = synth.research_corpus(
        t["num_users"], m["num_items"], t["max_len"], t["min_len"], t["latent_dim"], seed, device
    )
    B = cell.config["train"]["local_batch_size"]
    order = synth.epoch_order(len(corpus.item_ids), _epoch_seed(seed, 0))
    first = [order[i * B : (i + 1) * B] for i in range(REFERENCE_STEPS)]
    base = _reference(cell, seed, device, corpus, first)
    lim = cell.reference.LIMITS
    read = lambda o: {c.name: c.value for c in training_checks(o, base, lim)}  # noqa: E731
    return {
        "tf32": read(_reference(cell, seed, device, corpus, first, tf32=True)),
        "half_batch": read(_reference(cell, seed, device, corpus, first, rows_kept=B // 2)),
        "unchanged_state": {"change_gap": 1.0},
    }
