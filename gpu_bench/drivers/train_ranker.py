"""Driver: the DLRM-v3 ranker's training (`train/dlrm_train.py`,
`DlrmTrainer.train_step`): a pool of request batches made at set-up and
cycled through the port's `background_prefetch`, each step's loss read on
the host as the port's loop reads it.

Set-up builds one trainer, draws the harness's weights into it, and drives
it through the window's own feed and call for its first steps: the first
three are the ones the reference follows (each step's loss and
predictions, the first step's gradients as the optimizers hold them, the
parameters' change after the third), the rest warm up.
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Dict, List

import numpy as np
import torch

from harness import ranker
from harness.runner import Check, Window, log, train_window, training_checks

REFERENCE_STEPS = 3


def _grad_norm(opt_state: Dict[str, torch.Tensor], p: torch.Tensor, beta1: float) -> float:
    """The first step's gradient norm from the optimizer's state: Adam's
    first moment is (1 - beta1) g; row-wise Adagrad's accumulator is the
    row's mean of g^2. 0 where the optimizer holds no state (it took no step)."""
    if not opt_state:
        return 0.0
    if "exp_avg" in opt_state:
        return (opt_state["exp_avg"].norm() / (1.0 - beta1)).item()
    acc = opt_state["acc"]
    return (acc.sum() * (p.shape[1] if p.dim() == 2 else 1)).sqrt().item()


def setup(cell, seed: int, device: str) -> Dict[str, Any]:
    from generative_recommenders_tpu_torch.data.dataset import background_prefetch
    from generative_recommenders_tpu_torch.ops.cuda.hstu_attention import hstu_mha_bwd_cuda, hstu_mha_dense_cuda
    from generative_recommenders_tpu_torch.train.dlrm_train import DlrmTrainConfig, DlrmTrainer, to_device

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg, t, ref = cell.config, cell.traffic, cell.reference
    hstu, tables = ranker.program_config(cell)
    opt = cfg["optimizer"]
    trainer = DlrmTrainer(
        hstu, tables, DlrmTrainConfig(dense_lr=opt["dense_lr"], sparse_lr=opt["sparse_lr"]), device=device, seed=seed
    )
    ranker.load_weights(cell, trainer.model, seed, device)
    pool = ranker.request_batches(cell, seed, t["pool_batches"])
    batches = background_prefetch(itertools.cycle(pool), size=t["prefetch"])
    log(f"trainer, weights and batches {time.perf_counter() - t0:.2f} s")
    beta1 = trainer.dense_opt.param_groups[0]["betas"][0]
    params = dict(trainer.model.named_parameters())
    losses, preds, grad_norms, change_norms = [], [], {}, {}
    for step in range(1, REFERENCE_STEPS + t["warmup_steps"] + 1):
        loss, p, _, _ = trainer.train_step(to_device(next(batches), trainer.device))
        losses.append(float(loss))
        if step <= REFERENCE_STEPS:
            preds.append(p)
        with torch.no_grad():
            if step == 1:
                states = {**trainer.sparse_opt.state, **trainer.dense_opt.state}
                grad_norms = {n: _grad_norm(states.get(q, {}), q, beta1) for n, q in params.items()}
            if step == REFERENCE_STEPS:
                for i, spec in enumerate(ref.leaf_specs(cfg, t)):
                    p0 = ref.make_leaf(spec, i, seed, device)
                    change_norms[spec[0]] = (params[spec[0]] - p0).norm().item()
                    del p0
    log(f"{REFERENCE_STEPS + t['warmup_steps']} first steps {time.perf_counter() - t0:.2f} s in all")
    launches = list(hstu_mha_dense_cuda.launches.values()) + list(hstu_mha_bwd_cuda.launches.values())
    return dict(
        cell=cell, seed=seed, device=device, trainer=trainer, batches=batches, pool=pool, to_device=to_device,
        losses=losses[:REFERENCE_STEPS], preds=preds, grad_norms=grad_norms, change_norms=change_norms,
        launches=launches,
    )


def window(state: Dict[str, Any], seconds: float, trace: bool) -> Window:
    cell, trainer, ref = state["cell"], state["trainer"], state["cell"].reference
    cfg, t = cell.config, cell.traffic
    to_device = state["to_device"]
    sync = torch.cuda.synchronize if state["device"] != "cpu" else (lambda: None)

    def work(batch) -> Dict[str, Any]:
        return {
            "model_flops": 3.0 * ref.forward_flops(cfg, t, batch),
            "attention_calls": ref.attention_calls(cfg, t, batch, backward=True),
        }

    return train_window(
        state["batches"],
        lambda batch: float(trainer.train_step(to_device(batch, trainer.device))[0]),
        lambda batch: int(np.asarray(batch[1]).shape[0]),
        work,
        lambda: sum(c.count for c in state["launches"]),
        seconds,
        t["trace_steps"] if trace else 0,
        sync,
    )


def compare(prog: Dict[str, Any], out: Dict[str, Any], batches, limits: Dict[str, float]) -> List[Check]:
    """`training_checks`, and the first step's predictions. The later
    steps' predictions are not compared: Adam's first steps move each
    weight by about the learning rate times the sign of its gradient, and
    the sign of a gradient at round-off flips between two sound runs."""
    return training_checks(prog, out, limits) + [
        Check("pred_gap", ranker.pred_gap(prog["preds"][:1], out["preds"][:1], batches[:1]), limits["pred_gap"])
    ]


def _reference(cell, seed, device, batches, tf32=False):
    t = time.perf_counter()
    out = cell.reference.train_steps(cell.config, cell.traffic, seed, device, batches, tf32=tf32)
    log(f"reference{' (TF32)' if tf32 else ''}: {time.perf_counter() - t:.2f} s")
    return out


def check(state: Dict[str, Any]) -> List[Check]:
    batches = state["batches"]
    ranker.free(state, ("trainer", "batches"))
    del batches
    cell = state["cell"]
    first = state["pool"][:REFERENCE_STEPS]
    out = _reference(cell, state["seed"], state["device"], first)
    return compare(state, out, first, cell.reference.LIMITS)


def control(cell, seed: int, device: str) -> Dict[str, Dict[str, float]]:
    """The comparison's numbers for the control (the reference in TF32) and a
    planted fault (each step on half of its batch), against the float32
    reference, with no program run."""
    pool = ranker.request_batches(cell, seed, cell.traffic["pool_batches"])
    first = pool[:REFERENCE_STEPS]
    base = _reference(cell, seed, device, first)
    lim = cell.reference.LIMITS

    def half(b):
        uih, ul, cands, nc = b
        k = len(ul) // 2
        return {n: v[:k] for n, v in uih.items()}, ul[:k], {n: v[:k] for n, v in cands.items()}, nc[:k]

    def read(out, batches):
        prog = {"losses": out["losses"], "preds": out["preds"], "grad_norms": out["grad_norms"],
                "change_norms": out["change_norms"]}
        checks = compare(prog, base, batches, lim)
        return {c.name: c.value for c in checks}

    halves = [half(b) for b in first]
    half_out = _reference(cell, seed, device, halves)
    # the half batch's predictions against the full batch's first rows
    base_half = dict(base, preds=[p[:, : len(h[1])] for p, h in zip(base["preds"], halves)])
    checks = compare(half_out, base_half, halves, lim)
    return {
        "tf32": read(_reference(cell, seed, device, first, tf32=True), first),
        "half_batch": {c.name: c.value for c in checks},
        "unchanged_state": {"change_gap": 1.0},
    }
