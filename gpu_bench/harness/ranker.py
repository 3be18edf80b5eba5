"""What the ranker's drivers share: the program's configuration built from
the configuration file and the traffic's shapes, the harness's weights
loaded into the program's model, the request batches, and the comparison of
served predictions with the reference's."""

from __future__ import annotations

import dataclasses
import gc
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from harness import synth
from harness.runner import Check


def program_config(cell):
    """(DlrmHSTUConfig, table configs) of the debug feature set at the
    configuration's widths and the traffic's lengths."""
    from generative_recommenders_tpu_torch.configs.dlrm import get_embedding_table_config, get_hstu_configs

    cfg, t = cell.config, cell.traffic
    hstu = dataclasses.replace(
        get_hstu_configs("debug", max_uih_len=t["max_uih_len"], max_num_candidates=t["max_num_candidates"]),
        **cfg["hstu"],
    )
    tables = get_embedding_table_config("debug", hash_size=cfg["hash_size"], dim=hstu.hstu_embedding_table_dim)
    return hstu, tables


def load_weights(cell, model: torch.nn.Module, seed: int, device: str) -> None:
    """Draws the harness's weights from ``seed`` into the model's own
    parameters, in place; the reference draws the same."""
    params = dict(model.named_parameters())
    names = [s[0] for s in cell.reference.leaf_specs(cell.config, cell.traffic)]
    if sorted(names) != sorted(params):
        raise RuntimeError(f"the reference's leaves {sorted(names)} are not the program's {sorted(params)}")
    cell.reference.make_weights(cell.config, cell.traffic, seed, device, into={n: p.data for n, p in params.items()})


def request_batches(cell, seed: int, n: int) -> List[synth.RankerBatch]:
    """``n`` request batches of the traffic's size from ``seed``."""
    return synth.ranker_batches(np.random.default_rng(seed), cell.traffic, cell.config["hash_size"], n)


def live_candidates(batch) -> int:
    return int(np.asarray(batch[3]).sum())


def live_tokens(batch) -> int:
    return int(np.asarray(batch[1]).sum() + np.asarray(batch[3]).sum())


def free(state: Dict[str, Any], keys: Sequence[str]) -> None:
    """Drops the program's state before the reference runs."""
    for k in keys:
        state.pop(k, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def pred_gap(prog: Sequence[torch.Tensor], ref: Sequence[torch.Tensor], batches) -> float:
    """The widest gap between a served prediction and the reference's, over
    the valid candidates of every batch."""
    gap = 0.0
    for p, r, b in zip(prog, ref, batches):
        if p.shape != r.shape:
            return float("inf")
        M = p.shape[-1]
        valid = torch.arange(M, device=p.device)[None] < torch.as_tensor(b[3], device=p.device).long()[:, None]
        gap = max(gap, float((p.float() - r.to(p.device).float()).abs()[:, valid].max()))
    return gap


def sample_queries(n_done: int, qsl: Sequence, seed: int, k: int) -> List[int]:
    """``k`` finished queries drawn from the seed, the one over the QSL's
    longest batch among them."""
    if n_done == 0:
        return []
    rng = np.random.default_rng(seed + 17)
    longest = max(range(min(len(qsl), n_done)), key=lambda i: live_tokens(qsl[i]))
    picks = {longest}
    others = rng.permutation(n_done)
    for q in others:
        if len(picks) >= min(k, n_done):
            break
        picks.add(int(q))
    return sorted(picks)


def setup_serving(cell, seed: int, device: str) -> Dict[str, Any]:
    """The served model family (`inference/model_family.py`, the tables
    quantized to int8 from the harness's float32 weights), the query set
    (QSL) on the device, every QSL batch predicted once to warm up."""
    from generative_recommenders_tpu_torch.inference.model_family import HSTUModelFamily
    from generative_recommenders_tpu_torch.modules.dlrm_hstu import DlrmHSTU
    from generative_recommenders_tpu_torch.ops.cuda.hstu_attention import (
        delta_hstu_mha_cuda,
        hstu_mha_dense_cuda,
    )

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    hstu, tables = program_config(cell)
    with torch.device(device):
        model = DlrmHSTU(hstu, tables, torch.Generator(device).manual_seed(seed))
    load_weights(cell, model, seed, device)
    family = HSTUModelFamily(model, quantize=True)
    qsl = request_batches(cell, seed, cell.traffic["qsl_batches"])
    qsl_dev = [cell.reference.to_device(b, device) for b in qsl]
    for b in qsl_dev:
        family.predict(*b)
    if device != "cpu":
        torch.cuda.synchronize()
    launches = list(hstu_mha_dense_cuda.launches.values()) + list(delta_hstu_mha_cuda.launches.values())
    return dict(cell=cell, seed=seed, device=device, model=model, family=family, qsl=qsl, qsl_dev=qsl_dev,
                launches=launches, preds=[])


def predictor(state: Dict[str, Any]):
    """A query's call: `HSTUModelFamily.predict` on its QSL batch, its
    predictions on the device once it returns (as `inference/main.py`)."""
    family, qsl_dev = state["family"], state["qsl_dev"]
    sync = torch.cuda.synchronize if state["device"] != "cpu" else (lambda: None)

    def predict(q: int) -> torch.Tensor:
        preds = family.predict(*qsl_dev[q % len(qsl_dev)])
        sync()
        return preds

    return predict, sync


def check_serving(state: Dict[str, Any]) -> List[Check]:
    """The predictions of a sample of finished queries against the
    reference's on the same requests, once the program's state is freed."""
    cell, ref = state["cell"], state["cell"].reference
    picks = sample_queries(len(state["preds"]), state["qsl"], state["seed"], cell.traffic["checked_queries"])
    prog = [state["preds"][q] for q in picks]
    state["preds"] = []
    free(state, ("family", "model", "qsl_dev"))
    if not picks:
        return [Check("pred_gap", float("inf"), ref.LIMITS["pred_gap"])]
    batches = [state["qsl"][q % len(state["qsl"])] for q in picks]
    want = ref.serve_predictions(cell.config, cell.traffic, state["seed"], state["device"], batches)
    return [Check("pred_gap", pred_gap(prog, want, batches), ref.LIMITS["pred_gap"])]


def control_serving(cell, seed: int, device: str) -> Dict[str, Dict[str, float]]:
    """The comparison's number for the control (the reference in TF32)
    against the float32 reference, on the QSL batches the cell serves; no
    program run."""
    ref = cell.reference
    qsl = request_batches(cell, seed, cell.traffic["qsl_batches"])
    k = cell.traffic["checked_queries"]
    batches = [qsl[q % len(qsl)] for q in sample_queries(len(qsl), qsl, seed, k)]
    base = ref.serve_predictions(cell.config, cell.traffic, seed, device, batches)
    tf32 = ref.serve_predictions(cell.config, cell.traffic, seed, device, batches, tf32=True)
    return {"tf32": {"pred_gap": pred_gap(tf32, base, batches)}}
