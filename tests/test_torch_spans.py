"""The program's spans (`utils/profiling.py:span`) on the CPU: off, a span
is one shared no-op; under `torch.profiler`, the Chrome trace holds each of
the six on the thread that called the model, the table lookup and the STU
stack inside the predict; and the losses and predictions are bit for bit
those of the same calls with no profiler. Also the ranker loop's
``examples_per_s``, whose window leaves the first step out."""

import dataclasses
import json
import os
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from generative_recommenders_tpu_torch.configs import dlrm as t_configs
from generative_recommenders_tpu_torch.data.dataset import (
    SequenceDataset,
    batch_iterator,
    synthetic_user_sequences,
)
from generative_recommenders_tpu_torch.data.dlrm_dataset import DLRMv3RandomDataset
from generative_recommenders_tpu_torch.inference.model_family import HSTUModelFamily
from generative_recommenders_tpu_torch.models.sequential import ModelConfig
from generative_recommenders_tpu_torch.train import dlrm_train
from generative_recommenders_tpu_torch.train.train_loop import ResearchTrainer, TrainConfig
from generative_recommenders_tpu_torch.utils import profiling

SPANS = ("train.backward", "dlrm.lookup", "dlrm.stu", "research.negatives", "research.loss", "serve.predict")
CALLER = "test.caller"
SMALL = dict(
    hstu_attn_num_layers=1, hstu_embedding_table_dim=16, hstu_transducer_embedding_dim=32,
    hstu_attn_linear_dim=16, hstu_attn_qk_dim=16, hstu_num_heads=2,
    num_position_buckets=128, num_time_buckets=64,
    contextual_feature_to_min_uih_length=(("viewer_id", 10), ("dummy_contexual", 10)),
    hstu_input_dropout_ratio=0.2, hstu_linear_dropout_rate=0.2,
)
HASH = 64
NUM_ITEMS = 50


def _ranker():
    cfg = dataclasses.replace(t_configs.get_hstu_configs("debug", max_uih_len=24, max_num_candidates=6), **SMALL)
    trainer = dlrm_train.DlrmTrainer(
        cfg, t_configs.get_embedding_table_config("debug", hash_size=HASH, dim=16),
        dlrm_train.DlrmTrainConfig(), device="cpu", seed=3,
    )
    return trainer, list(DLRMv3RandomDataset(cfg, hash_size=HASH, batch_size=2, seed=0).batches(3))


def _research(sampling_strategy):
    seqs = synthetic_user_sequences(num_users=16, num_items=NUM_ITEMS, max_len=16, seed=0)
    ds = SequenceDataset(seqs, max_sequence_length=16, ignore_last_n=1)
    model = ModelConfig(num_items=NUM_ITEMS, max_sequence_len=16, gr_output_length=1, item_embedding_dim=16,
                        num_blocks=1, num_heads=2, dqk=8, dv=8, dropout_rate=0.2)
    cfg = TrainConfig(model=model, local_batch_size=4, eval_batch_size=4, num_negatives=8,
                      sampling_strategy=sampling_strategy)
    return ResearchTrainer(cfg, ds.all_item_ids(), device="cpu"), next(batch_iterator(ds, 4, shuffle=False))


def _calls(sampling_strategy):
    """A ranker training step, a served predict of its trained model, and a
    research step (sampled softmax), each from fresh seeded state: their
    loss, predictions and loss."""
    trainer, batches = _ranker()
    ranker_loss = trainer.train_step(dlrm_train.to_device(batches[0], trainer.device))[0]
    preds = HSTUModelFamily(trainer.model, quantize=True).predict(*dlrm_train.to_device(batches[1], trainer.device))
    research, batch = _research(sampling_strategy)
    return ranker_loss, preds, research.train_step(batch)


def test_span_without_a_profiler_is_the_shared_no_op(monkeypatch):
    def no_range(name):
        raise AssertionError(f"a range {name!r} opened with no profiler on")

    monkeypatch.setattr(profiling, "record_function", no_range)
    assert profiling.span("train.backward") is profiling.span("serve.predict")
    with profiling.span("dlrm.stu"):
        pass


def test_span_names_are_not_prefixes_of_one_another():
    # a metric reads a span by the start of its name
    assert not [(a, b) for a in SPANS for b in SPANS if a != b and b.startswith(a)]


def _x_events(path):
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _inside(inner, outer):
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


@pytest.mark.parametrize("sampling_strategy", ["local", "in-batch"])
def test_spans_in_the_chrome_trace_and_results_unchanged(tmp_path, sampling_strategy):
    off = _calls(sampling_strategy)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(CALLER):
            on = _calls(sampling_strategy)
    for a, b in zip(off, on, strict=True):
        assert torch.equal(a, b)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    events = _x_events(path)
    (caller,) = [e for e in events if e["name"] == CALLER]
    spans = [e for e in events if e["name"] in SPANS]
    # each once (dlrm.lookup and dlrm.stu once in the training step, once in the predict)
    counts = {n: sum(e["name"] == n for e in spans) for n in SPANS}
    assert counts == {"train.backward": 2, "dlrm.lookup": 2, "dlrm.stu": 2, "research.negatives": 1,
                      "research.loss": 1, "serve.predict": 1}
    for e in spans:
        assert (e["pid"], e["tid"]) == (caller["pid"], caller["tid"]) and _inside(e, caller), e["name"]
    (predict,) = [e for e in spans if e["name"] == "serve.predict"]
    for name in ("dlrm.lookup", "dlrm.stu"):
        assert sum(_inside(e, predict) for e in spans if e["name"] == name) == 1, name


def test_profiler_trace_holds_the_training_spans(tmp_path):
    """`Profiler` (behind the ranker's ``--output_trace``) records the step's
    backward, lookup and STU stack."""
    trainer, batches = _ranker()
    prof = profiling.Profiler(str(tmp_path), wait=0, warmup=1, active=1)
    for b in batches[:2]:
        trainer.train_step(dlrm_train.to_device(b, trainer.device))
        prof.step()
    prof.close()
    assert prof.paths == [os.path.join(str(tmp_path), "trace_0.json")]
    names = {e["name"] for e in _x_events(prof.paths[0])}
    assert {"train.backward", "dlrm.lookup", "dlrm.stu"} <= names


def test_ranker_loop_rate_leaves_the_first_step_out(monkeypatch):
    """On a clock that moves only in the steps, 100 s in the first and 1 s in
    each later one: the rate counts the 4 examples of steps 2 and 3 over the
    2 s from the first step's end."""
    clock = SimpleNamespace(t=0.0)
    clock.perf_counter = lambda: clock.t
    monkeypatch.setattr(dlrm_train, "time", clock)
    trainer, batches = _ranker()
    step = trainer.train_step

    def timed_step(batch):
        clock.t += 1.0 if clock.t else 100.0
        return step(batch)

    monkeypatch.setattr(trainer, "train_step", timed_step)
    out = dlrm_train.train_loop(trainer, iter(batches))
    assert out["step_s"] == [100.0, 1.0, 1.0]
    assert out["examples_per_s"] == 2.0
