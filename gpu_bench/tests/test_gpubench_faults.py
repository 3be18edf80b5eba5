"""A run with its timed path broken underneath comes out not correct: a step
that leaves the state unchanged, half of each batch left out (the mean taken
over the rest), an answer altered where it is produced. The look for a card
is skipped; the rest of the run is the benchmark's own. (One chip: no
exchange between chips to leave out.)"""

import pytest
import torch

from generative_recommenders_tpu_torch.inference.model_family import HSTUModelFamily
from generative_recommenders_tpu_torch.parallel.optimizers import RowWiseAdagrad
from generative_recommenders_tpu_torch.train.dlrm_train import DlrmTrainer
from generative_recommenders_tpu_torch.train.train_loop import ResearchTrainer

TRAINING = ["tiny-research", "tiny-ranker-train"]
SERVING = ["tiny-offline", "tiny-server"]


@pytest.mark.parametrize("cell", TRAINING + SERVING)
def test_a_sound_run_is_correct(run_tiny, cell):
    line = run_tiny(cell)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("cell", TRAINING)
def test_a_step_that_leaves_the_state_unchanged(run_tiny, monkeypatch, cell):
    for opt in (torch.optim.AdamW, torch.optim.Adam, RowWiseAdagrad):
        monkeypatch.setattr(opt, "step", lambda self, closure=None: None)
    line = run_tiny(cell)
    assert not line["correct"]
    assert line["checks"]["change_gap"]["value"] >= 0.99


def _half_research(step):
    def train_step(self, batch):
        k = len(batch["history_lengths"]) // 2
        return step(self, {n: v[:k] for n, v in batch.items()})
    return train_step


def _half_ranker(step):
    def train_step(self, batch):
        uih, ul, cands, nc = batch
        k = ul.shape[0] // 2
        return step(self, ({n: v[:k] for n, v in uih.items()}, ul[:k], {n: v[:k] for n, v in cands.items()}, nc[:k]))
    return train_step


@pytest.mark.parametrize("cell", TRAINING)
def test_half_of_each_batch_left_out(run_tiny, monkeypatch, cell):
    cls, half = (ResearchTrainer, _half_research) if cell == "tiny-research" else (DlrmTrainer, _half_ranker)
    monkeypatch.setattr(cls, "train_step", half(cls.train_step))
    line = run_tiny(cell)
    assert not line["correct"]
    assert line["checks"]["loss_gap"]["value"] > line["checks"]["loss_gap"]["limit"]


@pytest.mark.parametrize("cell", SERVING)
def test_an_answer_altered_where_it_is_produced(run_tiny, monkeypatch, cell):
    predict = HSTUModelFamily.predict

    def altered(self, *args):
        preds = predict(self, *args).clone()
        preds[0, 0, 0] += 1e-3  # the first candidate is always a real one
        return preds

    monkeypatch.setattr(HSTUModelFamily, "predict", altered)
    line = run_tiny(cell)
    assert not line["correct"]
    assert line["checks"]["pred_gap"]["value"] >= 1e-3 * 0.99
