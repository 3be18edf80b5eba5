"""Checkpoints of the PyTorch port (`utils/checkpoint.py`) and what reads
them, on the CPU: save and restore bit-equal for both trainers, the
research CLI's ``--ckpt_dir`` over the dataset registry and over a sharded
corpus (``--multifile_prefix``), the ranker's restore at start,
``train_ranker --mode eval`` against the live trainer's eval, serving's
accuracy mode against the JAX package's accuracy log (the JAX weights
carried over through a port checkpoint), and a trained checkpoint beating
fresh weights in accuracy mode."""

import dataclasses
import json
import os
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from generative_recommenders_tpu.configs import dlrm as j_configs
from generative_recommenders_tpu.data import dlrm_factory as j_factory
from generative_recommenders_tpu.inference import main as j_serve
from generative_recommenders_tpu.modules.dlrm_hstu import DlrmHSTU as JaxDlrmHSTU
from generative_recommenders_tpu_torch.cli import preprocess_public_data, train_ranker, train_research
from generative_recommenders_tpu_torch.configs import dlrm as t_configs
from generative_recommenders_tpu_torch.convert import params_from_flax
from generative_recommenders_tpu_torch.data import dataset as t_data
from generative_recommenders_tpu_torch.data.dlrm_factory import make_dlrm_batches
from generative_recommenders_tpu_torch.inference import main as t_serve
from generative_recommenders_tpu_torch.models.sequential import ModelConfig
from generative_recommenders_tpu_torch.train import dlrm_train as t_dlrm
from generative_recommenders_tpu_torch.train.train_loop import ResearchTrainer, TrainConfig, train_loop
from generative_recommenders_tpu_torch.utils import checkpoint as ckpt
from test_torch_data import ml1m_files, write_shards

UIH, CANDS, BATCH = 24, 4, 4


def _equal_trees(a, b, path="") -> None:
    """Every tensor bit-equal, every other value equal."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _equal_trees(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_trees(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


@pytest.fixture()
def ml1m(tmp_path, monkeypatch):
    """``tmp/`` under a fresh working directory, holding the registry's
    preprocessed ml-1m (150 users)."""
    monkeypatch.chdir(tmp_path)
    os.makedirs("tmp")
    with zipfile.ZipFile("tmp/movielens1m.zip", "w") as z:
        for name, data in ml1m_files().items():
            z.writestr(name, data)
    assert preprocess_public_data.main(["--dataset_name", "ml-1m"]) == 3706
    return tmp_path / "tmp" / "ml-1m" / "sasrec_format.csv"


# ------------------------------------------------------------- research
def test_research_checkpoint_round_trip_is_bit_equal(tmp_path):
    """`ResearchTrainer.checkpoint_state` through `save_checkpoint` and
    `restore_checkpoint` into a fresh trainer: the parameters, AdamW's
    moments and step, the warm-up schedule."""
    seqs = t_data.synthetic_user_sequences(num_users=40, num_items=60, max_len=12, seed=1)
    ds = t_data.SequenceDataset(seqs, 12, ignore_last_n=1)
    cfg = TrainConfig(
        model=ModelConfig(num_items=60, max_sequence_len=12, gr_output_length=2, item_embedding_dim=16,
                          num_blocks=2, num_heads=2, dqk=8, dv=8),
        local_batch_size=8, eval_batch_size=8, num_epochs=3, num_negatives=4, num_warmup_steps=3,
        num_workers=0,
    )
    out = train_loop(cfg, ds, ds, ckpt_dir=str(tmp_path / "ck"), save_ckpt_every_n=2, device="cpu")
    assert ckpt.latest_step(str(tmp_path / "ck")) == 1  # after the second epoch
    live = out["trainer"]
    path = ckpt.save_checkpoint(str(tmp_path / "ck"), live.checkpoint_state(), step=3)
    assert path.endswith("3.pt") and ckpt.latest_step(str(tmp_path / "ck")) == 3
    state = ckpt.restore_checkpoint(str(tmp_path / "ck"), "cpu")
    _equal_trees(state, live.checkpoint_state())
    fresh = ResearchTrainer(cfg, ds.all_item_ids(), device="cpu")
    fresh.load_checkpoint_state(state)
    _equal_trees(fresh.checkpoint_state(), live.checkpoint_state())
    assert fresh.optimizer.param_groups[0]["lr"] == live.optimizer.param_groups[0]["lr"]
    # the earlier checkpoint differs: it was taken an epoch before
    older = ckpt.restore_checkpoint(str(tmp_path / "ck"), "cpu", step=1)
    assert not torch.equal(older["params"]["embedding_module.item_emb"],
                           state["params"]["embedding_module.item_emb"])
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        ckpt.restore_checkpoint(str(tmp_path / "none"), "cpu")


def test_research_cli_trains_a_preset_from_the_registry_with_checkpoints(ml1m):
    """No ``--data_csv``: the preset's dataset comes from the registry's
    files under ``tmp/``; ``--ckpt_dir`` saves ``{params, opt_state}`` at
    the end (step = epochs), bit-equal to the trainer's."""
    out = train_research.main(["--preset", "ml-1m/hstu-sampled-softmax-n128", "--num_epochs", "1",
                               "--device", "cpu", "--ckpt_dir", "ck"])
    assert len(out["losses"]) == 1 and len(out["history"]) == 1  # 150 users, batch 128
    assert ckpt.latest_step("ck") == 1
    _equal_trees(ckpt.restore_checkpoint("ck", "cpu"), out["trainer"].checkpoint_state())
    ids = out["trainer"].all_item_ids
    assert int(ids.min()) >= 1 and int(ids.max()) <= 3952


def test_research_cli_reads_a_sharded_corpus(tmp_path):
    """0-based ids in the shards, shifted by one as the registry's ml-3b
    reads them; the corpus is every item of the preset."""
    prefix = str(tmp_path / "16x32")
    write_shards(prefix, rows_per_shard=(60, 40, 30), num_items=3952, single=(2,))
    out = train_research.main(["--preset", "ml-1m/hstu-sampled-softmax-n128", "--num_epochs", "1",
                               "--device", "cpu", "--multifile_prefix", prefix])
    assert len(out["losses"]) == 1 and len(out["history"]) == 1  # 130 rows, batch 128
    assert np.isfinite(out["losses"][0]) and 0.0 <= out["history"][0]["hr@10"] <= 1.0
    assert out["trainer"].all_item_ids.shape[0] == 3952


# --------------------------------------------------------------- ranker
def _ranker(dataset, ckpt_dir=None, small=True, hash_size=4000, save_every=0):
    cfg = t_configs.get_hstu_configs(dataset, max_uih_len=UIH, max_num_candidates=CANDS)
    if small:
        cfg = dataclasses.replace(
            cfg, hstu_attn_num_layers=1, hstu_embedding_table_dim=8, hstu_transducer_embedding_dim=16,
            hstu_attn_linear_dim=8, hstu_attn_qk_dim=8, hstu_num_heads=2,
            hstu_input_dropout_ratio=0.0, hstu_linear_dropout_rate=0.0,
        )
    tables = t_configs.get_embedding_table_config(dataset, hash_size=hash_size, dim=cfg.hstu_embedding_table_dim)
    return t_dlrm.DlrmTrainer(cfg, tables, t_dlrm.DlrmTrainConfig(ckpt_dir=ckpt_dir, save_every=save_every),
                              device="cpu")


def test_ranker_checkpoint_round_trip_and_restore_at_start(ml1m):
    data = str(ml1m)
    trainer = _ranker("movielens-1m", "ck", save_every=2)
    batches = lambda n: make_dlrm_batches(  # noqa: E731
        "movielens-1m", trainer.hstu_cfg, data_file=data, hash_size=4000, batch_size=BATCH, num_batches=n)
    t_dlrm.train_loop(trainer, batches(5))
    assert sorted(os.listdir("ck")) == ["2.pt", "4.pt", "5.pt"]
    saved = ckpt.restore_checkpoint("ck", "cpu")
    _equal_trees(saved, trainer.model.state_dict())
    assert any(k.startswith("embedding_tables_") for k in saved)  # the tables are saved
    fresh = _ranker("movielens-1m")
    fresh.restore("ck")
    _equal_trees(fresh.model.state_dict(), trainer.model.state_dict())
    # a loop with a checkpoint directory starts from its latest checkpoint
    # (with no batch to train on, it saves what it restored under its step)
    again = _ranker("movielens-1m", "ck")
    t_dlrm.train_loop(again, iter(()))
    assert ckpt.latest_step("ck") == 5
    _equal_trees(again.model.state_dict(), saved)


def test_train_ranker_eval_mode_equals_the_live_trainers_eval(ml1m):
    """`train_ranker --mode eval --ckpt_dir` against `eval_loop` of the
    trainer that wrote the checkpoint, on the same batches in file order;
    the CLI's full-width movielens-1m model."""
    argv = ["--dataset", "movielens-1m", "--data_file", str(ml1m), "--batch_size", str(BATCH),
            "--max_uih_len", str(UIH), "--max_num_candidates", str(CANDS), "--hash_size", "4000",
            "--device", "cpu", "--ckpt_dir", "ck"]
    live = _ranker("movielens-1m", "ck", small=False)
    t_dlrm.train_loop(live, make_dlrm_batches(
        "movielens-1m", live.hstu_cfg, data_file=str(ml1m), hash_size=4000, batch_size=BATCH,
        num_batches=3, shuffle=True))
    want = t_dlrm.eval_loop(live, make_dlrm_batches(
        "movielens-1m", live.hstu_cfg, data_file=str(ml1m), hash_size=4000, batch_size=BATCH, num_batches=4))
    got = train_ranker.main(argv + ["--mode", "eval", "--num_batches", "4"])["metrics"]
    assert got.keys() == want.keys() == {"rating/mse", "rating/mae"}
    for k in want:
        assert got[k] == want[k], k
    # train mode through the CLI resumes from that checkpoint and numbers on
    out = train_ranker.main(argv + ["--num_batches", "2"])
    assert len(out["losses"]) == 2 and ckpt.latest_step("ck") == 5
    _equal_trees(ckpt.restore_checkpoint("ck", "cpu"), out["trainer"].model.state_dict())
    with pytest.raises(SystemExit):
        train_ranker.main(["--dataset", "movielens-1m", "--mode", "eval", "--device", "cpu"])  # no --ckpt_dir


# -------------------------------------------------------------- serving
SERVE_SMALL = dict(num_layers=2, transducer_dim=32, table_dim=16, attn_dim=16, num_heads=2)


def _serve_argv(data, log, mfalcon=False, hash_size=4000):
    argv = ["--accuracy", "--dataset", "movielens-1m", "--data_file", data, "--batch_size", str(BATCH),
            "--max_uih_len", str(UIH), "--max_num_candidates", str(CANDS), "--hash_size", str(hash_size),
            "--num_qsl_batches", "3", "--num_warmups", "1", "--accuracy_log", log]
    for k, v in SERVE_SMALL.items():
        argv += [f"--{k}", str(v)]
    return argv + (["--mfalcon"] if mfalcon else [])


@pytest.mark.parametrize("mfalcon", [False, True])
def test_accuracy_mode_matches_the_jax_packages_log(ml1m, mfalcon):
    """The JAX serving CLI in accuracy mode with its own seeded weights, and
    the port's with those weights carried over through a port checkpoint:
    the logged predictions within 1e-4 (the int8 tables quantized on each
    side from the same floats), the metrics alike."""
    data = str(ml1m)
    cfg = dataclasses.replace(
        j_configs.get_hstu_configs("movielens-1m", max_uih_len=UIH, max_num_candidates=CANDS, attn_kernel="xla"),
        hstu_attn_num_layers=2, hstu_transducer_embedding_dim=32, hstu_embedding_table_dim=16,
        hstu_attn_qk_dim=16, hstu_attn_linear_dim=16, hstu_num_heads=2,
    )
    model = JaxDlrmHSTU(cfg, j_configs.get_embedding_table_config("movielens-1m", hash_size=4000, dim=16))
    raw = next(j_factory.make_dlrm_batches("movielens-1m", cfg, data_file=data, hash_size=4000,
                                            batch_size=BATCH, num_batches=3))
    uih, cands = ({k: jnp.asarray(v) for k, v in d.items()} for d in (raw[0], raw[2]))
    params = model.init(jax.random.PRNGKey(0), uih, jnp.asarray(raw[1]), cands, jnp.asarray(raw[3]), True)
    ckpt.save_checkpoint("jax_weights", params_from_flax(jax.tree_util.tree_map(np.asarray, params)), 0)
    want_m = j_serve.main(_serve_argv(data, "jax.json", mfalcon) + ["--attn_kernel", "xla"])
    got_m = t_serve.main(_serve_argv(data, "port.json", mfalcon) + ["--ckpt_dir", "jax_weights", "--device", "cpu"])
    with open("jax.json") as f, open("port.json") as g:
        want, got = json.load(f), json.load(g)
    assert [r["qsl_idx"] for r in got] == [r["qsl_idx"] for r in want] == [0, 1, 2]
    for g, w in zip(got, want):
        assert len(g["data"]) == len(w["data"]) == BATCH * CANDS
        np.testing.assert_allclose(g["data"], w["data"], rtol=0, atol=1e-4)
    assert got_m.keys() == want_m.keys() == {"rating/mse", "rating/mae"}
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-4)


def _learnable_kuairand(path, n_users=48, seed=0, hash_size=64):
    """A KuaiRand seq log whose is_click label (action bit 1) is 'the video
    id is even', learnable from the item embedding."""
    rng = np.random.default_rng(seed)
    lines = ["user_id,video_id,action_weights,time_ms,play_time_ms"]
    for u in range(n_users):
        n = int(rng.integers(UIH // 3 + CANDS, UIH // 3 + CANDS + 5))
        vids = rng.integers(1, hash_size, n)
        cols = [vids, (vids % 2 == 0).astype(int), np.sort(rng.integers(1, 10_000_000, n)),
                rng.integers(0, 1000, n)]
        lines.append(f"{u + 1}," + ",".join('"' + str(list(map(int, c))) + '"' for c in cols))
    path.write_text("\n".join(lines) + "\n")


def test_trained_checkpoint_beats_fresh_weights_in_accuracy_mode(tmp_path):
    """As the JAX package's `tests/test_serving_accuracy.py`: a small
    KuaiRand ranker trained 10 epochs, served from its checkpoint in
    accuracy mode (int8 tables), against the seeded fresh weights on the
    same samples: lower NE and higher AUC on the learnable task."""
    data = tmp_path / "processed_seqs.csv"
    _learnable_kuairand(data)
    small = _ranker("kuairand-1k", hash_size=64)
    trainer = t_dlrm.DlrmTrainer(
        small.hstu_cfg, t_configs.get_embedding_table_config("kuairand-1k", hash_size=64, dim=8),
        t_dlrm.DlrmTrainConfig(ckpt_dir=str(tmp_path / "ck"), dense_lr=5e-3, sparse_lr=0.1), device="cpu",
    )

    def epochs(n):
        for e in range(n):
            for b in make_dlrm_batches("kuairand-1k", trainer.hstu_cfg, data_file=str(data), hash_size=64,
                                       batch_size=8, shuffle=True, seed=e):
                if b[1].shape[0] == 8:
                    yield b

    out = t_dlrm.train_loop(trainer, epochs(10))
    assert np.isfinite(out["metrics"]["is_click/ne"])

    def serve(with_ckpt):
        argv = ["--accuracy", "--dataset", "kuairand-1k", "--data_file", str(data), "--batch_size", "8",
                "--max_uih_len", str(UIH), "--max_num_candidates", str(CANDS), "--hash_size", "64",
                "--num_qsl_batches", "6", "--num_warmups", "1", "--num_layers", "1", "--transducer_dim", "16",
                "--table_dim", "8", "--attn_dim", "8", "--num_heads", "2", "--device", "cpu",
                "--accuracy_log", str(tmp_path / "acc.json")]
        return t_serve.main(argv + (["--ckpt_dir", str(tmp_path / "ck")] if with_ckpt else []))

    fresh, trained = serve(False), serve(True)
    assert trained["is_click/ne"] < fresh["is_click/ne"], (trained, fresh)
    assert trained["is_click/auc"] > max(0.6, fresh["is_click/auc"]), (trained, fresh)
