"""The STU recompute policy of the PyTorch port (`modules/stu.py`:
``recompute_normed_x``, ``recompute_uvqk``, ``recompute_y``), the ranker
trainer's per-step random streams, its trace, `RowWiseAdagrad`'s
``initial_acc`` and the kernels' build cache key, on the CPU.

The JAX package checks its policy by the compiled peak memory on a TPU
(`tests/test_recompute.py`). Here the stand-in is what the forward keeps
for the backward, counted with `torch.autograd.graph.saved_tensors_hooks`
(parameters left out). Recomputation changes no number: gradients with and
without it are compared bit for bit, with dropout on.
"""

import copy
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from generative_recommenders_tpu.parallel.optimizers import rowwise_adagrad
from generative_recommenders_tpu_torch.configs import dlrm as t_configs
from generative_recommenders_tpu_torch.data.dlrm_dataset import DLRMv3RandomDataset
from generative_recommenders_tpu_torch.modules import stu as t_stu
from generative_recommenders_tpu_torch.parallel import optimizers as t_opt
from generative_recommenders_tpu_torch.train import dlrm_train as t_train

FLAGS = {
    "all": (True, True, True),
    "none": (False, False, False),
    "keep_normed_x": (False, True, True),
    "keep_uvqk": (True, False, True),
    "keep_y": (True, True, False),
}
SMALL = dict(
    hstu_attn_num_layers=3, hstu_embedding_table_dim=16, hstu_transducer_embedding_dim=32,
    hstu_attn_linear_dim=16, hstu_attn_qk_dim=16, hstu_num_heads=2,
    num_position_buckets=128, num_time_buckets=64,
    contextual_feature_to_min_uih_length=(("viewer_id", 10), ("dummy_contexual", 10)),
    hstu_input_dropout_ratio=0.2, hstu_linear_dropout_rate=0.3,
)
HASH, BATCH = 64, 4


def _stack_step(flags, group_norm=False, deterministic_algorithms=False):
    """One forward and backward of a 3-layer stack with dropout 0.3 from one
    generator seed: (output, input gradient, {parameter: gradient}, bytes
    kept for the backward outside the parameters)."""
    n, u, y = flags
    cfg = t_stu.STULayerConfig(16, 2, 8, 8, output_dropout_ratio=0.3, contextual_seq_len=2,
                               use_group_norm=group_norm, recompute_normed_x=n, recompute_uvqk=u,
                               recompute_y=y)
    stack = t_stu.STUStack((cfg,) * 3, torch.Generator().manual_seed(0))
    params = {p.data_ptr() for p in stack.parameters()}
    x = torch.randn(3, 21, 16, generator=torch.Generator().manual_seed(1)).requires_grad_()
    kept = []

    def pack(t):
        if t.data_ptr() not in params:
            kept.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = stack(x, torch.tensor([21, 9, 14]), torch.tensor([2, 1, 3]), False,
                    torch.Generator().manual_seed(5))
    torch.use_deterministic_algorithms(deterministic_algorithms)
    try:
        (out * torch.linspace(-1, 1, 16)).sum().backward()
    finally:
        torch.use_deterministic_algorithms(False)
    return out, x.grad, {n_: p.grad for n_, p in stack.named_parameters()}, sum(kept)


@pytest.mark.parametrize("group_norm", [False, True], ids=["layer_norm", "group_norm"])
@pytest.mark.parametrize("flags", ["all", "keep_normed_x", "keep_uvqk", "keep_y"])
def test_recompute_gives_bit_equal_gradients(flags, group_norm):
    """Each flag combination against no recomputation: the output, the input
    gradient and every parameter's gradient bit for bit, with dropout on
    (the recomputation draws the forward's masks again); under
    deterministic algorithms too."""
    want = _stack_step(FLAGS["none"], group_norm)
    for det in (False, True):
        got = _stack_step(FLAGS[flags], group_norm, deterministic_algorithms=det)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert got[2].keys() == want[2].keys()
        for name in want[2]:
            assert torch.equal(got[2][name], want[2][name]), name


def test_recompute_keeps_fewer_bytes():
    """What the forward keeps for the backward: with every flag on, the
    layers' inputs and attention outputs only; each flag turned off keeps
    its value as well; no recomputation keeps every intermediate."""
    kept = {name: _stack_step(flags)[3] for name, flags in FLAGS.items()}
    B, N, D, hH = 3, 21, 16, 16
    x_and_attn = 3 * 4 * B * N * (D + hH)  # three layers, float32
    assert kept["all"] <= x_and_attn + 3 * 2 * 8 * B  # and the int64 lengths and targets
    assert kept["all"] < kept["keep_y"] < kept["none"]
    assert kept["all"] < kept["keep_normed_x"] < kept["none"]
    assert kept["all"] < kept["keep_uvqk"] < kept["none"]
    assert kept["none"] > 4 * kept["all"]


def test_recompute_never_runs_the_attention_forward_again(monkeypatch):
    """With recomputation, the backward takes the attention's gradient from
    `hstu_mha_bwd_cuda` once per layer (K2 on the card) and calls the
    attention's forward (K1 on the card) not at all: three forwards and
    three backwards for three layers."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = t_stu.hstu_mha_dense_cuda, t_stu.hstu_mha_bwd_cuda

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(t_stu, "hstu_mha_dense_cuda", count("fwd", fwd))
    monkeypatch.setattr(t_stu, "hstu_mha_bwd_cuda", count("bwd", bwd))
    _stack_step(FLAGS["all"])
    assert calls == {"fwd": 3, "bwd": 3}
    calls.update(fwd=0, bwd=0)
    _stack_step(FLAGS["none"])  # plain autograd through the plain attention
    assert calls == {"fwd": 3, "bwd": 0}


def _trainer(ckpt_dir=None, save_every=0):
    cfg = dataclasses.replace(t_configs.get_hstu_configs("debug", max_uih_len=24, max_num_candidates=6), **SMALL)
    tables = t_configs.get_embedding_table_config("debug", hash_size=HASH, dim=16)
    return t_train.DlrmTrainer(cfg, tables, t_train.DlrmTrainConfig(ckpt_dir=ckpt_dir, save_every=save_every),
                               device="cpu", seed=3)


def _batches(n):
    cfg = dataclasses.replace(t_configs.get_hstu_configs("debug", max_uih_len=24, max_num_candidates=6), **SMALL)
    return list(DLRMv3RandomDataset(cfg, hash_size=HASH, batch_size=BATCH, seed=0).batches(n))


def test_a_resumed_run_draws_what_an_uninterrupted_one_draws(tmp_path):
    """Four steps in one run, against two steps, a checkpoint, and two more
    in a fresh trainer restored from it (the optimizers' state carried over
    in memory: checkpoints hold the parameters only, as in the JAX package):
    every parameter bit for bit, dropout on. The checkpoint is the end of a
    two-step run, or one written during a three-step run (``save_every``
    2): each is numbered by the steps trained before it. The masks come
    from (seed, step), not from a generator that advanced through the run,
    so the resumed steps 2 and 3 draw steps 2 and 3's masks."""
    batches = _batches(4)
    straight = _trainer()
    t_train.train_loop(straight, iter(batches[:2]))
    after_two = copy.deepcopy((straight.sparse_opt.state_dict(), straight.dense_opt.state_dict()))
    t_train.train_loop(straight, iter(batches[2:]))
    assert straight.step == 4
    for save_every, trained, files in ((0, 2, ["2.pt"]), (2, 3, ["2.pt", "3.pt"])):
        ckpt_dir = tmp_path / f"every_{save_every}"
        first = _trainer(str(ckpt_dir), save_every)
        t_train.train_loop(first, iter(batches[:trained]))
        assert sorted(os.listdir(ckpt_dir)) == files
        resumed = _trainer()
        resumed.restore(str(ckpt_dir), 2)
        sparse_state, dense_state = copy.deepcopy(after_two)  # the optimizers update their state in place
        resumed.sparse_opt.load_state_dict(sparse_state)
        resumed.dense_opt.load_state_dict(dense_state)
        t_train.train_loop(resumed, iter(batches[2:]))
        assert resumed.step == 4
        for (name, a), b in zip(straight.model.named_parameters(), resumed.model.parameters()):
            assert torch.equal(a, b), (save_every, name)
    # the streams differ from step to step and from each other
    g0, s0 = straight.generators(0)
    g2, s2 = straight.generators(2)
    draws = [torch.rand(8, generator=g) for g in (g0, g2, s0, s2)]
    assert all(not torch.equal(draws[i], draws[j]) for i in range(4) for j in range(i))


def test_output_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    """`output_trace` over 36 steps of a small ranker: the profiler skips 10,
    warms up 20 and records 5, then writes one Chrome trace holding those
    steps' events (on the card the attention kernels among them). The CLI's
    flags reach the loop: `--output_trace` over too few steps writes none,
    `--debug_nans` runs the steps under anomaly detection."""
    cfg = dataclasses.replace(
        t_configs.get_hstu_configs("debug", max_uih_len=24, max_num_candidates=6),
        **{**SMALL, "hstu_attn_num_layers": 1},
    )
    trainer = t_train.DlrmTrainer(
        cfg, t_configs.get_embedding_table_config("debug", hash_size=HASH, dim=16),
        t_train.DlrmTrainConfig(output_trace=True), device="cpu",
    )
    monkeypatch.chdir(tmp_path)
    batches = list(DLRMv3RandomDataset(cfg, hash_size=HASH, batch_size=2, seed=0).batches(36))
    out = t_train.train_loop(trainer, iter(batches))
    assert len(out["losses"]) == 36 and np.isfinite(out["losses"]).all()
    assert out["trace_paths"] == [os.path.join("tmp", "trace", "trace_0.json")]
    with open(out["trace_paths"][0]) as f:
        events = json.load(f)["traceEvents"]
    steps = {e["name"] for e in events if e.get("name", "").startswith("ProfilerStep#")}
    assert steps == {f"ProfilerStep#{i}" for i in range(30, 35)}
    assert any(e.get("name") == "aten::mm" for e in events)

    from generative_recommenders_tpu_torch.cli import train_ranker

    out = train_ranker.main(["--device", "cpu", "--num_batches", "2", "--batch_size", "2", "--max_uih_len", "16",
                             "--max_num_candidates", "4", "--hash_size", "50", "--output_trace", "--debug_nans",
                             "--stochastic_depth", "0.2", "--l2_max_len", "8"])
    assert len(out["losses"]) == 2 and out["trace_paths"] == [] and not torch.is_anomaly_enabled()
    assert out["trainer"].hstu_cfg.hstu_l2_max_len == 8


def test_rowwise_adagrad_initial_acc_matches_jax():
    """Three updates from ``initial_acc`` 0.1 (row accumulators only; an
    elementwise one starts at 0 in both packages): parameters and
    accumulators within rtol 1e-6 (float32)."""
    rng = np.random.default_rng(4)
    params = {"t": rng.standard_normal((6, 4)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    tx = rowwise_adagrad(learning_rate=0.05, eps=1e-8, initial_acc=0.1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.as_tensor(v.copy())) for k, v in params.items()}
    opt = t_opt.RowWiseAdagrad(list(tp.values()), lr=0.05, eps=1e-8, initial_acc=0.1)
    for _ in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        updates, state = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, state, jp)
        jp = {k: jp[k] + updates[k] for k in jp}
        for k, p in tp.items():
            p.grad = torch.as_tensor(grads[k])
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=0)
        np.testing.assert_allclose(opt.state[tp[k]]["acc"].numpy(), np.asarray(state.acc[k]), rtol=1e-6)


def test_kernel_cache_is_keyed_by_the_source_hash(tmp_path, monkeypatch, capsys):
    """A built kernel is current only while the hash stamped beside it is
    that of its source, the shared headers and the flags: an edit to a
    header makes it stale, a new modification time alone does not. The
    warm-up CLI exits nonzero when a build cannot run or a kernel is
    unknown."""
    import shutil

    from generative_recommenders_tpu_torch.cli import warm_cache
    from generative_recommenders_tpu_torch.ops.cuda import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    os.makedirs(build.BUILD_DIR)
    name = "hstu_mha_fwd"
    open(build.library_path(name), "wb").close()
    assert build._stale(name)  # no stamp
    with open(build.library_path(name) + ".sha256", "w") as f:
        f.write(build.source_hash(name) + "\n")
    assert not build._stale(name)
    header = csrc / build._HEADERS[0]
    os.utime(header, (0, 2e9))  # newer than the library, same text
    assert not build._stale(name)
    header.write_text(header.read_text() + "\n// an edit\n")
    assert build._stale(name)

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    for argv in ([], ["no_such_kernel"]):
        with pytest.raises(SystemExit) as e:
            warm_cache.main(argv)
        assert e.value.code == 1
    assert "nvcc not found" in capsys.readouterr().err
