"""The PyTorch port's training slice against the JAX package: the multitask
losses, row-wise Adagrad and the sparse/dense split, DlrmHSTU's loss and
every parameter's gradient, three trainer steps, the metrics, dropout, and
the training CLI on the CPU. JAX weights are carried over by
`convert.params_from_flax`; inputs come from numpy with a seed. The dropout
rates are 0 wherever the two packages are compared, since their random
streams differ."""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from generative_recommenders_tpu.configs import dlrm as j_configs
from generative_recommenders_tpu.data.dlrm_dataset import DLRMv3RandomDataset
from generative_recommenders_tpu.modules import multitask_module as j_mt
from generative_recommenders_tpu.parallel.mesh import make_mesh
from generative_recommenders_tpu.parallel.optimizers import make_dlrm_optimizer, rowwise_adagrad
from generative_recommenders_tpu.train import dlrm_metrics as j_metrics
from generative_recommenders_tpu.train import dlrm_train as j_train
from generative_recommenders_tpu_torch.configs import dlrm as t_configs
from generative_recommenders_tpu_torch.convert import params_from_flax
from generative_recommenders_tpu_torch.modules import multitask_module as t_mt
from generative_recommenders_tpu_torch.modules.stu import STULayer, STULayerConfig
from generative_recommenders_tpu_torch.ops.hstu_compute import dropout
from generative_recommenders_tpu_torch.parallel import optimizers as t_opt
from generative_recommenders_tpu_torch.train import dlrm_metrics as t_metrics
from generative_recommenders_tpu_torch.train import dlrm_train as t_train

SMALL = dict(
    hstu_attn_num_layers=2, hstu_embedding_table_dim=16, hstu_transducer_embedding_dim=32,
    hstu_attn_linear_dim=16, hstu_attn_qk_dim=16, hstu_num_heads=2,
    num_position_buckets=128, num_time_buckets=64,
    contextual_feature_to_min_uih_length=(("viewer_id", 10), ("dummy_contexual", 10)),
    hstu_input_dropout_ratio=0.0, hstu_linear_dropout_rate=0.0,
)
HASH, BATCH = 64, 4


def _tasks(mt):
    return tuple(
        mt.TaskConfig(n, 1 << i, mt.MultitaskTaskType.BINARY_CLASSIFICATION)
        for i, n in enumerate(("click", "like", "follow"))
    ) + (mt.TaskConfig("watch", 0, mt.MultitaskTaskType.REGRESSION),)


def _flax_to_torch(tree):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, tree))


def test_multitask_losses_match_jax():
    """Predictions, stacked labels, weights (an explicit weight for one task,
    the candidate mask for the others, both times the mask) and the per-task
    losses, scaled by causal_multitask_weights. float32; atol = rtol = 1e-5."""
    B, M, D = 3, 5, 16
    rng = np.random.default_rng(0)
    user, item = (rng.standard_normal((B, M, D)).astype(np.float32) for _ in range(2))
    labels = {t.task_name: (rng.random((B, M)) < 0.4).astype(np.float32) for t in _tasks(j_mt)}
    labels["watch"] = rng.standard_normal((B, M)).astype(np.float32)
    weights = {"like": rng.random((B, M)).astype(np.float32)}
    valid = np.arange(M)[None, :] < np.array([5, 2, 4])[:, None]
    jm = j_mt.DefaultMultitaskModule(_tasks(j_mt), D, causal_multitask_weights=0.3, prediction_hidden_dim=24)
    params = jm.init(jax.random.PRNGKey(0), user, item, labels, weights, valid)
    want = jm.apply(params, user, item, labels, weights, valid)
    tm = t_mt.DefaultMultitaskModule(_tasks(t_mt), D, 0.3, prediction_hidden_dim=24)
    tm.load_state_dict(_flax_to_torch(params))
    t = torch.as_tensor
    got = tm(t(user), t(item), {k: t(v) for k, v in labels.items()},
             {k: t(v) for k, v in weights.items()}, t(valid))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    preds, none_l, none_w, none_loss = tm(t(user), t(item), {}, {}, t(valid), compute_losses=False)
    assert none_l is none_w is none_loss is None
    torch.testing.assert_close(preds, got[0])


def test_rowwise_adagrad_matches_jax():
    """Three updates of a 2-D (row-wise) and a 1-D (elementwise) parameter
    from the same gradients; float32, rtol 1e-6."""
    rng = np.random.default_rng(1)
    params = {"t": rng.standard_normal((6, 4)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    tx = rowwise_adagrad(learning_rate=0.05, eps=1e-8)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.as_tensor(v.copy())) for k, v in params.items()}
    opt = t_opt.RowWiseAdagrad(list(tp.values()), lr=0.05, eps=1e-8)
    for _ in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        updates, state = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, state, jp)
        jp = {k: jp[k] + updates[k] for k in jp}
        for k, p in tp.items():
            p.grad = torch.as_tensor(grads[k])
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=0)
    np.testing.assert_allclose(opt.state[tp["t"]]["acc"].numpy(), np.asarray(state.acc["t"]), rtol=1e-6)


@pytest.fixture(scope="module")
def trainers():
    """The JAX `DlrmTrainer` on a 1 x 1 CPU mesh and the port's trainer on
    the CPU with the same weights, and a few numpy batches."""
    jcfg = dataclasses.replace(
        j_configs.get_hstu_configs("debug", max_uih_len=24, max_num_candidates=6), **SMALL
    )
    tcfg = dataclasses.replace(
        t_configs.get_hstu_configs("debug", max_uih_len=24, max_num_candidates=6), **SMALL
    )
    jt = j_train.DlrmTrainer(
        jcfg, j_configs.get_embedding_table_config("debug", hash_size=HASH, dim=16),
        j_train.DlrmTrainConfig(batch_size=BATCH, num_batches=3),
        mesh=make_mesh(shape=(1, 1), devices=jax.devices("cpu")[:1]),
    )
    tt = t_train.DlrmTrainer(
        tcfg, t_configs.get_embedding_table_config("debug", hash_size=HASH, dim=16),
        t_train.DlrmTrainConfig(), device="cpu",
    )
    batches = list(DLRMv3RandomDataset(jcfg, hash_size=HASH, batch_size=BATCH, seed=0).batches(3))
    params, opt_state = jt.init_sharded(jax.random.PRNGKey(0), j_train._to_device(batches[0]))
    init = jax.tree_util.tree_map(np.array, params)
    tt.model.load_state_dict(_flax_to_torch(init))
    return jt, tt, batches, init


def test_sparse_dense_labels_match_jax(trainers):
    """The port labels each parameter as `make_dlrm_optimizer` does (read
    from its optax state: a sparse leaf has a row-wise accumulator), the
    item MLP's 2-D kernels included."""
    jt, tt, _, init = trainers
    state = make_dlrm_optimizer(init["params"]).init(init["params"])
    sparse_acc = state.inner_states["sparse"].inner_state.acc
    marks = jax.tree_util.tree_map(
        lambda a: np.array(0.0 if isinstance(a, optax.MaskedNode) else 1.0),
        sparse_acc, is_leaf=lambda a: isinstance(a, optax.MaskedNode),
    )
    want = {n: "sparse" if float(m) else "dense" for n, m in _flax_to_torch(marks).items()}
    got = t_opt.param_labels(tt.model)
    assert got == want
    assert got["item_embedding_mlp.fc1.kernel"] == "sparse"  # the reference's quirk
    assert got["item_embedding_mlp.fc1.bias"] == "dense"
    assert got["embedding_tables_post_id"] == "sparse"


def test_loss_and_gradients_match_jax(trainers):
    """DlrmHSTU's loss (the sum of the per-task losses) and the gradient of
    every parameter against `jax.value_and_grad` of `DlrmTrainer._loss_fn`.
    float32 on both sides, summed in different orders: the loss to rtol
    1e-5, each gradient to atol 1e-5 of its largest entry (the largest
    error seen is 2.1e-6 of it) and rtol 1e-4."""
    jt, tt, batches, init = trainers
    jbatch = j_train._to_device(batches[0])
    (loss, _), grads = jax.jit(jax.value_and_grad(jt._loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, init), jbatch, jax.random.PRNGKey(1)
    )
    model = tt.model
    model.zero_grad(set_to_none=True)
    got, *_ = tt.loss(t_train.to_device(batches[0], tt.device))
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    want = _flax_to_torch(grads)
    named = dict(model.named_parameters())
    assert named.keys() == want.keys()
    for name, p in named.items():
        w = want[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * scale, err_msg=name)


def test_train_steps_match_jax(trainers):
    """Three optimizer steps (row-wise Adagrad on the tables and the item
    MLP's kernels, Adam on the rest) from the same weights on the same
    batches: the loss of each step within rtol 1e-4. Then every parameter's
    change over the three steps within 1e-2 of its largest change: both
    optimizers divide each gradient by its own running size, so an entry
    whose gradient is near float32 round-off still moves by up to the
    learning rate, and the two packages' round-off shows at the scale of
    the step (the largest error seen is 2.6e-3 of it); a missing or wrong
    optimizer is off by the whole step. And every row-wise Adagrad
    accumulator within 1e-3 of its largest entry (sums of squared
    gradients; the largest error seen is 1.2e-4 of it)."""
    jt, _, batches, init = trainers
    tcfg = dataclasses.replace(
        t_configs.get_hstu_configs("debug", max_uih_len=24, max_num_candidates=6), **SMALL
    )
    tt = t_train.DlrmTrainer(
        tcfg, t_configs.get_embedding_table_config("debug", hash_size=HASH, dim=16),
        t_train.DlrmTrainConfig(), device="cpu",
    )
    tt.model.load_state_dict(_flax_to_torch(init))
    params, opt_state = jt.init_sharded(jax.random.PRNGKey(0), j_train._to_device(batches[0]))
    for step, raw in enumerate(batches):
        params, opt_state, loss, *_ = jt.train_step(
            params, opt_state, j_train._to_device(raw), jax.random.PRNGKey(step)
        )
        got = tt.train_step(t_train.to_device(raw, tt.device))[0]
        np.testing.assert_allclose(got.item(), float(loss), rtol=1e-4, err_msg=f"step {step}")
    named = dict(tt.model.named_parameters())
    start, want = _flax_to_torch(init), _flax_to_torch(params)
    sparse_acc = opt_state.inner_states["sparse"].inner_state.acc
    want_acc = _flax_to_torch(jax.tree_util.tree_map(
        lambda a: np.zeros(1) if isinstance(a, optax.MaskedNode) else a,
        sparse_acc, is_leaf=lambda a: isinstance(a, optax.MaskedNode),
    ))
    labels = t_opt.param_labels(tt.model)
    assert named.keys() == want.keys()
    for name, p in named.items():
        step = float((want[name] - start[name]).abs().max())
        assert step > 0, f"{name} was not trained"
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-2 * step, err_msg=name)
        if labels[name] == "sparse":
            w = want_acc[name]
            np.testing.assert_allclose(tt.sparse_opt.state[p]["acc"].numpy(), w.numpy(), rtol=0,
                                       atol=1e-3 * float(w.abs().max()), err_msg=f"{name} accumulator")


def test_eval_matches_jax(trainers):
    """`eval_step` (no dropout) and `eval_loop`'s metrics over three batches
    against the JAX trainer's from the same weights: predictions and NE to
    rtol 1e-5 (float32), AUC exactly (no prediction pair is close enough to
    swap its rank)."""
    jt, _, batches, init = trainers
    tcfg = dataclasses.replace(
        t_configs.get_hstu_configs("debug", max_uih_len=24, max_num_candidates=6), **SMALL
    )
    tt = t_train.DlrmTrainer(
        tcfg, t_configs.get_embedding_table_config("debug", hash_size=HASH, dim=16),
        t_train.DlrmTrainConfig(), device="cpu",
    )
    tt.model.load_state_dict(_flax_to_torch(init))
    params = jax.tree_util.tree_map(jnp.asarray, init)
    want_preds = jt.eval_step(params, j_train._to_device(batches[0]))[0]
    got_preds = tt.eval_step(t_train.to_device(batches[0], tt.device))[0]
    np.testing.assert_allclose(got_preds.numpy(), np.asarray(want_preds), rtol=1e-5, atol=1e-6)
    want, got = j_train.eval_loop(jt, params, iter(batches)), t_train.eval_loop(tt, iter(batches))
    assert got.keys() == want.keys() == {"vvp100/ne", "vvp100/auc"}
    np.testing.assert_allclose(got["vvp100/ne"], want["vvp100/ne"], rtol=1e-5)
    assert got["vvp100/auc"] == want["vvp100/auc"]


def test_dropout_scaling_and_determinism():
    x = torch.ones(1_000_000)
    y = dropout(x, 0.3, torch.Generator().manual_seed(0))
    kept = y != 0
    # 1e6 draws: the kept share's standard deviation is 4.6e-4
    assert abs(kept.float().mean().item() - 0.7) < 3e-3
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    torch.testing.assert_close(dropout(x, 0.3, torch.Generator().manual_seed(0)), y)
    assert dropout(x, 0.0, None) is x
    with pytest.raises(ValueError):
        dropout(x, 0.3, None)

    layer = STULayer(STULayerConfig(16, 2, 8, 8, output_dropout_ratio=0.5), torch.Generator().manual_seed(0))
    xs = torch.randn(2, 7, 16, generator=torch.Generator().manual_seed(1))
    lengths = torch.tensor([7, 4])
    base = layer(xs, lengths)
    torch.testing.assert_close(layer(xs, lengths, deterministic=True, gen=torch.Generator()), base)
    assert not torch.allclose(layer(xs, lengths, deterministic=False, gen=torch.Generator().manual_seed(2)), base)


def test_metrics_match_jax():
    """NE and AUC (classification), MSE and MAE (regression) over three
    batches: the same numpy code on both sides, so equal to rtol 1e-12."""
    rng = np.random.default_rng(2)
    jm, tm = j_metrics.MetricsLogger(_tasks(j_mt)), t_metrics.MetricsLogger(_tasks(t_mt))
    for _ in range(3):
        preds = rng.random((4, 3, 5)).astype(np.float32)
        preds[1, 0, :2] = preds[1, 0, 2]  # score ties
        labels = (rng.random((4, 3, 5)) < 0.5).astype(np.float32)
        weights = (rng.random((4, 3, 5)) < 0.8).astype(np.float32)
        jm.update(preds, labels, weights)
        tm.update(torch.as_tensor(preds), torch.as_tensor(labels), torch.as_tensor(weights))
    want, got = jm.compute(), tm.compute()
    assert got.keys() == want.keys() == {
        "click/ne", "click/auc", "like/ne", "like/auc", "follow/ne", "follow/auc", "watch/mse", "watch/mae"
    }
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)


CLI = ["--num_batches", "3", "--batch_size", "4", "--max_uih_len", "24",
       "--max_num_candidates", "6", "--hash_size", "100"]


def test_train_cli_on_cpu(tmp_path):
    """Three steps on the CPU, logging the loss and the metrics of the
    first step to TensorBoard."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    from generative_recommenders_tpu_torch.cli import train_ranker

    out = train_ranker.main(["--device", "cpu", "--tb_log_dir", str(tmp_path), *CLI])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert out["examples_per_s"] > 0
    assert np.isfinite(out["metrics"]["vvp100/ne"])
    events = EventAccumulator(str(tmp_path)).Reload()
    assert {"losses/total", "train/vvp100/ne"} <= set(events.Tags()["scalars"])
    (logged,) = events.Scalars("losses/total")
    assert logged.step == 0
    np.testing.assert_allclose(logged.value, out["losses"][0], rtol=1e-6)


def test_train_cli_refuses_to_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from generative_recommenders_tpu_torch.cli import train_ranker

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_ranker.main(CLI)
    with pytest.raises(SystemExit):  # flags the port cannot honour
        train_ranker.main(["--device", "cpu", "--mesh", "2x2", *CLI])
