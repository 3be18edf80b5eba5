"""The dynamic STU wrappers of the PyTorch port (`modules/dynamic_stu.py`:
`SDSTU`, `L2STU`) and their wiring into `STUStack`, `DlrmHSTU` and the
ranker trainer, against the JAX package on the CPU. JAX weights are carried
over by `convert.params_from_flax`; inputs come from numpy with a seed.

The stochastic-depth coins are injected on both sides (the two random
streams differ): the JAX module's ``jax.random.uniform`` and the port's
`SDSTU.skip` return the same given flips, step by step. Dropout rates are 0
wherever the packages are compared.

Tolerances: a forward within 1e-5 (absolute and relative; float32 both
sides, one layer); the ranker loss within rtol 1e-5 and each gradient within
1e-5 of its largest entry (as `test_torch_training.py`); parameters after
two optimizer steps within 3e-2 of their largest change (the optimizers
divide by the gradients' running size, which shows float32 round-off at the
scale of a step: the largest errors seen are 1.07e-2 to 1.09e-2 of it; a
parameter that missed its step is off by about the whole step).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from generative_recommenders_tpu.configs import dlrm as j_configs
from generative_recommenders_tpu.data.dlrm_dataset import DLRMv3RandomDataset
from generative_recommenders_tpu.modules import dynamic_stu as j_dyn
from generative_recommenders_tpu.modules import stu as j_stu
from generative_recommenders_tpu.parallel.mesh import make_mesh
from generative_recommenders_tpu.train import dlrm_train as j_train
from generative_recommenders_tpu_torch.configs import dlrm as t_configs
from generative_recommenders_tpu_torch.convert import params_from_flax
from generative_recommenders_tpu_torch.modules import dynamic_stu as t_dyn
from generative_recommenders_tpu_torch.modules import stu as t_stu
from generative_recommenders_tpu_torch.train import dlrm_train as t_train

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = dict(
    hstu_attn_num_layers=3, hstu_embedding_table_dim=16, hstu_transducer_embedding_dim=32,
    hstu_attn_linear_dim=16, hstu_attn_qk_dim=16, hstu_num_heads=2,
    num_position_buckets=128, num_time_buckets=64,
    contextual_feature_to_min_uih_length=(("viewer_id", 10), ("dummy_contexual", 10)),
    hstu_input_dropout_ratio=0.0, hstu_linear_dropout_rate=0.0,
    hstu_stochastic_depth_ratio=0.5, hstu_l2_max_len=12,
)
HASH, BATCH = 64, 4


def _to_torch(tree):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, tree))


def _layer_cfgs(**over):
    kw = dict(embedding_dim=16, num_heads=2, hidden_dim=8, attention_dim=8, output_dropout_ratio=0.0, **over)
    return j_stu.STULayerConfig(attn_kernel="xla", **kw), t_stu.STULayerConfig(**kw)


def test_sdstu_skip_and_pass():
    """A ratio of 1 always skips in training (the input comes back); a
    deterministic call runs the layer, equal to the JAX wrapper's."""
    jc, tc = _layer_cfgs()
    x = np.random.default_rng(0).standard_normal((2, 8, 16)).astype(np.float32)
    lengths = np.full((2,), 8, np.int32)
    jl = j_dyn.SDSTU(j_stu.STULayer(jc), dropout_ratio=1.0)
    params = jax.jit(jl.init, static_argnums=(3, 4))(
        {"params": jax.random.PRNGKey(0), "stochastic_depth": jax.random.PRNGKey(1)},
        jnp.asarray(x), jnp.asarray(lengths), None, False,
    )
    tl = t_dyn.SDSTU(t_stu.STULayer(tc), dropout_ratio=1.0)
    tl.load_state_dict(_to_torch(params))  # flax adopts the layer as "stu", the port's attribute
    x_t, l_t = torch.as_tensor(x), torch.as_tensor(lengths)
    assert tl(x_t, l_t, None, False, sd_gen=torch.Generator().manual_seed(0)) is x_t
    want = jax.jit(jl.apply, static_argnums=(3, 4))(params, jnp.asarray(x), jnp.asarray(lengths), None, True)
    got = tl(x_t, l_t, None, True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD_TOL)
    assert float((got - x_t).detach().abs().max()) > 0.0
    with pytest.raises(ValueError, match="Generator"):
        t_dyn.SDSTU(t_stu.STULayer(tc), 0.5)(x_t, l_t, None, False)
    # the coin: uniform [0, 1) <= ratio from the given generator
    sd = t_dyn.SDSTU(t_stu.STULayer(tc), 0.3)
    draws = torch.rand(64, generator=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    assert [sd.skip(gen) for _ in range(64)] == [bool(d <= 0.3) for d in draws]


@pytest.mark.parametrize("contextual", [0, 3], ids=["no_context", "context3"])
def test_l2stu_matches_jax(contextual):
    """`L2STU` around one layer: output and every gradient against the JAX
    wrapper; rows before each window pass through unchanged, the contextual
    rows included even where a row is shorter than C + w; the window equals
    the bare layer run on it alone."""
    jc, tc = _layer_cfgs()
    B, N, w = 3, 10, 4
    rng = np.random.default_rng(1)
    lengths = np.array([10, 6, 5], np.int32)
    x = (rng.standard_normal((B, N, 16)) * (np.arange(N)[None, :] < lengths[:, None])[:, :, None])
    x = x.astype(np.float32)
    jl = j_dyn.L2STU(j_stu.STULayer(jc), max_l2_len=w, contextual_seq_len=contextual)
    params = jax.jit(jl.init, static_argnums=(3, 4))(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(lengths), None, True
    )
    loss_w = rng.standard_normal((B, N, 16)).astype(np.float32)

    def j_loss(p, xx):
        out = jl.apply(p, xx, jnp.asarray(lengths), None, True)
        return jnp.sum(out * loss_w), out

    (_, want), (j_gp, j_gx) = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x)
    )
    tl = t_dyn.L2STU(t_stu.STULayer(tc), w, contextual)
    tl.load_state_dict(_to_torch(params))
    x_t = torch.as_tensor(x).requires_grad_()
    got = tl(x_t, torch.as_tensor(lengths), None, True)
    (got * torch.as_tensor(loss_w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD_TOL)
    np.testing.assert_allclose(x_t.grad.numpy(), np.asarray(j_gx), rtol=1e-4, atol=1e-5)
    j_named = _to_torch(j_gp)
    for name, p in tl.named_parameters():
        scale = float(j_named[name].abs().max())
        np.testing.assert_allclose(p.grad.numpy(), j_named[name].numpy(), rtol=0, atol=1e-5 * scale, err_msg=name)
    out = got.detach().numpy()
    for b, n in enumerate(lengths):
        start = max(n - w, contextual)
        np.testing.assert_array_equal(out[b, :start], x[b, :start])  # prefix and context untouched
        np.testing.assert_array_equal(out[b, n:], x[b, n:])
        assert np.abs(out[b, start:n] - x[b, start:n]).max() > 0
        window = np.zeros((1, w, 16), np.float32)  # the window at its width w (the silu normaliser)
        window[0, : n - start] = x[b, start:n]
        alone = tl.stu(torch.as_tensor(window), torch.tensor([n - start]), None, True)
        np.testing.assert_allclose(out[b, start:n], alone[0, : n - start].detach().numpy(), **FWD_TOL)


def _plain(x):
    """Config values with the packages' enums as their values."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return getattr(x, "value", x)


@pytest.mark.parametrize("dataset", ["debug", "movielens-1m", "movielens-20m", "kuairand-1k"])
def test_dlrm_configs_match_the_jax_packages(dataset):
    """`DlrmHSTUConfig` field by field against the JAX package's, the two
    dynamic STU knobs included; only the TPU's ``attn_kernel`` is not
    ported."""
    want = _plain(dataclasses.asdict(j_configs.get_hstu_configs(dataset)))
    got = _plain(dataclasses.asdict(t_configs.get_hstu_configs(dataset)))
    assert set(want) - set(got) == {"attn_kernel"} and set(got) <= set(want)
    assert {k: v for k, v in want.items() if k != "attn_kernel"} == got
    assert got["hstu_stochastic_depth_ratio"] == 0.0 and got["hstu_l2_max_len"] == 0


def test_stack_wiring_matches_jax():
    """`STUStack` wraps every layer in `SDSTU` and the upper half in `L2STU`
    with the inner layer's contextual length 0, keeps the JAX parameter
    names ``layer_i`` (flax binds the layers to the stack) and refuses the
    KV-cache paths."""
    jc, tc = _layer_cfgs(contextual_seq_len=2)
    js = j_stu.STUStack((jc,) * 4, stochastic_depth_ratio=0.5, l2_max_len=4)
    x = jnp.ones((2, 6, 16))
    params = jax.eval_shape(  # the tree's paths are all this needs
        lambda: js.init({"params": jax.random.PRNGKey(0), "stochastic_depth": jax.random.PRNGKey(1)},
                        x, jnp.array([6, 3]), None, False)
    )
    ts = t_stu.STUStack((tc,) * 4, stochastic_depth_ratio=0.5, l2_max_len=4)
    paths = {".".join(str(k.key) for k in path) for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert {p.removeprefix("params.") for p in paths} == set(ts.state_dict())
    assert [type(b).__name__ for b in ts.blocks] == ["SDSTU", "SDSTU", "L2STU", "L2STU"]
    assert [b.stu.stu is ts.layers[i] for i, b in enumerate(ts.blocks) if i >= 2] == [True, True]
    assert [layer.config.contextual_seq_len for layer in ts.layers] == [2, 2, 0, 0]
    assert ts.blocks[2].contextual_seq_len == 2
    with pytest.raises(ValueError, match="KV-cache"):
        ts.prefill(torch.ones(2, 6, 16), torch.tensor([6, 3]), torch.tensor([6, 3]))


@pytest.fixture(scope="module")
def trainers():
    """The JAX `DlrmTrainer` on a 1 x 1 CPU mesh, its initial weights, two
    numpy batches, and a function that makes a port trainer with those
    weights."""
    jcfg = dataclasses.replace(
        j_configs.get_hstu_configs("debug", max_uih_len=24, max_num_candidates=6), **SMALL
    )
    tcfg = dataclasses.replace(
        t_configs.get_hstu_configs("debug", max_uih_len=24, max_num_candidates=6), **SMALL
    )
    jt = j_train.DlrmTrainer(
        jcfg, j_configs.get_embedding_table_config("debug", hash_size=HASH, dim=16),
        j_train.DlrmTrainConfig(batch_size=BATCH, num_batches=2),
        mesh=make_mesh(shape=(1, 1), devices=jax.devices("cpu")[:1]),
    )
    batches = list(DLRMv3RandomDataset(jcfg, hash_size=HASH, batch_size=BATCH, seed=0).batches(2))
    params, opt_state = jt.init_sharded(jax.random.PRNGKey(0), j_train._to_device(batches[0]))
    init = jax.tree_util.tree_map(np.array, params)

    def port():
        tt = t_train.DlrmTrainer(
            tcfg, t_configs.get_embedding_table_config("debug", hash_size=HASH, dim=16),
            t_train.DlrmTrainConfig(), device="cpu",
        )
        tt.model.load_state_dict(_to_torch(init))
        return tt

    return jt, init, opt_state, batches, port


@pytest.fixture
def flips(monkeypatch):
    """Both packages' coins from one list per step. The JAX wrapper's
    uniform draw becomes a host callback that returns 0 (skip) or 1 (run)
    for its layer when the step runs, so one trace serves every step; the
    port's `SDSTU.skip` pops the same flips in layer order."""
    queue = {"jax": [], "torch": []}
    traced = []  # the layer of each draw, in the order jit traces them
    real_uniform = jax.random.uniform

    def j_uniform(key, shape=(), *a, **kw):
        if shape != ():  # a weight's initialiser
            return real_uniform(key, shape, *a, **kw)
        layer = len(traced) % SMALL["hstu_attn_num_layers"]
        traced.append(layer)

        def flip():
            queue["jax"][layer] = None
            return np.float32(0.0 if flips_now[layer] else 1.0)

        return jax.pure_callback(flip, jax.ShapeDtypeStruct((), jnp.float32))

    monkeypatch.setattr(j_dyn.jax.random, "uniform", j_uniform)
    monkeypatch.setattr(t_dyn.SDSTU, "skip", lambda self, gen: queue["torch"].pop(0))
    flips_now = []

    def give(*step_flips):
        flips_now[:] = step_flips
        queue["jax"] = list(step_flips)
        queue["torch"] += step_flips

    def drawn():
        """Whether every flip given was drawn on both sides."""
        return all(f is None for f in queue["jax"]) and not queue["torch"]

    give.drawn = drawn
    return give


def test_wrapped_ranker_loss_and_gradients_match_jax(trainers, flips):
    """DlrmHSTU with stochastic depth 0.5 and an L2 window of 12 (of N = 2 +
    24 + 6) on three layers, layer 1 skipped: the loss and every gradient
    against `jax.value_and_grad` of the JAX trainer's loss; the skipped
    layer's parameters get no gradient in the port (zeros in JAX)."""
    jt, init, _, batches, port = trainers
    tt = port()
    flips(False, True, False)
    (loss, _), grads = jax.jit(jax.value_and_grad(jt._loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, init), j_train._to_device(batches[0]), jax.random.PRNGKey(1)
    )
    got, *_ = tt.loss(t_train.to_device(batches[0], tt.device))
    got.backward()
    assert flips.drawn()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    want = _to_torch(grads)
    named = dict(tt.model.named_parameters())
    assert named.keys() == want.keys()
    skipped = [n for n in named if ".layer_1." in n]
    assert skipped and all(named[n].grad is None for n in skipped)
    assert all(float(want[n].abs().max()) == 0.0 for n in skipped)
    for name, p in named.items():
        w = want[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * scale, err_msg=name)


def test_wrapped_ranker_steps_match_jax(trainers, flips):
    """Two optimizer steps, layer 1 run in the first and skipped in the
    second, layer 2 the other way round: every parameter against the JAX
    trainer's. Adam moves a skipped layer's parameters on its momentum, as
    optax does on the JAX package's zero gradient; a port that left the
    gradient None would leave them in place."""
    jt, init, opt_state, batches, port = trainers
    tt = port()
    params = jax.device_put(init, jt._param_sh)  # as the step returns them: one trace serves both
    for step, (raw, fl) in enumerate(zip(batches, [(False, False, True), (False, True, False)])):
        flips(*fl)
        params, opt_state, loss, *_ = jt.train_step(
            params, opt_state, j_train._to_device(raw), jax.random.PRNGKey(step)
        )
        got = tt.train_step(t_train.to_device(raw, tt.device))[0]
        assert flips.drawn()
        np.testing.assert_allclose(got.item(), float(loss), rtol=1e-4, err_msg=f"step {step}")
    assert tt.step == 2
    start, want = _to_torch(init), _to_torch(params)
    for name, p in tt.model.named_parameters():
        step = float((want[name] - start[name]).abs().max())
        assert step > 0, f"{name} was not trained"
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=3e-2 * step, err_msg=name)
