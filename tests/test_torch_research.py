"""The PyTorch port's research stack (HSTU sequential retrieval: model,
losses, sampler, features, datasets, eval metrics, trainer, presets and CLI)
against the JAX package, on the CPU at a small size. JAX weights are carried
over by `convert.params_from_flax`; inputs come from numpy with a seed. The
dropout rates are 0 and the negatives are injected wherever the two packages
are compared, since their random streams differ.

On the CPU the port's attention wrappers compute their plain versions, which
follow the kernels: rows at or past a row's length are 0. The JAX package's
``attn_kernel="pallas"`` path (interpret mode here) does the same, so every
row is compared against it; its ``"xla"`` path masks causally only, so rows
below each length are compared against that one.

Tolerances: forward 2e-4 (absolute and relative; float32 on both sides,
sums in other orders through a few layers); a gradient within 2e-4 of its
own largest entry; the losses of 20 training steps within 1e-3 relative.
"""

import dataclasses
import importlib

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from generative_recommenders_tpu.configs import research as j_presets
from generative_recommenders_tpu.data import dataset as j_data
from generative_recommenders_tpu.data import features as j_features
from generative_recommenders_tpu.models import hstu as j_hstu
from generative_recommenders_tpu.models import losses as j_losses
from generative_recommenders_tpu.models import sequential as j_seq
from generative_recommenders_tpu.train import eval_metrics as j_eval
from generative_recommenders_tpu_torch.cli import train_research as t_cli
from generative_recommenders_tpu_torch.configs import research as t_presets
from generative_recommenders_tpu_torch.convert import params_from_flax
from generative_recommenders_tpu_torch.data import dataset as t_data
from generative_recommenders_tpu_torch.data import features as t_features
from generative_recommenders_tpu_torch.models import hstu as t_hstu
from generative_recommenders_tpu_torch.models import losses as t_losses
from generative_recommenders_tpu_torch.models import sequential as t_seq
from generative_recommenders_tpu_torch.models.samplers import LocalNegativesSampler
from generative_recommenders_tpu_torch.train import eval_metrics as t_eval

# the packages' `train` re-exports the function `train_loop` under the module's name
j_train = importlib.import_module("generative_recommenders_tpu.train.train_loop")
t_train = importlib.import_module("generative_recommenders_tpu_torch.train.train_loop")

FWD_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = 2e-4  # of each gradient's largest entry
NUM_ITEMS = 120
SMALL = dict(
    main_module="HSTU", num_items=NUM_ITEMS, max_sequence_len=36, gr_output_length=3,
    item_embedding_dim=32, num_blocks=2, num_heads=2, dqk=16, dv=16,
    linear_dropout_rate=0.0, dropout_rate=0.0,
)  # N = 36 + 3 + 1 = 40


def _flax_to_torch(tree):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, tree))


def _batch(seed, B, max_len, num_items=NUM_ITEMS):
    """One numpy batch as `batch_iterator` stacks it: sorted unix-like
    timestamps, lengths from 1 to max_len with one full row."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, max_len + 1, size=(B,))
    lengths[0] = max_len
    live = np.arange(max_len)[None, :] < lengths[:, None]
    ts = 1_400_000_000 + np.cumsum(rng.integers(60, 86400, size=(B, max_len + 1)), axis=1)
    return {
        "user_id": np.arange(1, B + 1, dtype=np.int64),
        "historical_ids": rng.integers(1, num_items + 1, size=(B, max_len)) * live,
        "historical_ratings": rng.integers(1, 6, size=(B, max_len)) * live,
        "historical_timestamps": ts[:, :-1] * live,
        "history_lengths": lengths.astype(np.int64),
        "target_ids": rng.integers(1, num_items + 1, size=(B,)),
        "target_ratings": rng.integers(1, 6, size=(B,)),
        "target_timestamps": ts[np.arange(B), lengths],
    }


def _model_pair(attn_kernel, **over):
    """(JAX model, its params, the port's model with the same weights)."""
    kw = {**SMALL, **over}
    jm = j_seq.SequentialRecommender(j_seq.ModelConfig(attn_kernel=attn_kernel, **kw))
    N = jm.config.total_seq_len
    params = jm.init(
        jax.random.PRNGKey(0), jnp.ones((2,), jnp.int32), jnp.zeros((2, N), jnp.int32),
        {"timestamps": jnp.zeros((2, N), jnp.int32), "ratings": jnp.zeros((2, N), jnp.int32)},
        method=j_seq.SequentialRecommender.initialize,
    )
    tm = t_seq.SequentialRecommender(t_seq.ModelConfig(**kw), torch.Generator().manual_seed(0))
    tm.load_state_dict(_flax_to_torch(params))
    return jm, params, tm


def _assert_rows_close(got, want, lengths, all_rows):
    got, want = got.detach().numpy(), np.asarray(want)
    for b, n in enumerate(lengths):
        n = got.shape[1] if all_rows else int(n)
        np.testing.assert_allclose(got[b, :n], want[b, :n], **FWD_TOL)


# ------------------------------------------------------------------- weights
def test_every_research_parameter_is_carried_over():
    """`params_from_flax` fills every parameter of the port's research model
    from the flax tree and leaves no flax leaf over; layouts are kept."""
    _, params, tm = _model_pair("xla")
    state = _flax_to_torch(params)
    own = dict(tm.named_parameters())
    assert set(state) == set(own) == set(tm.state_dict())
    assert {"embedding_module.item_emb", "input_preproc.pos_emb", "encoder.layer_1.uvqk",
            "encoder.layer_1.o.kernel", "encoder.layer_1.o.bias",
            "encoder.layer_1.rel_attn_bias.pos_w", "encoder.layer_1.rel_attn_bias.ts_w"} <= set(own)
    for name, p in own.items():
        assert tuple(p.shape) == tuple(state[name].shape), name
        torch.testing.assert_close(p.detach(), state[name], rtol=0, atol=0)
    fresh = t_seq.SequentialRecommender(tm.config, torch.Generator().manual_seed(1))
    assert all(torch.isfinite(p).all() and p.abs().sum() > 0 for p in fresh.parameters())


# ------------------------------------------------------------------- encoder
@pytest.mark.parametrize("attn_kernel", ["pallas", "xla"])
@pytest.mark.parametrize("shape", [(3, 40, 40), (2, 260, 300)], ids=["N40", "N260"])
def test_encoder_matches_jax(attn_kernel, shape):
    """`HSTUEncoder` with the relative bias: against the Pallas path (the
    relative-bias kernels, interpret mode) on all rows, against the XLA
    path on rows below each length. N = 260 with a larger table (Nm = 300)
    is the size at which the JAX package's "auto" takes the kernels."""
    B, N, Nm = shape
    D = 16
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, N, D)).astype(np.float32) * 0.3
    lengths = rng.integers(1, N, size=(B,)).astype(np.int32)
    lengths[0] = N
    ts = 1_600_000_000 + np.cumsum(rng.integers(1, 90000, size=(B, N)), axis=1)
    kw = dict(embedding_dim=D, num_blocks=2, num_heads=2, attention_dim=8, linear_dim=8,
              linear_dropout_rate=0.0, max_total_seq_len=Nm)
    je = j_hstu.HSTUEncoder(attn_kernel=attn_kernel, **kw)
    params = je.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(lengths), jnp.asarray(ts), True)
    want = je.apply(params, jnp.asarray(x), jnp.asarray(lengths), jnp.asarray(ts), True)
    te = t_hstu.HSTUEncoder(**kw, gen=torch.Generator().manual_seed(0))
    te.load_state_dict(_flax_to_torch(params))
    got = te(torch.as_tensor(x), torch.as_tensor(lengths), torch.as_tensor(ts), deterministic=True)
    _assert_rows_close(got, want, lengths, all_rows=attn_kernel == "pallas")


@pytest.mark.parametrize("attn_kernel", ["pallas", "xla"])
def test_encoder_without_bias_matches_jax(attn_kernel):
    """Bias disabled: the dense attention (K1's plain version here), causal,
    with lengths, and ``concat_ua``."""
    B, N, D = 3, 24, 16
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, N, D)).astype(np.float32) * 0.3
    lengths = np.array([N, 7, 1], np.int32)
    kw = dict(embedding_dim=D, num_blocks=2, num_heads=2, attention_dim=8, linear_dim=8,
              linear_dropout_rate=0.0, enable_relative_attention_bias=False, concat_ua=True)
    je = j_hstu.HSTUEncoder(attn_kernel=attn_kernel, **kw)
    params = je.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(lengths), None, True)
    want = je.apply(params, jnp.asarray(x), jnp.asarray(lengths), None, True)
    te = t_hstu.HSTUEncoder(**kw, gen=torch.Generator().manual_seed(0))
    te.load_state_dict(_flax_to_torch(params))
    got = te(torch.as_tensor(x), torch.as_tensor(lengths), None, deterministic=True)
    _assert_rows_close(got, want, lengths, all_rows=attn_kernel == "pallas")


# --------------------------------------------------------------------- model
@pytest.mark.parametrize("attn_kernel", ["pallas", "xla"])
def test_sequential_recommender_matches_jax(attn_kernel):
    """The whole model as the train step drives it (target scattered into
    the ids, its timestamp past the length) and `encode` as eval does."""
    jm, params, tm = _model_pair(attn_kernel)
    batch = _batch(4, B=4, max_len=36)
    jf, j_tgt, _ = j_features.seq_features_from_row(
        {k: jnp.asarray(v) for k, v in batch.items()}, max_output_length=4
    )
    tf, t_tgt, _ = t_features.seq_features_from_row(
        {k: torch.as_tensor(v) for k, v in batch.items()}, max_output_length=4
    )
    j_ids = j_features.scatter_target_into_ids(jf.past_ids, jf.past_lengths, j_tgt)
    t_ids = t_features.scatter_target_into_ids(tf.past_ids, tf.past_lengths, t_tgt)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    j_emb = jm.apply(params, j_ids, method=j_seq.SequentialRecommender.get_item_embeddings)
    t_emb = tm.get_item_embeddings(t_ids)
    np.testing.assert_allclose(t_emb.detach().numpy(), np.asarray(j_emb), rtol=0, atol=0)
    want = jm.apply(params, jf.past_lengths, j_ids, j_emb, jf.past_payloads, True)
    got = tm(tf.past_lengths, t_ids, t_emb, tf.past_payloads, deterministic=True)
    _assert_rows_close(got, want, batch["history_lengths"], all_rows=attn_kernel == "pallas")

    j_emb = jm.apply(params, jf.past_ids, method=j_seq.SequentialRecommender.get_item_embeddings)
    want_q = jm.apply(params, jf.past_lengths, jf.past_ids, j_emb, jf.past_payloads, True,
                      method=j_seq.SequentialRecommender.encode)
    got_q = tm.encode(tf.past_lengths, tf.past_ids, tm.get_item_embeddings(tf.past_ids), tf.past_payloads)
    np.testing.assert_allclose(got_q.detach().numpy(), np.asarray(want_q), **FWD_TOL)
    items = np.random.default_rng(5).standard_normal((1, 9, 32)).astype(np.float32)
    want_s, _ = jm.apply(params, want_q, jnp.asarray(items), method=j_seq.SequentialRecommender.similarity_fn)
    got_s, aux = tm.similarity_fn(got_q, torch.as_tensor(items))
    np.testing.assert_allclose(got_s.detach().numpy(), np.asarray(want_s), **FWD_TOL)
    assert aux == {}


def test_dropout_is_drawn_from_the_generator():
    """Training mode drops with the given generator: the same seed gives
    the same output, another seed another; deterministic mode draws none."""
    cfg = t_seq.ModelConfig(**{**SMALL, "linear_dropout_rate": 0.3, "dropout_rate": 0.3})
    tm = t_seq.SequentialRecommender(cfg, torch.Generator().manual_seed(0))
    f, tgt, _ = t_features.seq_features_from_row(
        {k: torch.as_tensor(v) for k, v in _batch(6, 3, 36).items()}, max_output_length=4
    )
    emb = tm.get_item_embeddings(f.past_ids)
    run = lambda seed, det=False: tm(  # noqa: E731
        f.past_lengths, f.past_ids, emb, f.past_payloads, det, torch.Generator().manual_seed(seed)
    )
    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))
    assert torch.equal(run(1, det=True), run(2, det=True))


def test_causal_mask_matches_jax():
    from generative_recommenders_tpu.ops.attention_mask import make_causal_mask as j_mask
    from generative_recommenders_tpu_torch.ops.attention_mask import make_causal_mask as t_mask

    np.testing.assert_array_equal(t_mask(7).numpy(), np.asarray(j_mask(7)))
    got = t_mask(5, dtype=torch.bool)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_mask(5, dtype=jnp.bool_)))


# -------------------------------------------------------------------- losses
def test_losses_match_jax():
    B, N, R, D = 3, 7, 5, 8
    rng = np.random.default_rng(7)
    out, pos = (rng.standard_normal((B, N, D)).astype(np.float32) for _ in range(2))
    neg = rng.standard_normal((B, N, R, D)).astype(np.float32)
    ids = rng.integers(0, 6, size=(B, N))
    neg_ids = rng.integers(1, 6, size=(B, N, R))  # some collide with their positive
    w = (ids != 0).astype(np.float32)
    ratings = rng.integers(0, 2, size=(B, N)).astype(np.float32)
    j, t = jnp.asarray, torch.as_tensor
    pairs = [
        (j_losses.sampled_softmax_loss(j(out), j(pos), j(ids), j(w), j(neg_ids), j(neg), 0.05)[0],
         t_losses.sampled_softmax_loss(t(out), t(pos), t(ids), t(w), t(neg_ids), t(neg), 0.05)[0]),
        (j_losses.sampled_softmax_loss_from_logits(j(out[..., 0]), j(neg[..., 0]), j(ids), j(w), j(neg_ids), 0.1),
         t_losses.sampled_softmax_loss_from_logits(t(out[..., 0]), t(neg[..., 0]), t(ids), t(w), t(neg_ids), 0.1)),
        (j_losses.bce_loss(j(out), j(pos), j(ids), j(w), j(neg_ids[..., :1]), j(neg[:, :, :1]), 0.5)[0],
         t_losses.bce_loss(t(out), t(pos), t(ids), t(w), t(neg_ids[..., :1]), t(neg[:, :, :1]), 0.5)[0]),
        (j_losses.bce_loss_with_ratings(j(out), j(pos), j(ratings), j(w), 0.5)[0],
         t_losses.bce_loss_with_ratings(t(out), t(pos), t(ratings), t(w), 0.5)[0]),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    zero = t_losses.sampled_softmax_loss(t(out), t(pos), t(ids), t(0 * w), t(neg_ids), t(neg), 0.05)[0]
    assert zero.item() == 0.0  # no live position: the clamped denominator


def test_local_sampler_draws_from_the_corpus():
    corpus = torch.tensor([3, 5, 8, 13, 21])
    table = torch.randn(32, 4, generator=torch.Generator().manual_seed(0))
    sampler = LocalNegativesSampler(all_item_ids=corpus, l2_norm=True, l2_norm_eps=1e-6)
    pos = torch.zeros(6, 9, dtype=torch.long)
    draw = lambda seed: sampler(torch.Generator().manual_seed(seed), pos, 50, lambda i: table[i])  # noqa: E731
    ids, emb = draw(0)
    assert ids.shape == (6, 9, 50) and emb.shape == (6, 9, 50, 4)
    assert set(ids.unique().tolist()) == set(corpus.tolist())
    torch.testing.assert_close(emb.norm(dim=-1), torch.ones(6, 9, 50))
    assert torch.equal(draw(0)[0], ids) and not torch.equal(draw(1)[0], ids)
    # the clamp sits before the square root: a zero row stays finite, also in its gradient
    x = torch.zeros(2, 4, requires_grad=True)
    sampler.normalize_embeddings(x).sum().backward()
    assert torch.isfinite(x.grad).all()


# ------------------------------------------------------------------- trainer
class _FixedNegatives:
    """A sampler for both packages: ids that depend on the positives only
    (not on the key or generator), so both sides train on the same
    negatives."""

    def __init__(self, all_item_ids, sampler, xp):
        self.ids, self.sampler, self.xp = all_item_ids, sampler, xp

    def __call__(self, rng, positive_ids, num_to_sample, item_embedding_fn):
        r = self.xp.arange(num_to_sample)
        offsets = (positive_ids[..., None] * 7 + r * 13 + 1) % self.ids.shape[0]
        sampled = self.ids[offsets]
        return sampled, self.sampler.normalize_embeddings(item_embedding_fn(sampled))


def _trainer_pair(attn_kernel, loss_module="SampledSoftmaxLoss", **train_kw):
    """The JAX `ResearchTrainer` and the port's on the CPU, with the same
    weights and the same injected negatives."""
    ids = np.arange(1, NUM_ITEMS + 1)
    kw = dict(local_batch_size=4, eval_batch_size=4, num_negatives=6, loss_module=loss_module,
              learning_rate=1e-3, weight_decay=0.01, **train_kw)
    jt = j_train.ResearchTrainer(
        j_train.TrainConfig(model=j_seq.ModelConfig(attn_kernel=attn_kernel, **SMALL), **kw), ids
    )
    jt.sampler = _FixedNegatives(jnp.asarray(ids), jt.sampler, jnp)
    params = jt.init_params(jax.random.PRNGKey(0))
    tt = t_train.ResearchTrainer(
        t_train.TrainConfig(model=t_seq.ModelConfig(**SMALL), **kw), ids, device="cpu"
    )
    tt.sampler = _FixedNegatives(torch.as_tensor(ids), tt.sampler, torch)
    tt.model.load_state_dict(_flax_to_torch(params))
    return jt, params, tt


@pytest.mark.parametrize("loss_module", ["SampledSoftmaxLoss", "BCELoss"])
def test_loss_and_gradients_match_jax(loss_module):
    """One batch's loss and every parameter's gradient, the tables of every
    layer's relative bias included, against `jax.grad` through the JAX
    trainer's loss on its relative-bias Pallas path."""
    jt, params, tt = _trainer_pair("pallas", loss_module)
    batch = _batch(8, B=4, max_len=36)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (want_loss, _), want = jax.value_and_grad(jt._loss, has_aux=True)(params, jb, jax.random.PRNGKey(1))
    loss, _ = tt.loss(t_train.to_device(batch, tt.device))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = _flax_to_torch(want)
    got = {n: p.grad for n, p in tt.model.named_parameters()}
    assert set(got) == set(want) and all(g is not None for g in got.values())
    for name, w in want.items():
        scale = w.abs().max().item()
        assert scale > 0, f"{name}: the reference gradient is all zero"
        err = (got[name] - w).abs().max().item() / scale
        assert err <= GRAD_TOL, f"{name}: {err:.2e} of the gradient's max"


def test_train_steps_track_jax():
    """20 optimizer steps (AdamW, the warm-up schedule, weight decay) from
    the same weights, batches and negatives: each step's loss within 1e-3
    relative of the JAX trainer's, and the parameters after the last step
    within 2e-3 of each one's largest entry."""
    jt, params, tt = _trainer_pair("xla", num_warmup_steps=5)
    opt_state = jt.init_opt_state(params)
    rows = [_batch(100 + i, B=4, max_len=36) for i in range(4)]
    j_losses_, t_losses_ = [], []
    for step in range(20):
        batch = rows[step % len(rows)]
        params, opt_state, loss = jt.train_step(params, opt_state, batch, jax.random.PRNGKey(step))
        j_losses_.append(float(loss))
        t_losses_.append(float(tt.train_step(batch)))
    np.testing.assert_allclose(t_losses_, j_losses_, rtol=1e-3)
    assert t_losses_[-1] < t_losses_[0]
    for name, w in _flax_to_torch(params).items():
        got = dict(tt.model.named_parameters())[name].detach()
        assert (got - w).abs().max().item() <= 2e-3 * w.abs().max().item(), name


def test_warmup_schedule_matches_optax():
    cfg = t_train.TrainConfig(model=t_seq.ModelConfig(**SMALL), learning_rate=3e-3, num_warmup_steps=4)
    tt = t_train.ResearchTrainer(cfg, np.arange(1, NUM_ITEMS + 1), device="cpu")
    want = optax.join_schedules(
        [optax.linear_schedule(3e-3 / 4, 3e-3, 4), optax.constant_schedule(3e-3)], [4]
    )
    for step in range(8):
        np.testing.assert_allclose(tt.optimizer.param_groups[0]["lr"], float(want(step)), rtol=1e-6)
        tt.optimizer.step()
        tt.schedule.step()


# ---------------------------------------------------------------------- eval
def test_ranks_and_metrics_match_jax():
    """The same scores through both packages' rank and metric functions:
    seen-id filtering, the sentinel column of ids outside the corpus, a seen
    target, ranks beyond k."""
    B, N = 6, 5
    rng = np.random.default_rng(9)
    corpus = np.array([2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37])
    X = corpus.shape[0]
    scores = rng.standard_normal((B, X)).astype(np.float32)
    col = j_eval.build_id_to_col(corpus, 40)
    np.testing.assert_array_equal(t_eval.build_id_to_col(corpus, 40), col)
    targets = np.array([2, 13, 37, 5, 23, 7])
    past = rng.choice(corpus, size=(B, N))
    past[0, :2] = 0  # padding
    past[1, 0] = 4  # an id outside the corpus: the sentinel column
    past[2, 1] = 37  # the target was seen: a miss
    past[past == targets[:, None]] = 3
    past[2, 1] = 37
    ratings = np.array([5, 1, 4, 3, 5, 4])
    for k in (X, 4):
        want = j_eval.ranks_from_scores(jnp.asarray(scores), jnp.asarray(col), jnp.asarray(targets), jnp.asarray(past), k=k)
        got = t_eval.ranks_from_scores(torch.as_tensor(scores), torch.as_tensor(col), torch.as_tensor(targets), torch.as_tensor(past), k=k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got[2] == t_eval.MAX_K + 1 == j_eval.MAX_K + 1
    assert (got == t_eval.MAX_K + 1).sum() > 1  # ranks beyond k = 4

    q = rng.standard_normal((B, 8)).astype(np.float32)
    items = rng.standard_normal((X, 8)).astype(np.float32)
    want = j_eval.target_ranks(jnp.asarray(q), jnp.asarray(items), jnp.asarray(col), jnp.asarray(targets), jnp.asarray(past), k=X)
    got = t_eval.target_ranks(torch.as_tensor(q), torch.as_tensor(items), torch.as_tensor(col), torch.as_tensor(targets), torch.as_tensor(past), k=X)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    jm = j_eval.metrics_from_ranks(want, jnp.asarray(ratings))
    tm = t_eval.metrics_from_ranks(got, torch.as_tensor(ratings))
    assert set(jm) == set(tm)
    j_acc, t_acc = j_eval.MetricsAccumulator(), t_eval.MetricsAccumulator()
    for _ in range(2):
        j_acc.update(jm)
        t_acc.update(tm)
    want_m, got_m = j_acc.compute(), t_acc.compute()
    assert set(want_m) == set(got_m) and "hr@10_>=4" in got_m
    for key, value in want_m.items():
        np.testing.assert_allclose(got_m[key], value, rtol=1e-6, err_msg=key)
        assert 0.0 <= got_m[key] <= 1.0


def test_eval_epoch_matches_jax():
    """`eval_epoch` over the same batches with the same weights: the same
    metrics, up to ranks that float ties could move (none here)."""
    jt, params, tt = _trainer_pair("pallas")
    batches = [_batch(200 + i, B=4, max_len=36) for i in range(3)]
    want = jt.eval_epoch(params, iter(batches))
    got = tt.eval_epoch(iter(batches))
    assert set(want) == set(got)
    for key in ("hr@10", "hr@50", "ndcg@10", "mrr"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    assert tt.eval_epoch(iter(batches), max_iters=1) != got


# ------------------------------------------------------------------ datasets
def _assert_same_sequences(a, b):
    np.testing.assert_array_equal(a.user_ids, b.user_ids)
    for name in ("item_ids", "ratings", "timestamps"):
        for x, y in zip(getattr(a, name), getattr(b, name), strict=True):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("generator", ["synthetic_user_sequences", "synthetic_user_sequences_vectorized"])
def test_synthetic_corpus_matches_the_jax_packages_copy(generator):
    kw = dict(num_users=40, num_items=90, max_len=20, min_len=3, seed=5)
    want, got = getattr(j_data, generator)(**kw), getattr(t_data, generator)(**kw)
    _assert_same_sequences(got, want)
    assert len(got) == 40 and max(len(x) for x in got.item_ids) <= 20


@pytest.mark.parametrize("ds_kw", [
    dict(ignore_last_n=1), dict(ignore_last_n=0, chronological=False),
    dict(ignore_last_n=1, sample_ratio=0.7, seed=3, shift_id_by=1),
])
def test_dataset_rows_and_batches_match_the_jax_packages_copy(ds_kw):
    seqs = t_data.synthetic_user_sequences(num_users=50, num_items=90, max_len=30, min_len=1, seed=6)
    want_ds = j_data.SequenceDataset(j_data.synthetic_user_sequences(50, 90, 30, 1, seed=6), 16, **ds_kw)
    got_ds = t_data.SequenceDataset(seqs, 16, **ds_kw)
    assert len(got_ds) == len(want_ds) == 50
    np.testing.assert_array_equal(got_ds.all_item_ids(), want_ds.all_item_ids())
    for i in range(50):
        want, got = want_ds.get_row(i), got_ds.get_row(i)
        assert set(want) == set(got)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    if "sample_ratio" in ds_kw:
        return  # the row sampler's generator advances with every row read
    iters = [
        (j_data.batch_iterator(want_ds, 8, shuffle=True, seed=2), t_data.batch_iterator(got_ds, 8, shuffle=True, seed=2)),
        (j_data.batch_iterator(want_ds, 8, shuffle=False, drop_last=False, num_shards=2, shard_index=1),
         t_data.batch_iterator(got_ds, 8, shuffle=False, drop_last=False, num_shards=2, shard_index=1)),
        (j_data.batch_iterator(want_ds, 4, shuffle=True, seed=1, num_shards=2, shard_index=1, shard_contiguous=True),
         t_data.batch_iterator(got_ds, 4, shuffle=True, seed=1, num_shards=2, shard_index=1, shard_contiguous=True)),
        (j_data.prefetched_batch_iterator(want_ds, 8, shuffle=True, seed=2, num_workers=2, prefetch_factor=3),
         t_data.prefetched_batch_iterator(got_ds, 8, shuffle=True, seed=2, num_workers=2, prefetch_factor=3)),
    ]
    for want_it, got_it in iters:
        n = 0
        for want, got in zip(want_it, got_it, strict=True):
            n += 1
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert n > 0


def test_sasrec_csv_loader_matches_the_jax_packages_copy(tmp_path):
    path = tmp_path / "sasrec_format.csv"
    path.write_text(
        "index,user_id,sequence_item_ids,sequence_ratings,sequence_timestamps\n"
        '0,7,"[3, 9, 4]","[5, 1, 3]","[100, 200, 300]"\n'
        '1,9,"12,5","4,2","50,60"\n'
        "2,11,8,5,77\n"
    )
    got = t_data.load_sasrec_format_csv(str(path))
    _assert_same_sequences(got, j_data.load_sasrec_format_csv(str(path)))
    assert [x.tolist() for x in got.item_ids] == [[3, 9, 4], [12, 5], [8]]
    # a one-event user degrades to a cold-start row instead of failing
    row = t_data.SequenceDataset(got, 4, ignore_last_n=1).get_row(2)
    assert row["history_lengths"] == 0 and row["target_ids"] == 8


def test_features_match_jax():
    batch = _batch(10, B=5, max_len=12)
    (jf, j_ids, j_r) = j_features.seq_features_from_row({k: jnp.asarray(v) for k, v in batch.items()}, 3)
    (tf, t_ids, t_r) = t_features.seq_features_from_row({k: torch.as_tensor(v) for k, v in batch.items()}, 3)
    for want, got in ((jf.past_lengths, tf.past_lengths), (jf.past_ids, tf.past_ids), (j_ids, t_ids), (j_r, t_r),
                      (jf.past_payloads["timestamps"], tf.past_payloads["timestamps"]),
                      (jf.past_payloads["ratings"], tf.past_payloads["ratings"])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the target's timestamp sits at index `length`, past the history
    n = batch["history_lengths"]
    np.testing.assert_array_equal(
        tf.past_payloads["timestamps"].numpy()[np.arange(5), n], batch["target_timestamps"]
    )


# ------------------------------------------------------------ presets and CLI
def test_presets_match_the_jax_packages():
    assert list(t_presets.RESEARCH_PRESETS) == list(j_presets.RESEARCH_PRESETS)
    assert len(t_presets.RESEARCH_PRESETS) == 10
    for name, want in j_presets.RESEARCH_PRESETS.items():
        got = t_presets.RESEARCH_PRESETS[name]
        want_d, got_d = dataclasses.asdict(want), dataclasses.asdict(got)
        assert set(want_d) == set(got_d) and set(want_d["model"]) == set(got_d["model"]), name
        assert got_d == want_d, name
    big = t_presets.RESEARCH_PRESETS["ml-3b/hstu-sampled-softmax-n96-seqlen500-large"]
    assert (big.model.total_seq_len, big.model.num_items, big.local_batch_size) == (511, 855_776, 96)


@pytest.mark.parametrize("name", [n for n in j_presets.RESEARCH_PRESETS if "sasrec" in n])
def test_sasrec_presets_raise_at_model_construction(name):
    cfg = t_presets.RESEARCH_PRESETS[name]
    with pytest.raises(NotImplementedError, match="SASRec"):
        t_seq.SequentialRecommender(dataclasses.replace(cfg.model, num_items=10))


@pytest.mark.parametrize("field, value, match", [
    ("sampling_strategy", "in-batch", "in-batch"),
    ("loss_module", "BCELossWithRatings", "BCELossWithRatings"),
    ("stochastic_length_alpha", 1.6, "stochastic_length_alpha"),
    ("seq_len_buckets", (16, 32), "seq_len_buckets"),
    ("runtime_bucketing", True, "runtime_bucketing"),
    ("loss_activation_checkpoint", True, "loss_activation_checkpoint"),
])
def test_trainer_refuses_what_is_not_ported(field, value, match):
    cfg = t_train.TrainConfig(model=t_seq.ModelConfig(**SMALL), **{field: value})
    with pytest.raises(NotImplementedError, match=match):
        t_train.ResearchTrainer(cfg, np.arange(1, 10), device="cpu")


@pytest.mark.parametrize("over, match", [
    (dict(interaction_module_type="MoL"), "MoL"),
    (dict(compute_dtype="bfloat16"), "bfloat16"),
    (dict(remat=True), "remat"),
    (dict(attn_dropout_rate=0.1), "attn_dropout_rate"),
])
def test_model_refuses_what_is_not_ported(over, match):
    with pytest.raises(NotImplementedError, match=match):
        t_seq.SequentialRecommender(t_seq.ModelConfig(**{**SMALL, **over}))


def test_other_refusals():
    tm = t_seq.SequentialRecommender(t_seq.ModelConfig(**SMALL), torch.Generator().manual_seed(0))
    for method in (tm.encode_with_cache, tm.encode_delta):
        with pytest.raises(NotImplementedError, match="KV-cached"):
            method()
    # a relative bias without timestamps needs the dense kernel's bias argument
    with pytest.raises(NotImplementedError, match="without timestamps"):
        tm.encoder(torch.zeros(1, 40, 32), torch.ones(1, dtype=torch.long), None, deterministic=True)
    with pytest.raises(ValueError, match="Unknown main_module"):
        t_seq.SequentialRecommender(t_seq.ModelConfig(**{**SMALL, "main_module": "GRU"}))
    with pytest.raises(ValueError, match="Unknown sampling_strategy"):
        t_train.ResearchTrainer(
            t_train.TrainConfig(model=tm.config, sampling_strategy="global"), np.arange(1, 10), device="cpu"
        )
    seqs = t_data.synthetic_user_sequences(num_users=8, num_items=20, max_len=8, seed=0)
    ds = t_data.SequenceDataset(seqs, 8, ignore_last_n=1)
    with pytest.raises(NotImplementedError, match="checkpoints"):
        t_train.train_loop(t_train.TrainConfig(model=tm.config), ds, ds, ckpt_dir="ckpt", device="cpu")


def test_research_cli_smoke_learns_on_the_cpu():
    """`train_research --smoke --device cpu` on the synthetic corpus with
    the relative bias on (its plain version here), for 16 epochs (at the
    default 4 the eval's 256 users move HR@10 by less than its noise): the
    loss falls and the last epoch's HR@10 is above the first's."""
    out = t_cli.main(["--smoke", "--num_epochs", "16", "--device", "cpu"])
    history, losses = out["history"], out["losses"]
    assert len(history) == 16 and all(np.isfinite(x) for x in losses)
    assert np.mean(losses[-8:]) < np.mean(losses[:8])
    assert history[-1]["hr@10"] > history[0]["hr@10"]
    assert history[-1]["hr@10"] > 10.0 / 200.0  # better than a random ranking
    assert out["examples_per_s"] > 0 and len(out["step_s"]) == len(losses)


def test_research_cli_trains_a_preset_from_a_csv(tmp_path, capsys):
    """A preset over a `sasrec_format.csv`, cut to one epoch; the mid-epoch
    partial eval and ``max_steps`` through `train_loop`."""
    seqs = t_data.synthetic_user_sequences(num_users=130, num_items=60, max_len=12, min_len=4, seed=1)
    lines = ["index,user_id,sequence_item_ids,sequence_ratings,sequence_timestamps"]
    for i, (u, it, r, ts) in enumerate(zip(seqs.user_ids, seqs.item_ids, seqs.ratings, seqs.timestamps)):
        lines.append(f'{i},{u},"{it.tolist()}","{r.tolist()}","{ts.tolist()}"')
    path = tmp_path / "sasrec_format.csv"
    path.write_text("\n".join(lines) + "\n")
    out = t_cli.main(["--preset", "ml-1m/hstu-sampled-softmax-n128", "--data_csv", str(path),
                      "--num_epochs", "1", "--device", "cpu"])
    assert len(out["history"]) == 1 and len(out["losses"]) == 1  # 130 users, batch 128
    assert 0.0 <= out["history"][0]["hr@10"] <= 1.0

    assert t_cli.main(["--list_presets"]) is None
    assert capsys.readouterr().out.split() == list(t_presets.RESEARCH_PRESETS)

    cfg = t_train.TrainConfig(
        model=t_seq.ModelConfig(**{**SMALL, "num_items": 60, "max_sequence_len": 12}),
        local_batch_size=16, eval_batch_size=16, num_epochs=5, num_negatives=4,
        eval_interval=3, partial_eval_num_iters=1, num_workers=0,
    )
    ds = t_data.SequenceDataset(seqs, 12, ignore_last_n=1)
    out = t_train.train_loop(cfg, ds, ds, max_steps=11, device="cpu")
    assert len(out["losses"]) == 11 and len(out["history"]) == 2  # 8 batches an epoch


def test_research_cli_refusals():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):  # the default device is the card
            t_cli.main(["--smoke"])
    for argv in (
        ["--smoke", "--device", "cpu", "--ckpt_dir", "x"],
        ["--smoke", "--device", "cpu", "--multifile_prefix", "x"],
        ["--smoke", "--device", "cpu", "--attn_kernel", "pallas"],
        ["--smoke", "--device", "cpu", "--stochastic_length_alpha", "1.6"],
        ["--smoke", "--device", "cpu", "--seq_len_buckets", "64,128"],
        ["--smoke", "--device", "cpu", "--distributed"],
        ["--smoke", "--device", "cpu", "--num_processes", "2"],
        ["--preset", "ml-1m/hstu-sampled-softmax-n128", "--device", "cpu"],  # no --data_csv
        ["--preset", "no-such-preset", "--data_csv", "x", "--device", "cpu"],
    ):
        with pytest.raises(SystemExit):
            t_cli.main(argv)
