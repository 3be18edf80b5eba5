"""The PyTorch port's SASRec baseline (`models/sasrec.py` and its wiring in
`models/sequential.py` and the research trainer) against the JAX package,
on the CPU. JAX weights are carried over by `convert.params_from_flax`;
inputs come from numpy with a seed. Dropout is 0 and the negatives are
injected wherever the two packages are compared, since their random
streams differ.

Tolerances as in `test_torch_research.py`: forward 2e-4 (absolute and
relative), one step's loss 1e-5 relative, a gradient within 2e-4 of its own
largest entry, the losses of 20 training steps within 1e-3 relative.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from generative_recommenders_tpu.configs import research as j_presets
from generative_recommenders_tpu.data import features as j_features
from generative_recommenders_tpu.models import sasrec as j_sasrec
from generative_recommenders_tpu.models import sequential as j_seq
from generative_recommenders_tpu_torch.configs import research as t_presets
from generative_recommenders_tpu_torch.convert import params_from_flax
from generative_recommenders_tpu_torch.data import features as t_features
from generative_recommenders_tpu_torch.models import sasrec as t_sasrec
from generative_recommenders_tpu_torch.models import sequential as t_seq

j_train = importlib.import_module("generative_recommenders_tpu.train.train_loop")
t_train = importlib.import_module("generative_recommenders_tpu_torch.train.train_loop")

FWD_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = 2e-4  # of each gradient's largest entry
NUM_ITEMS = 120
SMALL = dict(
    main_module="SASRec", num_items=NUM_ITEMS, max_sequence_len=20, gr_output_length=3,
    item_embedding_dim=16, num_blocks=2, num_heads=2, ffn_hidden_dim=24,
    linear_dropout_rate=0.0, dropout_rate=0.0,
)  # N = 20 + 3 + 1 = 24


def _flax_to_torch(tree):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, tree))


def _batch(seed, B, max_len, num_items=NUM_ITEMS):
    """One numpy batch as `batch_iterator` stacks it, one row at full length."""
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


def _model_pair(**over):
    """(JAX model, its params, the port's model with the same weights)."""
    kw = {**SMALL, **over}
    jm = j_seq.SequentialRecommender(j_seq.ModelConfig(**kw))
    N = jm.config.total_seq_len
    params = jm.init(
        jax.random.PRNGKey(0), jnp.ones((2,), jnp.int32), jnp.zeros((2, N), jnp.int32),
        {"timestamps": jnp.zeros((2, N), jnp.int32), "ratings": jnp.zeros((2, N), jnp.int32)},
        method=j_seq.SequentialRecommender.initialize,
    )
    tm = t_seq.SequentialRecommender(t_seq.ModelConfig(**kw), torch.Generator().manual_seed(0))
    tm.load_state_dict(_flax_to_torch(params))
    return jm, params, tm


# ------------------------------------------------------------------- weights
def test_every_sasrec_parameter_is_carried_over():
    """The flax tree fills every parameter of the port's SASRec model by
    name, with no renaming and no leaf left over; layouts are kept."""
    _, params, tm = _model_pair()
    state = _flax_to_torch(params)
    own = dict(tm.named_parameters())
    assert set(state) == set(own) == set(tm.state_dict())
    assert {"embedding_module.item_emb", "input_preproc.pos_emb",
            "encoder.attn_1.in_proj_weight", "encoder.attn_1.in_proj_bias",
            "encoder.attn_1.out_proj_weight", "encoder.attn_1.out_proj_bias",
            "encoder.ffn_1.conv1.kernel", "encoder.ffn_1.conv1.bias",
            "encoder.ffn_1.conv2.kernel", "encoder.ffn_1.conv2.bias"} <= set(own)
    assert tuple(own["encoder.attn_0.in_proj_weight"].shape) == (48, 16)
    assert tuple(own["encoder.ffn_0.conv1.kernel"].shape) == (16, 24)
    for name, p in own.items():
        torch.testing.assert_close(p.detach(), state[name], rtol=0, atol=0)
    fresh = t_seq.SequentialRecommender(tm.config, torch.Generator().manual_seed(1))
    # the fused projection is drawn over the whole [3D, D] tensor: std sqrt(2 / 4D)
    w = fresh.encoder.attn_0.in_proj_weight
    assert abs(w.std().item() - (2.0 / (4 * 16)) ** 0.5) < 0.03
    assert fresh.encoder.attn_0.in_proj_bias.abs().sum() == 0


# ------------------------------------------------------------------- encoder
@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_sasrec_encoder_matches_jax(activation):
    """`SASRecEncoder` with a valid mask: pre-LN at eps 1e-8, softmax
    attention, the kernel-1 convolutions, ReLU or exact GELU, pads zeroed
    after each block."""
    B, N, D = 3, 17, 16
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, N, D)).astype(np.float32)
    lengths = np.array([N, 9, 1])
    valid = (np.arange(N)[None, :] < lengths[:, None])[..., None].astype(np.float32)
    kw = dict(embedding_dim=D, num_blocks=2, num_heads=4, ffn_hidden_dim=20,
              ffn_activation_fn=activation, ffn_dropout_rate=0.0)
    je = j_sasrec.SASRecEncoder(**kw)
    params = je.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(lengths), None, True,
                     jnp.asarray(valid))
    want = je.apply(params, jnp.asarray(x), jnp.asarray(lengths), None, True, jnp.asarray(valid))
    te = t_sasrec.SASRecEncoder(**kw, gen=torch.Generator().manual_seed(0))
    te.load_state_dict(_flax_to_torch(params))
    got = te(torch.as_tensor(x), torch.as_tensor(lengths), None, deterministic=True,
             valid_mask=torch.as_tensor(valid))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD_TOL)
    assert (got[1, 9:] == 0).all() and (got[2, 1:] == 0).all()


def test_sasrec_model_matches_jax():
    """The whole SASRec model as the train step drives it, and `encode` as
    eval does: every row, pads included (SASRec zeroes them on both sides)."""
    jm, params, tm = _model_pair()
    batch = _batch(4, B=4, max_len=20)
    jf, _, _ = j_features.seq_features_from_row(
        {k: jnp.asarray(v) for k, v in batch.items()}, max_output_length=4
    )
    tf, t_tgt, _ = t_features.seq_features_from_row(
        {k: torch.as_tensor(v) for k, v in batch.items()}, max_output_length=4
    )
    t_ids = t_features.scatter_target_into_ids(tf.past_ids, tf.past_lengths, t_tgt)
    j_ids = jnp.asarray(t_ids.numpy())
    j_emb = jm.apply(params, j_ids, method=j_seq.SequentialRecommender.get_item_embeddings)
    want = jm.apply(params, jf.past_lengths, j_ids, j_emb, jf.past_payloads, True)
    got = tm(tf.past_lengths, t_ids, tm.get_item_embeddings(t_ids), tf.past_payloads,
             deterministic=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD_TOL)

    j_emb = jm.apply(params, jf.past_ids, method=j_seq.SequentialRecommender.get_item_embeddings)
    want_q = jm.apply(params, jf.past_lengths, jf.past_ids, j_emb, jf.past_payloads, True,
                      method=j_seq.SequentialRecommender.encode)
    got_q = tm.encode(tf.past_lengths, tf.past_ids, tm.get_item_embeddings(tf.past_ids),
                      tf.past_payloads)
    np.testing.assert_allclose(got_q.detach().numpy(), np.asarray(want_q), **FWD_TOL)


def test_sasrec_is_causal():
    """Changing the item at position j changes no output before j; each
    output at or after j moves."""
    _, _, tm = _model_pair()
    rng = np.random.default_rng(5)
    N = tm.config.total_seq_len
    ids = torch.as_tensor(rng.integers(1, NUM_ITEMS + 1, size=(2, N)))
    lengths = torch.tensor([N, N])
    payloads = {"timestamps": torch.zeros(2, N, dtype=torch.long)}
    run = lambda x: tm(lengths, x, tm.get_item_embeddings(x), payloads, deterministic=True)  # noqa: E731
    base = run(ids)
    for j in (0, 7, N - 1):
        other = ids.clone()
        other[:, j] = other[:, j] % NUM_ITEMS + 1
        moved = (run(other) - base).abs().amax(dim=-1)  # [2, N]
        assert (moved[:, :j] == 0).all(), j
        assert (moved[:, j:] > 0).all(), j


def test_sasrec_dropout_is_drawn_from_the_generator():
    cfg = t_seq.ModelConfig(**{**SMALL, "linear_dropout_rate": 0.3, "dropout_rate": 0.3})
    tm = t_seq.SequentialRecommender(cfg, torch.Generator().manual_seed(0))
    f, _, _ = t_features.seq_features_from_row(
        {k: torch.as_tensor(v) for k, v in _batch(6, 3, 20).items()}, max_output_length=4
    )
    emb = tm.get_item_embeddings(f.past_ids)
    run = lambda seed, det=False: tm(  # noqa: E731
        f.past_lengths, f.past_ids, emb, f.past_payloads, det, torch.Generator().manual_seed(seed)
    )
    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))
    assert torch.equal(run(1, det=True), run(2, det=True))


# ------------------------------------------------------------------- trainer
class _FixedNegatives:
    """Negatives that depend on the positives only, for both packages."""

    def __init__(self, all_item_ids, sampler, xp):
        self.ids, self.sampler, self.xp = all_item_ids, sampler, xp

    def __call__(self, rng, positive_ids, num_to_sample, item_embedding_fn):
        r = self.xp.arange(num_to_sample)
        offsets = (positive_ids[..., None] * 7 + r * 13 + 1) % self.ids.shape[0]
        sampled = self.ids[offsets]
        return sampled, self.sampler.normalize_embeddings(item_embedding_fn(sampled))


def _trainer_pair(j_cfg, t_cfg, ids):
    jt = j_train.ResearchTrainer(j_cfg, ids)
    jt.sampler = _FixedNegatives(jnp.asarray(ids), jt.sampler, jnp)
    params = jt.init_params(jax.random.PRNGKey(0))
    tt = t_train.ResearchTrainer(t_cfg, ids, device="cpu")
    tt.sampler = _FixedNegatives(torch.as_tensor(ids), tt.sampler, torch)
    tt.model.load_state_dict(_flax_to_torch(params))
    return jt, params, tt


def _assert_loss_and_grads(jt, params, tt, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (want_loss, _), want = jax.jit(jax.value_and_grad(jt._loss, has_aux=True))(
        params, jb, jax.random.PRNGKey(1)
    )
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


@pytest.mark.parametrize("name", [n for n in j_presets.RESEARCH_PRESETS if "sasrec" in n])
def test_sasrec_preset_step_matches_jax(name):
    """Each SASRec preset at its own widths (the item table cut to 300 rows,
    batch 2, dropout off): the port builds it, and one step's loss and every
    gradient match the JAX trainer's."""
    t_cfg, j_cfg = t_presets.RESEARCH_PRESETS[name], j_presets.RESEARCH_PRESETS[name]
    assert t_cfg.model.main_module == "SASRec"
    cut = dict(num_items=300, dropout_rate=0.0, linear_dropout_rate=0.0)
    kw = dict(local_batch_size=2, eval_batch_size=2)
    j_cfg = dataclasses.replace(j_cfg, model=dataclasses.replace(j_cfg.model, **cut), **kw)
    t_cfg = dataclasses.replace(t_cfg, model=dataclasses.replace(t_cfg.model, **cut), **kw)
    jt, params, tt = _trainer_pair(j_cfg, t_cfg, np.arange(1, 301))
    _assert_loss_and_grads(jt, params, tt, _batch(8, B=2, max_len=t_cfg.model.max_sequence_len,
                                                  num_items=300))


def test_sasrec_train_steps_track_jax():
    """20 optimizer steps of a small SASRec model (AdamW with warm-up and
    weight decay) from the same weights, batches and negatives: each loss
    within 1e-3 relative of the JAX trainer's, the parameters after the last
    step within 2e-3 of each one's largest entry."""
    kw = dict(local_batch_size=4, eval_batch_size=4, num_negatives=6, learning_rate=1e-3,
              weight_decay=0.01, num_warmup_steps=5)
    ids = np.arange(1, NUM_ITEMS + 1)
    jt, params, tt = _trainer_pair(
        j_train.TrainConfig(model=j_seq.ModelConfig(**SMALL), **kw),
        t_train.TrainConfig(model=t_seq.ModelConfig(**SMALL), **kw), ids,
    )
    opt_state = jt.init_opt_state(params)
    rows = [_batch(100 + i, B=4, max_len=20) for i in range(4)]
    j_l, t_l = [], []
    for step in range(20):
        batch = rows[step % len(rows)]
        params, opt_state, loss = jt.train_step(params, opt_state, batch, jax.random.PRNGKey(step))
        j_l.append(float(loss))
        t_l.append(float(tt.train_step(batch)))
    np.testing.assert_allclose(t_l, j_l, rtol=1e-3)
    assert t_l[-1] < t_l[0]
    own = {n: p.detach() for n, p in tt.model.named_parameters()}
    D = SMALL["item_embedding_dim"]
    for name, w in _flax_to_torch(params).items():
        got = own[name]
        if name.endswith("in_proj_bias"):
            # the softmax does not see the key bias (it adds q . b to a whole
            # row): its gradient is rounding noise, which Adam scales to full
            # steps of either sign in either package
            got, w = torch.cat([got[:D], got[2 * D:]]), torch.cat([w[:D], w[2 * D:]])
        assert (got - w).abs().max().item() <= 2e-3 * w.abs().max().item(), name


def test_sasrec_eval_epoch_matches_jax():
    """Eval ranks each target against the corpus through SASRec's `encode`."""
    kw = dict(local_batch_size=4, eval_batch_size=4, num_negatives=6)
    ids = np.arange(1, NUM_ITEMS + 1)
    jt, params, tt = _trainer_pair(
        j_train.TrainConfig(model=j_seq.ModelConfig(**SMALL), **kw),
        t_train.TrainConfig(model=t_seq.ModelConfig(**SMALL), **kw), ids,
    )
    batches = [_batch(200 + i, B=4, max_len=20) for i in range(3)]
    want, got = jt.eval_epoch(params, iter(batches)), tt.eval_epoch(iter(batches))
    assert set(want) == set(got)
    for key in ("hr@10", "hr@50", "ndcg@10", "mrr"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
