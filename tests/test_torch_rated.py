"""The research stack's rated input preprocessors and the categorical item
embedding of the PyTorch port against the JAX package, on the CPU: the JAX
modules' weights carried over by `convert.params_from_flax`, the same numpy
inputs, outputs without dropout and the gradients of a weighted sum of
them. float32; atol = rtol = 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from generative_recommenders_tpu.models import embeddings as j_emb
from generative_recommenders_tpu.models import preprocessors as j_pre
from generative_recommenders_tpu_torch.convert import params_from_flax
from generative_recommenders_tpu_torch.models import embeddings as t_emb
from generative_recommenders_tpu_torch.models import preprocessors as t_pre

TOL = dict(rtol=1e-5, atol=1e-5)
B, N, NUM_RATINGS = 3, 7, 6


def _inputs(D, seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.array([7, 4, 1])
    ids = rng.integers(1, 50, (B, N)) * (np.arange(N)[None, :] < lengths[:, None])
    ratings = rng.integers(-1, NUM_RATINGS + 2, (B, N))  # out-of-range ratings are clipped
    emb = rng.standard_normal((B, N, D)).astype(np.float32)
    return lengths, ids, emb, {"ratings": ratings, "timestamps": np.zeros((B, N), np.int64)}


def _compare(jm, params, tm, args, n_out):
    """Outputs (deterministic) and the gradients of sum(out * w) with
    respect to the parameters and the input embeddings."""
    lengths, ids, emb, payloads = args
    tm.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    want = jm.apply(params, jnp.asarray(lengths), jnp.asarray(ids), jnp.asarray(emb),
                    {k: jnp.asarray(v) for k, v in payloads.items()}, True)
    t_emb_in = torch.as_tensor(emb).requires_grad_()
    got = tm(torch.as_tensor(lengths), torch.as_tensor(ids), t_emb_in,
             {k: torch.as_tensor(v) for k, v in payloads.items()}, deterministic=True)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
    w_out = np.random.default_rng(9).standard_normal(np.asarray(want[1]).shape).astype(np.float32)

    def j_loss(p, e):
        out = jm.apply(p, jnp.asarray(lengths), jnp.asarray(ids), e,
                       {k: jnp.asarray(v) for k, v in payloads.items()}, True)[1]
        return jnp.sum(out * w_out)

    j_gp, j_ge = jax.grad(j_loss, argnums=(0, 1))(params, jnp.asarray(emb))
    (got[1] * torch.as_tensor(w_out)).sum().backward()
    np.testing.assert_allclose(t_emb_in.grad.numpy(), np.asarray(j_ge), **TOL)
    want_g = params_from_flax(jax.tree_util.tree_map(np.asarray, j_gp))
    named = dict(tm.named_parameters())
    assert named.keys() == want_g.keys() and len(named) == n_out
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(), err_msg=name, **TOL)
    return got


def test_rated_positional_preprocessor_matches_jax():
    jm = j_pre.LearnablePositionalEmbeddingRatedInputFeaturesPreprocessor(
        max_sequence_len=10, item_embedding_dim=12, rating_embedding_dim=4,
        num_ratings=NUM_RATINGS, dropout_rate=0.3,
    )
    args = _inputs(12)
    params = jm.init(jax.random.PRNGKey(0), *(jnp.asarray(a) if not isinstance(a, dict) else
                                              {k: jnp.asarray(v) for k, v in a.items()} for a in args), True)
    tm = t_pre.LearnablePositionalEmbeddingRatedInputFeaturesPreprocessor(10, 12, 4, NUM_RATINGS, 0.3)
    assert tm.output_dim == jm.output_dim == 16
    got = _compare(jm, params, tm, args, n_out=2)
    assert got[1].shape == (B, N, 16)
    # dropout from the caller's generator in training
    out = tm(*(torch.as_tensor(a) if not isinstance(a, dict) else
               {k: torch.as_tensor(v) for k, v in a.items()} for a in args),
             deterministic=False, gen=torch.Generator().manual_seed(0))[1]
    assert not torch.allclose(out, got[1]) and bool((out[got[2][..., 0] == 0] == 0).all())


def test_combined_item_and_rating_preprocessor_matches_jax():
    jm = j_pre.CombinedItemAndRatingInputFeaturesPreprocessor(
        max_sequence_len=N, embedding_dim=8, dropout_rate=0.2, num_ratings=NUM_RATINGS,
    )
    args = _inputs(8, seed=1)
    params = jm.init(jax.random.PRNGKey(1), *(jnp.asarray(a) if not isinstance(a, dict) else
                                              {k: jnp.asarray(v) for k, v in a.items()} for a in args), True)
    tm = t_pre.CombinedItemAndRatingInputFeaturesPreprocessor(N, 8, 0.2, NUM_RATINGS)
    lengths, out, mask = _compare(jm, params, tm, args, n_out=2)
    assert out.shape == (B, 2 * N, 8) and mask.shape == (B, 2 * N, 1)
    np.testing.assert_array_equal(lengths.numpy(), 2 * args[0])


@pytest.mark.parametrize("num_raw_items", [30, 60])
def test_categorical_embedding_module_matches_jax(num_raw_items):
    """Ids beyond the map and id 0 (padding) included; the map is not a
    parameter, so the carried-over state dict loads strictly."""
    rng = np.random.default_rng(2)
    remap = rng.integers(0, 9, num_raw_items)
    ids = rng.integers(0, 45, (4, 6))
    jm = j_emb.CategoricalEmbeddingModule(num_items=9, embedding_dim=5, item_id_to_category_id=jnp.asarray(remap))
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(ids))
    tm = t_emb.CategoricalEmbeddingModule(9, 5, remap)
    tm.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    assert list(tm.state_dict()) == ["item_emb"]
    want = jm.apply(params, jnp.asarray(ids))
    got = tm(torch.as_tensor(ids))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    assert bool((got[torch.as_tensor(ids) == 0] == 0).all())
    w = rng.standard_normal(np.asarray(want).shape).astype(np.float32)
    j_g = jax.grad(lambda p: jnp.sum(jm.apply(p, jnp.asarray(ids)) * w))(params)
    (got * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(tm.item_emb.grad.numpy(), np.asarray(j_g["params"]["item_emb"]), **TOL)
