"""The PyTorch port's KV-cached encode of the research model
(`encode_with_cache` / `encode_delta`, `HSTUEncoder` with ``return_caches``
/ ``caches``, `SequentialTransductionUnit._delta_attend`, the bias rows of
`RelativeBucketedTimeAndPositionBasedBias` and the preprocessor's
``delta_positions``) against the port's own full re-encode and against the
JAX package, on the CPU at a small size. JAX weights are carried over by
`convert.params_from_flax`.

The JAX package's ``"xla"`` path masks causally only and leaves other values
in rows at or past each length, where the port (like the kernels) gives
zeros; so caches are compared on the rows below each length. The delta
encode is held to the full re-encode at rtol 2e-4 / atol 2e-5, as
`test_research_cache.py` holds the JAX package's; other forward values at
2e-4 as in `test_torch_research.py`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from generative_recommenders_tpu.models import hstu as j_hstu
from generative_recommenders_tpu.models import preprocessors as j_pre
from generative_recommenders_tpu.models import sequential as j_seq
from generative_recommenders_tpu_torch.convert import params_from_flax
from generative_recommenders_tpu_torch.models import hstu as t_hstu
from generative_recommenders_tpu_torch.models import preprocessors as t_pre
from generative_recommenders_tpu_torch.models import sequential as t_seq

FWD_TOL = dict(rtol=2e-4, atol=2e-4)
DELTA_TOL = dict(rtol=2e-4, atol=2e-5)
B = 4


def _flax_to_torch(tree):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, tree))


def _model_pair(enable_bias, num_items=60, N=12, D=16):
    """The JAX package's cache test model (XLA path) and the port's with
    the same weights."""
    kw = dict(main_module="HSTU", num_items=num_items, max_sequence_len=N, gr_output_length=1,
              item_embedding_dim=D, num_blocks=2, num_heads=2, dqk=8, dv=8,
              enable_relative_attention_bias=enable_bias)
    jm = j_seq.SequentialRecommender(j_seq.ModelConfig(attn_kernel="xla", **kw))
    Ncap = jm.config.total_seq_len
    params = jm.init(
        jax.random.PRNGKey(0), jnp.ones((2,), jnp.int32), jnp.zeros((2, Ncap), jnp.int32),
        {"timestamps": jnp.zeros((2, Ncap), jnp.int32), "ratings": jnp.zeros((2, Ncap), jnp.int32)},
        method=j_seq.SequentialRecommender.initialize,
    )
    tm = t_seq.SequentialRecommender(t_seq.ModelConfig(**kw), torch.Generator().manual_seed(0))
    tm.load_state_dict(_flax_to_torch(params))
    tm.eval()
    return jm, params, tm


def _cache_inputs(seed, Ncap, M, num_items=60):
    """Prefix ids and timestamps at the padded width, the M appended tokens,
    and the three timestamp layouts of the cache test: the prefix with the
    first appended timestamp at position ``length`` (the prefill's
    contract), and the full rows with every appended token in place."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(3, Ncap - M, size=(B,))
    lengths[0] = Ncap - M  # the longest prefix that leaves room for the delta
    ids = np.zeros((B, Ncap), np.int64)
    ts = np.zeros((B, Ncap), np.int64)
    for b, n in enumerate(lengths):
        ids[b, :n] = rng.integers(1, num_items, size=n)
        ts[b, :n] = np.sort(rng.integers(1, 1 << 20, size=n))
    delta_ids = rng.integers(1, num_items, size=(B, M))
    delta_ts = ts[np.arange(B), lengths - 1][:, None] + np.arange(1, M + 1)[None, :] * 100
    rows, cols = np.arange(B)[:, None], lengths[:, None] + np.arange(M)[None, :]
    full_ids, full_ts = ids.copy(), ts.copy()
    full_ids[rows, cols], full_ts[rows, cols] = delta_ids, delta_ts
    prefill_ts = ts.copy()
    prefill_ts[np.arange(B), lengths] = delta_ts[:, 0]
    return dict(lengths=lengths, ids=ids, delta_ids=delta_ids, full_ids=full_ids,
                full_ts=full_ts, prefill_ts=prefill_ts)


def _payloads(ts, xp):
    return {"timestamps": xp(ts), "ratings": xp(np.ones_like(ts))}


@pytest.mark.parametrize("M", [1, 3], ids=["delta1", "delta3"])
@pytest.mark.parametrize("enable_bias", [True, False], ids=["rel_bias", "no_bias"])
def test_encode_delta_matches_full_reencode_and_jax(enable_bias, M):
    """Prefill (``reserved_slots=M``) then `encode_delta` of M tokens: equal
    to the port's full re-encode of the extended rows, and to the JAX
    package's `encode_delta` on the same weights; the extended caches equal
    the JAX package's below each new length."""
    jm, params, tm = _model_pair(enable_bias)
    Ncap = tm.config.total_seq_len
    x = _cache_inputs(M, Ncap, M)
    T, J = torch.as_tensor, jnp.asarray
    lengths = T(x["lengths"])
    with torch.no_grad():
        emb = tm.get_item_embeddings
        want = tm.encode(lengths + M, T(x["full_ids"]), emb(T(x["full_ids"])), _payloads(x["full_ts"], T))
        q0, caches = tm.encode_with_cache(
            lengths, T(x["ids"]), emb(T(x["ids"])), _payloads(x["prefill_ts"], T), reserved_slots=M)
        got, new_caches = tm.encode_delta(
            lengths, T(x["delta_ids"]), emb(T(x["delta_ids"])), _payloads(x["full_ts"], T), caches)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **DELTA_TOL)
    assert len(caches) == 2 and caches[0][0].shape == (B, Ncap - M, 2, 8)
    assert new_caches[0][0].shape == (B, Ncap, 2, 8) and new_caches[1][1].shape == (B, Ncap, 2, 8)

    j_emb = lambda i: jm.apply(params, i, method=j_seq.SequentialRecommender.get_item_embeddings)  # noqa: E731
    j_q0, j_caches = jm.apply(
        params, J(x["lengths"]), J(x["ids"]), j_emb(J(x["ids"])), _payloads(x["prefill_ts"], J), M,
        method=j_seq.SequentialRecommender.encode_with_cache)
    j_got, j_new = jm.apply(
        params, J(x["lengths"]), J(x["delta_ids"]), j_emb(J(x["delta_ids"])), _payloads(x["full_ts"], J),
        j_caches, method=j_seq.SequentialRecommender.encode_delta)
    np.testing.assert_allclose(q0.numpy(), np.asarray(j_q0), **FWD_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_got), **FWD_TOL)
    for (tk, tv), (jk, jv) in zip(new_caches, j_new, strict=True):
        for b, n in enumerate(x["lengths"] + M):
            np.testing.assert_allclose(tk[b, :n].numpy(), np.asarray(jk)[b, :n], **FWD_TOL)
            np.testing.assert_allclose(tv[b, :n].numpy(), np.asarray(jv)[b, :n], **FWD_TOL)


@pytest.mark.parametrize("enable_bias", [True, False], ids=["rel_bias", "no_bias"])
def test_two_delta_steps_match_full_reencode(enable_bias):
    """A delta step on the caches a delta step returned: 2 + 1 appended
    tokens against one re-encode of all three. Each step's timestamps span
    its caches' width (Nc + M) and, as the prefill's do, hold the next
    token's timestamp past the appended ones; the prefixes leave room for a
    fourth token, whose timestamp the last row reads."""
    _, _, tm = _model_pair(enable_bias)
    Ncap = tm.config.total_seq_len
    x = _cache_inputs(7, Ncap, 4)
    T = torch.as_tensor
    lengths, emb = T(x["lengths"]), tm.get_item_embeddings
    d_ids, full_ts = T(x["delta_ids"]), x["full_ts"]
    with torch.no_grad():
        want = tm.encode(lengths + 3, T(x["full_ids"]), emb(T(x["full_ids"])), _payloads(full_ts, T))
        _, caches = tm.encode_with_cache(lengths, T(x["ids"]), emb(T(x["ids"])),
                                         _payloads(x["prefill_ts"], T), reserved_slots=3)
        _, caches = tm.encode_delta(lengths, d_ids[:, :2], emb(d_ids[:, :2]),
                                    _payloads(full_ts[:, : Ncap - 1], T), caches)
        assert caches[0][0].shape[1] == Ncap - 1
        got, caches = tm.encode_delta(lengths + 2, d_ids[:, 2:3], emb(d_ids[:, 2:3]),
                                      _payloads(full_ts, T), caches)
    assert caches[0][0].shape[1] == Ncap
    np.testing.assert_allclose(got.numpy(), want.numpy(), **DELTA_TOL)


def test_delta_bias_rows_match_jax():
    """The bias rows of the delta queries: position and bucketed time span,
    row i reading ts[min(i + 1, N - 1)], a table larger than N (Nm > N),
    rows at the last position and gaps of every bucket size."""
    Nm, N, M, nb = 20, 14, 3, 30
    rng = np.random.default_rng(2)
    ts = np.sort(rng.integers(0, 1 << 24, size=(B, N)), axis=1)
    ts[1, 5:] = ts[1, 4]  # equal timestamps: |dt| < 1
    rows = np.array([[0, 1, 2], [4, 5, 6], [11, 12, 13], [7, 9, 13]])
    jb = j_hstu.RelativeBucketedTimeAndPositionBasedBias(max_seq_len=Nm, num_buckets=nb)
    params = jb.init(jax.random.PRNGKey(3), jnp.asarray(ts), row_idx=jnp.asarray(rows))
    want = jb.apply(params, jnp.asarray(ts), row_idx=jnp.asarray(rows))
    tb = t_hstu.RelativeBucketedTimeAndPositionBasedBias(Nm, nb, torch.Generator().manual_seed(0))
    tb.load_state_dict(_flax_to_torch(params))
    got = tb(torch.as_tensor(ts), torch.as_tensor(rows))
    assert got.shape == (B, M, N)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_delta_positions_match_jax():
    """The appended tokens' position embeddings at each row's own absolute
    positions (clipped to the table)."""
    jp = j_pre.LearnablePositionalEmbeddingInputFeaturesPreprocessor(max_sequence_len=10, embedding_dim=8,
                                                                     dropout_rate=0.0)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 9, size=(3, 2))
    emb = rng.standard_normal((3, 2, 8)).astype(np.float32)
    pos = np.array([[0, 1], [5, 6], [9, 12]])
    args = (jnp.ones((3,), jnp.int32), jnp.asarray(ids), jnp.asarray(emb), {})
    params = jp.init(jax.random.PRNGKey(0), *args, True, jnp.asarray(pos))
    want = jp.apply(params, *args, True, jnp.asarray(pos))
    tp = t_pre.LearnablePositionalEmbeddingInputFeaturesPreprocessor(10, 8, 0.0, gen=torch.Generator())
    tp.load_state_dict(_flax_to_torch(params))
    got = tp(torch.ones(3, dtype=torch.long), torch.as_tensor(ids), torch.as_tensor(emb), {},
             deterministic=True, delta_positions=torch.as_tensor(pos))
    for w, g in zip(want, got, strict=True):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_kv_cached_encode_is_hstu_only():
    cfg = t_seq.ModelConfig(main_module="SASRec", num_items=20, max_sequence_len=8, gr_output_length=1,
                            item_embedding_dim=8, num_blocks=1, num_heads=1, ffn_hidden_dim=8)
    tm = t_seq.SequentialRecommender(cfg, torch.Generator().manual_seed(0))
    ids = torch.ones(2, 10, dtype=torch.long)
    with pytest.raises(ValueError, match="HSTU-only"):
        tm.encode_with_cache(torch.tensor([3, 4]), ids, tm.get_item_embeddings(ids), {})
    with pytest.raises(ValueError, match="HSTU-only"):
        tm.encode_delta(torch.tensor([3, 4]), ids[:, :1], tm.get_item_embeddings(ids[:, :1]), {}, [])
