"""The PyTorch port's contextual-interleave preprocessor
(`modules/contextual_interleave_preprocessor.py`) and its parts, the
contextualized MLPs (`modules/contextualize_mlps.py`) and `ContentEncoder`
(`modules/action_encoder.py`), against the JAX package on the CPU. JAX
weights are carried over by `convert.params_from_flax`; inputs come from
numpy with a seed. The contextual dropout is 0 where the packages are
compared.

Tolerances: outputs to rtol 1e-5, atol 1e-5; lengths and timestamps
exactly; each gradient within 1e-5 of its largest entry (float32 on both
sides).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from generative_recommenders_tpu.modules import action_encoder as j_ae
from generative_recommenders_tpu.modules import contextual_interleave_preprocessor as j_cip
from generative_recommenders_tpu.modules import contextualize_mlps as j_cm
from generative_recommenders_tpu_torch.convert import params_from_flax
from generative_recommenders_tpu_torch.modules import action_encoder as t_ae
from generative_recommenders_tpu_torch.modules import contextual_interleave_preprocessor as t_cip
from generative_recommenders_tpu_torch.modules import contextualize_mlps as t_cm

TOL = dict(rtol=1e-5, atol=1e-5)
T = torch.as_tensor


def _to_torch(tree):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, tree))


def test_contextualized_mlps_match_jax():
    """Both MLPs' outputs and the parameterized one's every gradient; a
    different context gives a different per-example transform."""
    B, N = 3, 5
    rng = np.random.default_rng(0)
    seq = rng.standard_normal((B, N, 8)).astype(np.float32)
    ctx = rng.standard_normal((B, 12)).astype(np.float32)
    js = j_cm.SimpleContextualizedMLP(sequential_output_dim=6, hidden_dim=16)
    p = jax.jit(js.init)(jax.random.PRNGKey(0), seq, ctx)
    ts = t_cm.SimpleContextualizedMLP(8, 6, 16)
    ts.load_state_dict(_to_torch(p))
    np.testing.assert_allclose(ts(T(seq), T(ctx)).detach().numpy(), np.asarray(jax.jit(js.apply)(p, seq, ctx)), **TOL)

    jp = j_cm.ParameterizedContextualizedMLP(sequential_input_dim=8, sequential_output_dim=6, hidden_dim=16)
    p = jax.jit(jp.init)(jax.random.PRNGKey(1), seq, ctx)
    loss_w = rng.standard_normal((B, N, 6)).astype(np.float32)
    want, grads = jax.jit(jax.value_and_grad(lambda p_: jnp.sum(jp.apply(p_, seq, ctx) * loss_w)))(p)
    tp = t_cm.ParameterizedContextualizedMLP(12, 8, 6, 16)
    tp.load_state_dict(_to_torch(p))
    out = tp(T(seq), T(ctx))
    loss = (out * T(loss_w)).sum()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    loss.backward()
    for name, g in _to_torch(grads).items():
        got = dict(tp.named_parameters())[name].grad
        np.testing.assert_allclose(got.numpy(), g.numpy(), rtol=0, atol=1e-5 * float(g.abs().max()), err_msg=name)
    assert float((tp(T(seq), T(ctx + 1.0)) - out).detach().abs().max()) > 1e-3


def test_content_encoder_matches_jax():
    """Side features concatenated; a target-only feature's uih positions
    take the learned dummy."""
    B, N, D = 2, 6, 4
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((B, N, D)).astype(np.float32)
    payloads = {"side": rng.standard_normal((B, N, 3)).astype(np.float32),
                "enrich": rng.standard_normal((B, N, 2)).astype(np.float32)}
    uih = np.array([4, 2], np.int32)
    kw = dict(additional_content_features=(("side", 3),), target_enrich_features=(("enrich", 2),))
    je = j_ae.ContentEncoder(input_embedding_dim=D, **kw)
    p = je.init(jax.random.PRNGKey(0), emb, uih, payloads)
    te = t_ae.ContentEncoder(D, **kw)
    te.load_state_dict(_to_torch(p))
    assert te.output_embedding_dim == je.output_embedding_dim == 9
    got = te(T(emb), T(uih), {k: T(v) for k, v in payloads.items()})
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(je.apply(p, emb, uih, payloads)), **TOL)
    assert t_ae.ContentEncoder(D)(T(emb), T(uih), {}) is not None


# two watch-time thresholds: each adds an action type, bits 4 and 8 of the mask
THRESHOLDS = ((30, 4), (60, 8))


def _pair(use_pmlp, ctx, thresholds=()):
    kw = dict(input_embedding_dim=8, output_embedding_dim=12, contextual_feature_to_max_length=ctx,
              contextual_feature_to_min_uih_length=(("u", 4),) if ctx else (), use_parameterized_mlps=use_pmlp,
              mlp_hidden_dim=16, enable_interleaving=True)
    wt = dict(watchtime_feature_name="wt", watchtime_to_action_thresholds_and_weights=thresholds) if thresholds else {}
    jm = j_cip.ContextualInterleavePreprocessor(
        content_encoder=j_ae.ContentEncoder(input_embedding_dim=8),
        action_encoder=j_ae.ActionEncoder(action_embedding_dim=4, action_feature_name="w", action_weights=(1, 2),
                                          **wt),
        **kw,
    )
    tm = t_cip.ContextualInterleavePreprocessor(
        content_encoder=t_ae.ContentEncoder(8), action_encoder=t_ae.ActionEncoder(4, "w", (1, 2), **wt), **kw,
    )
    return jm, tm


def _watchtimes(rng, shape):
    """Watch times around the thresholds, both exactly at them."""
    wt = rng.integers(0, 100, shape).astype(np.int32)
    wt.flat[0], wt.flat[1] = 30, 60
    return wt


def test_action_encoder_with_watchtime_thresholds_matches_jax():
    """Two watch-time thresholds: the [A + T, d] table and its [1, (A + T) d]
    target row carried over by `params_from_flax`, the bits ORed into the
    mask where the watch time reaches each threshold, candidate positions on
    the target row; the forward within 1e-6 and every gradient within 1e-6
    of its largest entry."""
    B, N = 3, 7
    rng = np.random.default_rng(3)
    payloads = {"w": rng.integers(0, 4, (B, N)).astype(np.int32), "wt": _watchtimes(rng, (B, N))}
    uih = np.array([7, 4, 1], np.int32)
    je = j_ae.ActionEncoder(action_embedding_dim=4, action_feature_name="w", action_weights=(1, 2),
                            watchtime_feature_name="wt", watchtime_to_action_thresholds_and_weights=THRESHOLDS)
    params = je.init(jax.random.PRNGKey(0), uih, uih + 2, payloads)
    te = t_ae.ActionEncoder(4, "w", (1, 2), watchtime_feature_name="wt",
                            watchtime_to_action_thresholds_and_weights=THRESHOLDS)
    te.load_state_dict(_to_torch(params))
    assert te.action_embedding_table.shape == (4, 4) and te.output_embedding_dim == je.output_embedding_dim == 16
    loss_w = rng.standard_normal((B, N, 16)).astype(np.float32)
    want, grads = jax.value_and_grad(lambda p_: jnp.sum(je.apply(p_, uih, uih + 2, payloads) * loss_w))(params)
    got = te(T(uih), {k: T(v) for k, v in payloads.items()})
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(je.apply(params, uih, uih + 2, payloads)),
                               rtol=0, atol=1e-6)
    # a threshold's bit reaches the table: the last row is live somewhere
    assert float(got.detach()[..., 12:].abs().sum()) > 0
    loss = (got * T(loss_w)).sum()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-6)
    loss.backward()
    named = dict(te.named_parameters())
    for name, g in _to_torch(grads).items():
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(), rtol=0,
                                   atol=1e-6 * float(g.abs().max()), err_msg=name)


def _check_interleave(use_pmlp, thresholds=(), rel_tol=None, grad_tol=1e-5):
    """The preprocessor pair's outputs (to TOL, or with ``rel_tol`` within
    that share of the output's largest entry) and every gradient (within
    ``grad_tol`` of its largest entry)."""
    B, N = 2, 6
    rng = np.random.default_rng(0)
    uih = np.array([3, 4], np.int32)
    nt = np.array([2, 1], np.int32)
    emb = rng.standard_normal((B, N, 8)).astype(np.float32)
    ts = rng.integers(1, 100, (B, N)).astype(np.int32)
    payloads = {"w": rng.integers(0, 4, (B, N)).astype(np.int32)}
    if thresholds:
        payloads["wt"] = _watchtimes(rng, (B, N))
    ctx = (("u", 1),) if use_pmlp else ()
    if use_pmlp:
        payloads["u"] = rng.standard_normal((B, 8)).astype(np.float32)
    jm, tm = _pair(use_pmlp, ctx, thresholds)
    args = (emb, uih + nt, ts, uih, nt, payloads)
    params = jax.jit(jm.init, static_argnums=7)(jax.random.PRNGKey(0), *args, True)
    fields = ("seq_embeddings", "seq_lengths", "seq_timestamps", "uih_lengths", "num_targets")

    def j_out(p_, det):
        out = jm.apply(p_, *args, det, rngs={"dropout": jax.random.PRNGKey(1)})
        return {f: getattr(out, f) for f in fields}

    apply = jax.jit(j_out, static_argnums=1)
    tm.load_state_dict(_to_torch(params))
    t_args = (T(emb), T(uih + nt), T(ts), T(uih), T(nt), {k: T(v) for k, v in payloads.items()})
    C = tm.max_contextual_seq_len
    loss_w = rng.standard_normal((B, C + 2 * N, 12)).astype(np.float32)
    for deterministic in (True, False):
        want = apply(params, deterministic)
        got = tm(*t_args, deterministic=deterministic, gen=torch.Generator())
        want_emb = np.asarray(want["seq_embeddings"])
        tol = TOL if rel_tol is None else dict(rtol=0, atol=rel_tol * float(np.abs(want_emb).max()))
        np.testing.assert_allclose(got.seq_embeddings.detach().numpy(), want_emb, **tol)
        for f in fields[1:]:
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(want[f]), err_msg=f)
        assert got.contextual_seq_len == jm.max_contextual_seq_len == C
    np.testing.assert_array_equal(got.seq_lengths.numpy(), 2 * (uih + nt) + C)
    grads = jax.jit(jax.grad(lambda p_: jnp.sum(apply(p_, False)["seq_embeddings"] * loss_w)))(params)
    tm.zero_grad()
    (got.seq_embeddings * T(loss_w)).sum().backward()
    named = dict(tm.named_parameters())
    for name, g in _to_torch(grads).items():
        scale = max(float(g.abs().max()), 1e-30)
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(), rtol=0, atol=grad_tol * scale, err_msg=name)


@pytest.mark.parametrize("use_pmlp", [False, True], ids=["simple", "parameterized"])
def test_interleave_preprocessor_matches_jax(use_pmlp):
    """Inference (targets keep their content token only) and training
    (targets interleaved too): embeddings, lengths, uih lengths, targets and
    timestamps against the JAX module, with a contextual prefix under the
    parameterized MLPs; every gradient of the training output."""
    _check_interleave(use_pmlp)


@pytest.mark.parametrize("use_pmlp", [False, True], ids=["simple", "parameterized"])
def test_interleave_preprocessor_with_watchtime_thresholds_matches_jax(use_pmlp):
    """The same with the action encoder's two watch-time thresholds: its
    [4, 4] table through `params_from_flax`, the watch times read from the
    payloads; outputs and every gradient within 1e-6 of their largest entry."""
    _check_interleave(use_pmlp, THRESHOLDS, rel_tol=1e-6, grad_tol=1e-6)


def test_parameterized_contextual_dropout_draws_from_the_generator():
    """The parameterized MLPs' contextual dropout in training: the same
    generator seed gives the same output, another seed another, and an
    eval forward draws nothing."""
    jm, tm = _pair(True, (("u", 1),))
    tm.pmlp_contextual_dropout_ratio = 0.5
    rng = np.random.default_rng(2)
    B, N = 2, 5
    args = (T(rng.standard_normal((B, N, 8)).astype(np.float32)), T(np.array([5, 4])),
            T(rng.integers(1, 100, (B, N))), T(np.array([4, 3])), T(np.array([1, 1])),
            {"w": T(rng.integers(0, 4, (B, N))), "u": T(rng.standard_normal((B, 8)).astype(np.float32))})
    run = lambda seed: tm(*args, deterministic=False, gen=torch.Generator().manual_seed(seed)).seq_embeddings  # noqa: E731
    torch.testing.assert_close(run(0), run(0), rtol=0, atol=0)
    assert not torch.allclose(run(0), run(1))
    torch.testing.assert_close(tm(*args, deterministic=True).seq_embeddings,
                               tm(*args, deterministic=True).seq_embeddings, rtol=0, atol=0)
    with pytest.raises(ValueError, match="Generator"):
        tm(*args, deterministic=False)
