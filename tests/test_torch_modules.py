"""The PyTorch port's modules against the JAX package, with the JAX weights
carried over by `convert.params_from_flax`: STULayer (forward, prefill,
cached_forward), HSTUTransducer (forward, prefill, cached_score), the
positional encoder, the contextual preprocessor and the supervision labels.
Inputs are made with numpy from a seed; float32, atol = rtol = 1e-5."""

import functools

import numpy as np
import pytest
import torch

import jax

from generative_recommenders_tpu.modules import hstu_transducer as j_tr
from generative_recommenders_tpu.modules import multitask_module as j_mt
from generative_recommenders_tpu.modules import positional_encoder as j_pe
from generative_recommenders_tpu.modules import postprocessors as j_post
from generative_recommenders_tpu.modules import preprocessors as j_pre
from generative_recommenders_tpu.modules import stu as j_stu
from generative_recommenders_tpu_torch.convert import params_from_flax
from generative_recommenders_tpu_torch.modules import hstu_transducer as t_tr
from generative_recommenders_tpu_torch.modules import multitask_module as t_mt
from generative_recommenders_tpu_torch.modules import positional_encoder as t_pe
from generative_recommenders_tpu_torch.modules import postprocessors as t_post
from generative_recommenders_tpu_torch.modules import preprocessors as t_pre
from generative_recommenders_tpu_torch.modules import stu as t_stu

TOL = dict(rtol=1e-5, atol=1e-5)
B, C, DIN, D, H, A = 3, 2, 8, 16, 2, 8  # batch, contextual, table dim, model dim, heads, head dim
CTX = (("viewer_id", 1), ("dummy_contexual", 1))
ACTIONS = (1, 2, 4, 8)


def _load(module, flax_params):
    module.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, flax_params)))
    return module


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _stu_configs(ctx, group_norm, norm_len):
    kw = dict(embedding_dim=D, num_heads=H, hidden_dim=A, attention_dim=A,
              use_group_norm=group_norm, contextual_seq_len=ctx, norm_seq_len=norm_len)
    # no recompute flags: the JAX stack then runs its layers without remat
    j_cfg = j_stu.STULayerConfig(
        output_dropout_ratio=0.0, recompute_normed_x=False, recompute_uvqk=False,
        recompute_y=False, **kw,
    )
    return j_cfg, t_stu.STULayerConfig(**kw)


@pytest.mark.parametrize(
    "group_norm,ctx,norm_len", [(False, 0, 0), (True, 2, 0), (True, 2, 40)]
)
def test_stu_layer_forward_prefill_and_cached_forward(group_norm, ctx, norm_len):
    jcfg, tcfg = _stu_configs(ctx, group_norm, norm_len)
    rng = np.random.default_rng(0)
    M, Nu = 3, 20
    N = Nu + M
    uih_lengths = np.array([5, 20, 13], np.int32)
    x = rng.standard_normal((B, N, D)).astype(np.float32)
    delta = x[np.arange(B)[:, None], uih_lengths[:, None] + np.arange(M)[None, :]]
    lengths, nt = uih_lengths + M, np.full((B,), M, np.int32)

    jl = j_stu.STULayer(jcfg)
    params = jax.jit(lambda *a: jl.init(jax.random.PRNGKey(0), *a, True))(x, lengths, nt)
    tl = _load(t_stu.STULayer(tcfg), params)
    apply = jax.jit(jl.apply, static_argnums=(4,), static_argnames=("method",))

    _close(tl(_t(x), _t(lengths), _t(nt)), apply(params, x, lengths, nt, True))

    j_out, j_cache = apply(params, x, lengths, nt, True, uih_lengths)
    t_out, t_cache = tl.prefill(_t(x), _t(lengths), _t(uih_lengths), _t(nt))
    _close(t_out, j_out)
    _close(t_cache.k, j_cache.k)
    _close(t_cache.v, j_cache.v)

    j_delta, j_new = apply(params, delta, j_cache, nt, True, method=j_stu.STULayer.cached_forward)
    t_delta, t_new = tl.cached_forward(_t(delta), t_cache, _t(nt))
    _close(t_delta, j_delta)
    _close(t_new.k, j_new.k)
    np.testing.assert_array_equal(t_new.lengths.numpy(), np.asarray(j_new.lengths))


def _preproc_kwargs():
    return dict(
        input_embedding_dim=DIN, output_embedding_dim=D,
        contextual_feature_to_max_length=CTX,
        contextual_feature_to_min_uih_length=(("viewer_id", 10),),
        action_feature_name="uih_weight", action_weights=ACTIONS, hidden_dim=24,
    )


def _seq_inputs(seed, N, Nc):
    rng = np.random.default_rng(seed)
    uih_lengths = rng.integers(1, N - Nc + 1, size=(B,)).astype(np.int32)
    num_targets = rng.integers(1, Nc + 1, size=(B,)).astype(np.int32)
    ts = np.sort(rng.integers(1, 1 << 20, (B, N)), axis=1).astype(np.int32)
    payloads = {
        "uih_weight": rng.integers(0, 16, (B, N)).astype(np.int32),
        "viewer_id": rng.standard_normal((B, 1, DIN)).astype(np.float32),
        "dummy_contexual": rng.standard_normal((B, 1, DIN)).astype(np.float32),
    }
    emb = rng.standard_normal((B, N, DIN)).astype(np.float32)
    return emb, uih_lengths + num_targets, ts, uih_lengths, num_targets, payloads


def test_contextual_preprocessor_and_delta_candidates():
    emb, lengths, ts, uih_lengths, nt, payloads = _seq_inputs(1, 16, 4)
    jp = j_pre.ContextualPreprocessor(**_preproc_kwargs())
    args = (emb, lengths, ts, uih_lengths, nt, payloads)
    params = jax.jit(functools.partial(jp.init, jax.random.PRNGKey(1)))(*args)
    tp = _load(t_pre.ContextualPreprocessor(**_preproc_kwargs()), params)
    want = jp.apply(params, *args)
    got = tp(*[_t(a) for a in args[:5]], {k: _t(v) for k, v in payloads.items()})
    _close(got.seq_embeddings, want.seq_embeddings)
    np.testing.assert_array_equal(got.seq_timestamps.numpy(), np.asarray(want.seq_timestamps))
    np.testing.assert_array_equal(got.seq_lengths.numpy(), np.asarray(want.seq_lengths))
    np.testing.assert_array_equal(got.uih_lengths.numpy(), np.asarray(want.uih_lengths))
    cand = emb[:, :3]
    _close(
        tp.delta_candidates(_t(cand)),
        jp.apply(params, cand, method=j_pre.ContextualPreprocessor.delta_candidates),
    )


@pytest.mark.parametrize("targets,query_time", [(True, False), (False, True)])
def test_positional_encoder_and_delta(targets, query_time):
    emb, lengths, ts, _, nt, _ = _seq_inputs(2, 18, 4)
    x = emb[..., :DIN].repeat(2, axis=-1)  # [B, N, D]
    nt = nt if targets else None
    qt = (ts.max(axis=1) + 7).astype(np.int32) if query_time else None
    kw = dict(num_position_buckets=40, num_time_buckets=64, embedding_dim=D, contextual_seq_len=C)
    jpe = j_pe.HSTUPositionalEncoder(**kw)
    params = jpe.init(jax.random.PRNGKey(2), x, lengths, ts, nt, qt)
    tpe = _load(t_pe.HSTUPositionalEncoder(**kw), params)
    _close(
        tpe(_t(x), _t(lengths), _t(ts), None if nt is None else _t(nt), None if qt is None else _t(qt)),
        jpe.apply(params, x, lengths, ts, nt, qt),
    )
    qt = ts.max(axis=1) + 1
    cand_ts = np.repeat(qt[:, None], 3, axis=1).astype(np.int32) - np.arange(3, dtype=np.int32) * 5000
    _close(
        tpe.delta(_t(x[:, :3]), _t(cand_ts), _t(qt)),
        jpe.apply(params, x[:, :3], cand_ts, qt, method=j_pe.HSTUPositionalEncoder.delta),
    )


def _transducers():
    jcfg, tcfg = _stu_configs(C, True, 30)
    pe_kw = dict(num_position_buckets=40, num_time_buckets=64, embedding_dim=D, contextual_seq_len=C)
    post = ((3600, 24), (86400, 7))
    jt = j_tr.HSTUTransducer(
        stu_module=j_stu.STUStack((jcfg, jcfg)),
        input_preprocessor=j_pre.ContextualPreprocessor(**_preproc_kwargs()),
        output_postprocessor=j_post.TimestampLayerNormPostprocessor(D, post),
        positional_encoder=j_pe.HSTUPositionalEncoder(**pe_kw),
    )
    tt = t_tr.HSTUTransducer(
        stu_module=t_stu.STUStack((tcfg, tcfg)),
        input_preprocessor=t_pre.ContextualPreprocessor(**_preproc_kwargs()),
        output_postprocessor=t_post.TimestampLayerNormPostprocessor(D, post),
        positional_encoder=t_pe.HSTUPositionalEncoder(**pe_kw),
    )
    return jt, tt


def test_hstu_transducer_forward_prefill_and_cached_score():
    Nu, M = 20, 4
    emb, lengths, ts, uih_lengths, nt, payloads = _seq_inputs(3, Nu + M, M)
    jt, tt = _transducers()
    args = (emb, lengths, ts, uih_lengths, nt, payloads)
    params = jax.jit(lambda *a: jt.init(jax.random.PRNGKey(3), *a, M))(*args)
    _load(tt, params)
    t_pay = {k: _t(v) for k, v in payloads.items()}
    want, _ = jax.jit(lambda p, *a: jt.apply(p, *a, M))(params, *args)
    _close(tt(*[_t(a) for a in args[:5]], t_pay, M), want)

    qt = (ts.max(axis=1) + 1).astype(np.int32)
    j_caches, j_len = jax.jit(functools.partial(jt.apply, method=j_tr.HSTUTransducer.prefill))(
        params, emb[:, :Nu], uih_lengths, ts[:, :Nu], qt,
        {**payloads, "uih_weight": payloads["uih_weight"][:, :Nu]},
    )
    t_caches, t_len = tt.prefill(
        _t(emb[:, :Nu]), _t(uih_lengths), _t(ts[:, :Nu]), _t(qt),
        {**t_pay, "uih_weight": t_pay["uih_weight"][:, :Nu]},
    )
    np.testing.assert_array_equal(t_len.numpy(), np.asarray(j_len))
    for tc, jc in zip(t_caches, j_caches):
        _close(tc.k, jc.k)
        _close(tc.v, jc.v)
    cand = emb[:, Nu:]
    cand_ts = np.repeat(qt[:, None], M, axis=1)
    _close(
        tt.cached_score(_t(cand), _t(cand_ts), t_caches, _t(qt)),
        jax.jit(functools.partial(jt.apply, method=j_tr.HSTUTransducer.cached_score))(
            params, cand, cand_ts, j_caches, qt
        ),
    )


def test_supervision_labels_match_jax():
    rng = np.random.default_rng(4)
    bitmasks = rng.integers(0, 256, (B, 5)).astype(np.int32)
    watch = rng.integers(0, 600, (B, 5)).astype(np.int32)
    names = ("click", "like", "follow")
    j_tasks = tuple(j_mt.TaskConfig(n, 1 << i, j_mt.MultitaskTaskType.BINARY_CLASSIFICATION)
                    for i, n in enumerate(names)) + (
        j_mt.TaskConfig("watch", 0, j_mt.MultitaskTaskType.REGRESSION),)
    t_tasks = tuple(t_mt.TaskConfig(t.task_name, t.task_weight, t_mt.MultitaskTaskType(int(t.task_type)))
                    for t in j_tasks)
    want, want_w = j_mt.get_supervision_labels_and_weights(bitmasks, watch, j_tasks)
    got, got_w = t_mt.get_supervision_labels_and_weights(_t(bitmasks), _t(watch), t_tasks)
    assert got.keys() == want.keys() and got_w == want_w == {}
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
