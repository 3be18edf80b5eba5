"""The PyTorch port's ops spec against the JAX package on the CPU: the jagged
library (`ops/jagged.py`), the jagged attention entry points
(`ops/hstu_attention.py`: `hstu_mha`, `delta_hstu_mha`, through K1's and
K5's plain versions here) and the norms (`ops/normalization.py`). Inputs
come from numpy with a seed, padding slots filled with garbage where an op
must ignore them.

Tolerances: gathers, scatters, concatenations and splits exactly; sums,
products and norms to rtol 1e-5, atol 1e-6 (float32 on both sides, summed
in other orders); attention to rtol 1e-4, atol 1e-5 (as
`tests/test_attention.py`).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from generative_recommenders_tpu.ops import jagged as j_jg
from generative_recommenders_tpu.ops import normalization as j_norm
from generative_recommenders_tpu.ops.xla import hstu_attention as j_attn
from generative_recommenders_tpu_torch.ops import hstu_attention as t_attn
from generative_recommenders_tpu_torch.ops import jagged as t_jg
from generative_recommenders_tpu_torch.ops import normalization as t_norm

T = torch.as_tensor
# the JAX functions traced whole (faster than op by op on the CPU)
J_MHA = jax.jit(j_attn.hstu_mha, static_argnums=(0, 1),
                static_argnames=("causal", "max_attn_len", "contextual_seq_len", "dropout_pr"))
J_DELTA = jax.jit(j_attn.delta_hstu_mha, static_argnums=(0, 1))
CLOSE = dict(rtol=1e-5, atol=1e-6)
ATTN = dict(rtol=1e-4, atol=1e-5)


def _jagged(rng, B, max_len, D, garbage=0.0):
    """(lengths, offsets, values at capacity B * max_len) with the padding
    slots set to ``garbage``."""
    lengths = rng.integers(0, max_len + 1, size=(B,)).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    vals = np.full((B * max_len, D), garbage, np.float32)
    vals[: offsets[-1]] = rng.standard_normal((offsets[-1], D))
    return lengths, offsets, vals


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("B,max_len,D", [(4, 7, 3), (1, 1, 1)])
def test_offsets_padding_and_back_match_jax(B, max_len, D):
    """lengths <-> offsets, row ids, jagged -> padded (with a padding value,
    rows cut at a shorter width) -> jagged: equal to the JAX package's."""
    rng = np.random.default_rng(0)
    lengths, offsets, vals = _jagged(rng, B, max_len, D, garbage=7.0)
    np.testing.assert_array_equal(_np(t_jg.lengths_to_offsets(T(lengths))), _np(j_jg.lengths_to_offsets(lengths)))
    np.testing.assert_array_equal(_np(t_jg.offsets_to_lengths(T(offsets))), lengths)
    np.testing.assert_array_equal(_np(t_jg.row_ids_from_offsets(T(offsets), B * max_len)),
                                  _np(j_jg.row_ids_from_offsets(jnp.asarray(offsets), B * max_len)))
    jt = t_jg.JaggedTensor(T(vals), T(offsets))
    assert jt.num_rows == B and torch.equal(jt.lengths(), T(lengths))
    for width, pad in ((max_len, 0.0), (max(max_len - 2, 1), -1.5)):
        got = t_jg.jagged_to_padded_dense(T(vals), T(offsets), width, pad)
        want = j_jg.jagged_to_padded_dense(jnp.asarray(vals), jnp.asarray(offsets), width, pad)
        np.testing.assert_array_equal(_np(got), _np(want))
    dense = t_jg.jagged_to_padded_dense(T(vals), T(offsets), max_len)
    back = t_jg.dense_to_jagged(dense, T(offsets))
    np.testing.assert_array_equal(_np(back), _np(j_jg.dense_to_jagged(jnp.asarray(_np(dense)), jnp.asarray(offsets))))
    np.testing.assert_array_equal(_np(back)[: offsets[-1]], vals[: offsets[-1]])
    assert not _np(back)[offsets[-1]:].any()


def test_concat_and_split_match_jax():
    """`concat_2D_jagged`, `split_2D_jagged` back, and
    `concat_2D_jagged_dense_first`, with garbage in the padding."""
    rng = np.random.default_rng(3)
    B, D = 5, 4
    _, off_l, vl = _jagged(rng, B, 6, D, garbage=3.0)
    _, off_r, vr = _jagged(rng, B, 3, D, garbage=-4.0)
    got, got_off = t_jg.concat_2D_jagged(T(vl), T(off_l), T(vr), T(off_r))
    want, want_off = jax.jit(j_jg.concat_2D_jagged)(jnp.asarray(vl), jnp.asarray(off_l), jnp.asarray(vr),
                                                    jnp.asarray(off_r))
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(got_off), _np(want_off))
    gl, gr = t_jg.split_2D_jagged(got, got_off, T(off_l), T(off_r), vl.shape[0], vr.shape[0])
    wl, wr = jax.jit(j_jg.split_2D_jagged, static_argnums=(4, 5))(
        want, want_off, jnp.asarray(off_l), jnp.asarray(off_r), vl.shape[0], vr.shape[0])
    np.testing.assert_array_equal(_np(gl), _np(wl))
    np.testing.assert_array_equal(_np(gr), _np(wr))
    np.testing.assert_array_equal(_np(gl)[: off_l[-1]], vl[: off_l[-1]])
    dense = rng.standard_normal((B, 2, D)).astype(np.float32)
    got, got_off = t_jg.concat_2D_jagged_dense_first(T(dense), T(vr), T(off_r))
    want, want_off = jax.jit(j_jg.concat_2D_jagged_dense_first)(jnp.asarray(dense), jnp.asarray(vr),
                                                                jnp.asarray(off_r))
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(got_off), _np(want_off))


def test_bmm_reduce_and_mask_lengths_match_jax():
    """`jagged_dense_bmm_broadcast_add`, `jagged_reduce_sum` (garbage in the
    padding ignored) and `jagged_boolean_mask_lengths`."""
    rng = np.random.default_rng(1)
    B, N, D, K = 4, 5, 3, 6
    _, offsets, v = _jagged(rng, B, N, D, garbage=99.0)
    w = rng.standard_normal((B, D, K)).astype(np.float32)
    bias = rng.standard_normal((B, K)).astype(np.float32)
    got = t_jg.jagged_dense_bmm_broadcast_add(T(v), T(offsets), T(w), T(bias), max_len=N)
    want = j_jg.jagged_dense_bmm_broadcast_add(jnp.asarray(v), jnp.asarray(offsets), jnp.asarray(w), jnp.asarray(bias),
                                               max_len=N)
    np.testing.assert_allclose(_np(got), _np(want), **CLOSE)
    np.testing.assert_allclose(_np(t_jg.jagged_reduce_sum(T(v), T(offsets))),
                               _np(j_jg.jagged_reduce_sum(jnp.asarray(v), jnp.asarray(offsets))), **CLOSE)
    lengths = np.array([5, 0, 3, 2], np.int32)
    keep = rng.random((B, N)) < 0.6
    np.testing.assert_array_equal(_np(t_jg.jagged_boolean_mask_lengths(T(lengths), T(keep), N)),
                                  _np(j_jg.jagged_boolean_mask_lengths(jnp.asarray(lengths), jnp.asarray(keep), N)))


def test_norms_match_jax():
    """`rms_norm` (with and without a weight) and `swish_layer_norm`."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 12)).astype(np.float32) * 2
    w, b = rng.standard_normal(12).astype(np.float32), rng.standard_normal(12).astype(np.float32)
    for got, want in (
        (t_norm.rms_norm(T(x)), j_norm.rms_norm(jnp.asarray(x))),
        (t_norm.rms_norm(T(x), T(w), eps=1e-5), j_norm.rms_norm(jnp.asarray(x), jnp.asarray(w), eps=1e-5)),
        (t_norm.swish_layer_norm(T(x), T(w), T(b)), j_norm.swish_layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))),
    ):
        np.testing.assert_allclose(_np(got), _np(want), **CLOSE)


def _jagged_qkv(rng, B, N, H, D, V, min_len=1):
    lengths = rng.integers(min_len, N + 1, size=(B,)).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    cap, tot = B * N, offsets[-1]
    q, k = (np.zeros((cap, H, D), np.float32) for _ in range(2))
    v = np.zeros((cap, H, V), np.float32)
    for t_ in (q, k):
        t_[:tot] = rng.standard_normal((tot, H, D))
    v[:tot] = rng.standard_normal((tot, H, V))
    return lengths, offsets, q, k, v


def test_hstu_mha_matches_jax():
    """Jagged `hstu_mha` with targets, a window and contextual rows against
    the JAX XLA function, every slot (zeros past the total)."""
    rng = np.random.default_rng(0)
    B, N, H, D, V = 4, 10, 2, 3, 4
    lengths, offsets, q, k, v = _jagged_qkv(rng, B, N, H, D, V)
    nt = np.minimum(rng.integers(0, 3, size=(B,)), lengths - 1).astype(np.int32)
    kw = dict(causal=True, max_attn_len=4, contextual_seq_len=2)
    want = J_MHA(N, 0.5, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(offsets),
                           num_targets=jnp.asarray(nt), **kw)
    got = t_attn.hstu_mha(N, 0.5, T(q), T(k), T(v), T(offsets), num_targets=T(nt), **kw)
    np.testing.assert_allclose(_np(got), _np(want), **ATTN)
    assert not _np(got)[offsets[-1]:].any()


def test_hstu_mha_dropout_matches_jax(monkeypatch):
    """`hstu_mha` with attention dropout (the plain composite): the JAX
    function's Bernoulli keep-mask drawn from its key and handed to the
    port's composite as its uniform draw; weights kept are scaled by 1 / (1 - p) after the mask."""
    rng = np.random.default_rng(5)
    B, N, H, D, V = 3, 8, 2, 4, 4
    lengths, offsets, q, k, v = _jagged_qkv(rng, B, N, H, D, V)
    key, p = jax.random.PRNGKey(3), 0.3
    keep = np.array(jax.random.bernoulli(key, 1.0 - p, (B, H, N, N)))
    want = J_MHA(N, 0.5, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(offsets),
                           dropout_pr=p, dropout_rng=key)
    real = t_attn.hstu_mha_dense

    def given_mask(*a, **kw):  # the composite's uniform draw: 0 where JAX keeps, 1 where it drops
        with pytest.MonkeyPatch.context() as m:
            m.setattr(torch, "rand", lambda shape, **_: torch.where(T(keep), 0.0, 1.0))
            return real(*a, **kw)

    monkeypatch.setattr(t_attn, "hstu_mha_dense", given_mask)
    got = t_attn.hstu_mha(N, 0.5, T(q), T(k), T(v), T(offsets), dropout_pr=p, dropout_gen=torch.Generator())
    np.testing.assert_allclose(_np(got), _np(want), **ATTN)
    monkeypatch.setattr(t_attn, "hstu_mha_dense", real)
    drawn = t_attn.hstu_mha(N, 0.5, T(q), T(k), T(v), T(offsets), dropout_pr=p,
                            dropout_gen=torch.Generator().manual_seed(0))
    assert not torch.allclose(drawn, got)
    with pytest.raises(ValueError, match="Generator"):
        t_attn.hstu_mha(N, 0.5, T(q), T(k), T(v), T(offsets), dropout_pr=p)


@pytest.mark.parametrize("delta", [1, 3])
def test_delta_hstu_mha_matches_jax_and_the_full_rows(delta):
    """`delta_hstu_mha` against the JAX XLA function, and against rows
    [len - delta, len) of the full jagged attention."""
    rng = np.random.default_rng(7)
    B, N, H, D, V = 3, 12, 2, 4, 4
    lengths, offsets, q, k, v = _jagged_qkv(rng, B, N, H, D, V, min_len=delta + 1)
    nt = np.minimum(rng.integers(0, delta + 1, size=(B,)), lengths - 1).astype(np.int32)
    delta_q = np.stack([q[offsets[b + 1] - delta + i] for b in range(B) for i in range(delta)])
    want = J_DELTA(N, 0.7, jnp.asarray(delta_q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(offsets),
                                 num_targets=jnp.asarray(nt))
    got = t_attn.delta_hstu_mha(N, 0.7, T(delta_q), T(k), T(v), T(offsets), num_targets=T(nt))
    np.testing.assert_allclose(_np(got), _np(want), **ATTN)
    full = _np(t_attn.hstu_mha(N, 0.7, T(q), T(k), T(v), T(offsets), num_targets=T(nt)))
    rows = np.stack([full[offsets[b + 1] - delta + i] for b in range(B) for i in range(delta)])
    np.testing.assert_allclose(_np(got), rows, **ATTN)
