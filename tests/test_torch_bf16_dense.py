"""K1 and K2 on bfloat16 (the bias-free research model's first block under
``compute_dtype="bfloat16"``) in the PyTorch port against the JAX package,
on the CPU at a small size.

* The bfloat16 plain versions of K1 and K2 (`_dense_fwd_plain_bf16`,
  `_dense_bwd_plain_bf16`, the CPU path of `hstu_mha_dense_cuda` and
  `hstu_mha_bwd_cuda` on bfloat16) against `hstu_mha_dense_pallas` in
  interpret mode and its `jax.vjp`, on the same bfloat16 inputs made with
  numpy: alpha 1 and 1/8, targets, contextual rows, a row of length 0.
* A case where rounding P to bfloat16 changes the answer: the plain version
  rounds where the kernels round.
* The bias-free bfloat16 model and one training step against the JAX model
  with ``attn_kernel="pallas"`` (interpret mode), through `convert.py`'s
  weights.
* `_HstuMhaDense` on bfloat16, driven on the CPU with K1's launch replaced
  by a stand-in: K1-bf16 then K2-bf16, autograd's gradients; under
  deterministic algorithms it asks `hstu_mha_bwd_cuda` for the split, which
  on bfloat16 CUDA tensors raises (K3/K4-bf16 are not built), or warns and
  takes K2-bf16 with ``warn_only``.

Tolerances, as `tests/test_torch_bf16.py`'s: the kernels' bfloat16 outputs
within 2^-7 of their largest entry (two roundings: a float32 sum that lands
near a rounding boundary rounds the other way when its terms come in
another order); the model's outputs (l2-normalised) within 4e-3 absolute; a
step's loss within 1e-4 relative; a gradient within 3e-2 of its largest
entry, the JAX package's own bfloat16 tolerance (the first block's bfloat16
u, q, k and v carry a rounding into every gradient, and the two packages
round silu at different points).
"""

import importlib
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from generative_recommenders_tpu.data import features as j_features
from generative_recommenders_tpu.models import sequential as j_seq
from generative_recommenders_tpu.ops.pallas.hstu_attention import hstu_mha_dense_pallas
from generative_recommenders_tpu_torch.convert import params_from_flax
from generative_recommenders_tpu_torch.data import features as t_features
from generative_recommenders_tpu_torch.models import sequential as t_seq
from generative_recommenders_tpu_torch.ops.cuda import hstu_attention as ha

j_train = importlib.import_module("generative_recommenders_tpu.train.train_loop")
t_train = importlib.import_module("generative_recommenders_tpu_torch.train.train_loop")

KERNEL_TOL = 2.0**-7  # of the largest entry: the kernels' bfloat16 outputs
MODEL_ATOL = 4e-3
LOSS_RTOL = 1e-4
GRAD_TOL = 3e-2  # of each gradient's largest entry
NUM_ITEMS = 120
SMALL = dict(
    main_module="HSTU", num_items=NUM_ITEMS, max_sequence_len=36, gr_output_length=3,
    item_embedding_dim=32, num_blocks=2, num_heads=2, dqk=16, dv=16,
    linear_dropout_rate=0.0, dropout_rate=0.0, compute_dtype="bfloat16",
    enable_relative_attention_bias=False,
)  # N = 36 + 3 + 1 = 40

CASES = [
    dict(),
    dict(num_targets=True),
    dict(num_targets=True, contextual_seq_len=3),
    dict(max_attn_len=6, min_full_attn_seq_len=4),
]


def _close_to_max(got, want, tol, what=""):
    got = np.asarray(torch.as_tensor(got).detach().float(), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err:.2e} of the largest entry"


def _kernel_inputs(seed, B, N, H, D, V, ctx, targets):
    """bfloat16-exact q, k, v and dO (float32 arrays of bfloat16 values),
    lengths with one full row and one of length 0, and targets or None."""
    rng = np.random.default_rng(seed)
    bf = lambda a: np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    q, k = (bf(rng.standard_normal((B, N, H, D)) * 0.5) for _ in range(2))
    v = bf(rng.standard_normal((B, N, H, V)) * 0.5)
    do = bf(rng.standard_normal((B, N, H, V)))
    lengths = rng.integers(ctx + 2, N + 1, size=(B,)).astype(np.int32)
    lengths[0], lengths[-1] = N, 0
    nt = None
    if targets:
        nt = np.minimum(rng.integers(0, 4, size=(B,)), np.maximum(lengths - ctx - 1, 0)).astype(np.int32)
    return q, k, v, do, lengths, nt


@pytest.mark.parametrize("alpha", [1.0, 0.125])
@pytest.mark.parametrize("case", CASES)
def test_bf16_plain_matches_pallas_interpret(case, alpha):
    """K1-bf16's and K2-bf16's plain versions, through the wrappers' CPU
    paths, against the Pallas forward and its VJP (the fused backward, the
    resident path at this size) in interpret mode on bfloat16."""
    case = dict(case)
    targets = case.pop("num_targets", False)
    B, N, H, D, V = 3, 48, 2, 16, 16
    q, k, v, do, lengths, nt = _kernel_inputs(17, B, N, H, D, V, case.get("contextual_seq_len", 0), targets)
    kw = dict(alpha=alpha, max_seq_len=N + 4, causal=True, **case)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731

    def fwd(q_, k_, v_):
        return hstu_mha_dense_pallas(
            q_, k_, v_, jnp.asarray(lengths), num_targets=None if nt is None else jnp.asarray(nt),
            block_q=16, block_k=16, interpret=True, **kw,
        )

    want_out, vjp = jax.vjp(fwd, bf(q), bf(k), bf(v))
    want = vjp(bf(do))
    t = lambda a: torch.as_tensor(a).to(torch.bfloat16)  # noqa: E731
    tkw = dict(kw, num_targets=None if nt is None else torch.as_tensor(nt))
    got_out = ha.hstu_mha_dense_cuda(t(q), t(k), t(v), torch.as_tensor(lengths), **tkw)
    got = ha.hstu_mha_bwd_cuda(t(q), t(k), t(v), torch.as_tensor(lengths), t(do), **tkw)
    assert got_out.dtype == torch.bfloat16 and all(g.dtype == torch.bfloat16 for g in got)
    _close_to_max(got_out, want_out, KERNEL_TOL, "out")
    for name, g, w in zip(("dq", "dk", "dv"), got, want, strict=True):
        _close_to_max(g, w, KERNEL_TOL, name)
    dead = torch.arange(N)[None, :] >= torch.as_tensor(lengths)[:, None]
    for g in (got_out, *got):
        assert (g[dead] == 0).all()


def test_bf16_plain_rounds_where_the_kernels_round():
    """P enters P V rounded to bfloat16, and alpha q is rounded to bfloat16
    before S: the forward equals the float32 formula with both rounded, not
    the unrounded ones; in the backward dS is rounded before dS K."""
    rng = np.random.default_rng(5)
    B, N, H, D = 2, 20, 1, 8
    q, k, v, do = (torch.as_tensor(rng.standard_normal((B, N, H, D)).astype(np.float32)).to(torch.bfloat16)
                   for _ in range(4))
    lengths = torch.tensor([20, 9])
    alpha = 0.3  # alpha q is not a bfloat16 value
    got = ha.hstu_mha_dense_plain(q, k, v, lengths, alpha=alpha)
    live = torch.arange(N)[None, :] < lengths[:, None]
    mask = (torch.tril(torch.ones(N, N, dtype=torch.bool))[None] & live[:, None, :] & live[:, :, None])[:, None]
    bf = lambda x: x.to(torch.bfloat16).float()  # noqa: E731

    def out(qs, round_p):
        p = torch.where(mask, torch.nn.functional.silu(torch.einsum("bnhd,bmhd->bhnm", qs, k.float())), 0.0)
        return (torch.einsum("bhnm,bmhv->bnhv", bf(p) if round_p else p, v.float()) / N).to(torch.bfloat16)

    qs = bf(q.float() * bf(torch.tensor(alpha)))
    assert torch.equal(got, out(qs, True))
    assert not torch.equal(got, out(qs, False)) and not torch.equal(got, out(q.float() * alpha, True))
    # the backward: dq from bfloat16 dS, not from the float32 dS
    dq = ha.hstu_mha_bwd_cuda(q, k, v, lengths, do, alpha=alpha)[0]
    s = torch.einsum("bnhd,bmhd->bhnm", qs, k.float())
    sig = torch.sigmoid(s)
    dob = bf(do.float() * bf(torch.tensor(1.0 / N)))
    ds = torch.where(mask, torch.einsum("bnhv,bmhv->bhnm", dob, v.float()) * sig * (1 + s * (1 - sig)), 0.0)
    dq_of = lambda d: (torch.einsum("bhnm,bmhd->bnhd", d, k.float()) * alpha).to(torch.bfloat16)  # noqa: E731
    assert torch.equal(dq, dq_of(bf(ds))) and not torch.equal(dq, dq_of(ds))


# ------------------------------------------------------------------ model
def _batch(seed, B, max_len):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, max_len + 1, size=(B,))
    lengths[0] = max_len
    live = np.arange(max_len)[None, :] < lengths[:, None]
    ts = 1_400_000_000 + np.cumsum(rng.integers(60, 86400, size=(B, max_len + 1)), axis=1)
    return {
        "user_id": np.arange(1, B + 1, dtype=np.int64),
        "historical_ids": rng.integers(1, NUM_ITEMS + 1, size=(B, max_len)) * live,
        "historical_ratings": rng.integers(1, 6, size=(B, max_len)) * live,
        "historical_timestamps": ts[:, :-1] * live,
        "history_lengths": lengths.astype(np.int64),
        "target_ids": rng.integers(1, NUM_ITEMS + 1, size=(B,)),
        "target_ratings": rng.integers(1, 6, size=(B,)),
        "target_timestamps": ts[np.arange(B), lengths],
    }


def _flax_to_torch(tree):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, tree))


def test_bias_free_bf16_model_matches_jax_pallas():
    """The user embeddings [B, N, D] of the bias-free bfloat16 model
    (dropout off) against the JAX model on its Pallas attention (interpret
    mode), every row; block 0's attention runs on bfloat16 in both."""
    jm = j_seq.SequentialRecommender(j_seq.ModelConfig(attn_kernel="pallas", **SMALL))
    N = jm.config.total_seq_len
    params = jm.init(
        jax.random.PRNGKey(0), jnp.ones((2,), jnp.int32), jnp.zeros((2, N), jnp.int32),
        {"timestamps": jnp.zeros((2, N), jnp.int32), "ratings": jnp.zeros((2, N), jnp.int32)},
        method=j_seq.SequentialRecommender.initialize,
    )
    tm = t_seq.SequentialRecommender(t_seq.ModelConfig(**SMALL), torch.Generator().manual_seed(0))
    tm.load_state_dict(_flax_to_torch(params), strict=True)
    batch = _batch(3, B=4, max_len=36)
    out_len = SMALL["gr_output_length"] + 1
    jf, _, _ = j_features.seq_features_from_row({k: jnp.asarray(v) for k, v in batch.items()},
                                                max_output_length=out_len)
    tf, _, _ = t_features.seq_features_from_row({k: torch.as_tensor(v) for k, v in batch.items()},
                                                max_output_length=out_len)
    j_emb = jm.apply(params, jf.past_ids, method=j_seq.SequentialRecommender.get_item_embeddings)
    want = np.asarray(jm.apply(params, jf.past_lengths, jf.past_ids, j_emb, jf.past_payloads, True))
    types = []
    real = ha.hstu_mha_dense_cuda
    from generative_recommenders_tpu_torch.models import hstu as t_hstu

    def spy(q, *args, **kw):
        types.append(q.dtype)
        return real(q, *args, **kw)

    t_hstu.hstu_mha_dense_cuda = spy
    try:
        with torch.no_grad():
            got = tm(tf.past_lengths, tf.past_ids, tm.get_item_embeddings(tf.past_ids), tf.past_payloads,
                     deterministic=True)
    finally:
        t_hstu.hstu_mha_dense_cuda = real
    assert types == [torch.bfloat16, torch.float32]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MODEL_ATOL)


class _FixedNegatives:
    """Negatives that depend on the positives only, for both packages."""

    def __init__(self, all_item_ids, sampler, xp):
        self.ids, self.sampler, self.xp = all_item_ids, sampler, xp

    def __call__(self, rng, positive_ids, num_to_sample, item_embedding_fn):
        r = self.xp.arange(num_to_sample)
        offsets = (positive_ids[..., None] * 7 + r * 13 + 1) % self.ids.shape[0]
        sampled = self.ids[offsets]
        return sampled, self.sampler.normalize_embeddings(item_embedding_fn(sampled))


def test_bias_free_bf16_step_loss_and_gradients_match_jax_pallas():
    """One batch's loss and every parameter's gradient of the bias-free
    bfloat16 model against the JAX trainer on its Pallas attention
    (interpret mode: K1 and K2 on bfloat16 in block 0)."""
    ids = np.arange(1, NUM_ITEMS + 1)
    kw = dict(local_batch_size=4, eval_batch_size=4, num_negatives=6)
    jt = j_train.ResearchTrainer(j_train.TrainConfig(model=j_seq.ModelConfig(attn_kernel="pallas", **SMALL), **kw), ids)
    jt.sampler = _FixedNegatives(jnp.asarray(ids), jt.sampler, jnp)
    params = jt.init_params(jax.random.PRNGKey(0))
    tt = t_train.ResearchTrainer(t_train.TrainConfig(model=t_seq.ModelConfig(**SMALL), **kw), ids, device="cpu")
    tt.sampler = _FixedNegatives(torch.as_tensor(ids), tt.sampler, torch)
    tt.model.load_state_dict(_flax_to_torch(params), strict=True)
    batch = _batch(8, B=4, max_len=36)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (want_loss, _), want = jax.value_and_grad(jt._loss, has_aux=True)(params, jb, jax.random.PRNGKey(1))
    loss, _ = tt.loss(t_train.to_device(batch, tt.device))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    want = _flax_to_torch(want)
    got = {n: p.grad for n, p in tt.model.named_parameters()}
    assert set(got) == set(want) and all(g is not None and g.dtype == torch.float32 for g in got.values())
    for name, w in want.items():
        _close_to_max(got[name], w, GRAD_TOL, name)


# ---------------------------------------------------- the autograd function
def _through_the_function(monkeypatch, deterministic, warn_only=False):
    """`_HstuMhaDense` on bfloat16 q, k, v (views of one projection), K1's
    launch replaced by the bfloat16 plain forward and the backward wrapper
    recorded: (the recorded calls, the gradients of the three leaves, the
    plain version's)."""
    rng = np.random.default_rng(9)
    B, N, H, D, V = 2, 24, 2, 8, 8
    proj = torch.as_tensor(rng.standard_normal((B, N, H * (2 * D + V))).astype(np.float32)).to(torch.bfloat16)
    lengths, nt = torch.tensor([24, 13]), torch.tensor([3, 1], dtype=torch.int32)
    kw = dict(alpha=0.5, max_seq_len=30, causal=True, max_attn_len=0, contextual_seq_len=0,
              min_full_attn_seq_len=0)
    weight = torch.as_tensor(rng.standard_normal((N, B, H * V)).astype(np.float32)).transpose(0, 1)
    called = []

    def fwd(q_, k_, v_, lens, nt_, kw_):
        called.append(("K1-bf16" if q_.dtype == torch.bfloat16 else "K1"))
        return ha.hstu_mha_dense_plain(q_, k_, v_, lens, num_targets=nt_, **kw_)

    bwd = ha.hstu_mha_bwd_cuda

    def bwd_spy(q_, *a, **kw_):
        called.append("K3+K4" if kw_["split"] else ("K2-bf16" if q_.dtype == torch.bfloat16 else "K2"))
        return bwd(q_, *a, **kw_)

    monkeypatch.setattr(ha, "_dense_fwd", fwd)
    monkeypatch.setattr(ha, "hstu_mha_bwd_cuda", bwd_spy)

    def grads(apply):
        leaf = proj.clone().requires_grad_(True)
        v_, q_, k_ = torch.split(leaf, [H * V, H * D, H * D], dim=-1)
        out = apply(q_.reshape(B, N, H, D), k_.reshape(B, N, H, D), v_.reshape(B, N, H, V))
        (out.reshape(B, N, H * V).float() * weight).sum().backward()
        return leaf.grad

    prev, prev_warn = torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(deterministic, warn_only=warn_only)
    try:
        got = grads(lambda q_, k_, v_: ha._HstuMhaDense.apply(q_, k_, v_, lengths, nt, kw))
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=prev_warn)
    want = grads(lambda q_, k_, v_: ha.hstu_mha_dense_plain(q_, k_, v_, lengths, num_targets=nt, **kw))
    return called, got, want


def test_autograd_function_runs_k1_bf16_then_k2_bf16(monkeypatch):
    """On bfloat16 the autograd function calls K1-bf16, then K2-bf16 for
    the backward, and gives the plain version's gradients (its written-out
    backward at the kernels' rounding points); the output gradient arrives
    from a reshape of a transposed buffer, not contiguous."""
    called, got, want = _through_the_function(monkeypatch, deterministic=False)
    assert called == ["K1-bf16", "K2-bf16"]
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _bf16_split_as_on_the_card(monkeypatch):
    """`hstu_mha_bwd_cuda(split=True)` on bfloat16 tensors past its CPU
    branch (meta tensors, the device check passed), each launch recorded and
    not made: the entry points it would launch."""
    launched = []
    monkeypatch.setattr(ha, "_check_qkv", lambda q_, k_, v_, dtypes=(torch.float32,): q_.device)
    monkeypatch.setattr(ha, "_bwd_kernel", lambda name, q_, *a: launched.append(name) or (q_, q_, q_))
    q = torch.zeros(2, 8, 1, 8, dtype=torch.bfloat16, device="meta")
    ha.hstu_mha_bwd_cuda(q, q, q, torch.tensor([8, 3]), q, split=True)
    return launched


@pytest.mark.parametrize("warn_only", [False, True])
def test_bf16_backward_refuses_the_split_under_deterministic_mode(monkeypatch, warn_only):
    """The split backward K3 + K4 takes float32 only. Under
    `torch.use_deterministic_algorithms(True)` the autograd function asks
    `hstu_mha_bwd_cuda` for the split on bfloat16 too (on the CPU the plain
    backward answers, deterministic itself); on the card the wrapper raises
    a RuntimeError that names K3/K4-bf16, or with ``warn_only`` warns and
    launches K2-bf16."""
    called, got, want = _through_the_function(monkeypatch, deterministic=True, warn_only=warn_only)
    assert called == ["K1-bf16", "K3+K4"]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    prev, prev_warn = torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=warn_only)
    try:
        if warn_only:
            with pytest.warns(UserWarning, match="K3/K4-bf16"):
                assert _bf16_split_as_on_the_card(monkeypatch) == ["hstu_mha_bwd_fused_bf16"]
        else:
            with pytest.raises(RuntimeError, match="K3/K4-bf16"):
                _bf16_split_as_on_the_card(monkeypatch)
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=prev_warn)


def test_bf16_backward_wrapper_refuses_the_split(monkeypatch):
    """`hstu_mha_bwd_cuda(split=True)` on bfloat16 CUDA tensors raises
    before anything launches, deterministic algorithms on or off (driven
    here with the device check passed); on CPU tensors the plain backward
    answers without a warning."""
    q = torch.zeros(2, 8, 1, 8, dtype=torch.bfloat16)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        plain = ha.hstu_mha_bwd_cuda(q, q, q, torch.tensor([8, 3]), q, split=True)  # the CPU: the plain backward
    assert all(g.dtype == torch.bfloat16 for g in plain)
    with pytest.raises(RuntimeError, match="K3/K4-bf16"):
        _bf16_split_as_on_the_card(monkeypatch)
