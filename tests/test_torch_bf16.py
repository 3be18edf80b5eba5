"""The PyTorch port's bfloat16 research path (``compute_dtype="bfloat16"``)
and its per-block recomputation (``remat``, ``loss_activation_checkpoint``)
against the JAX package, on the CPU at a small size.

* The bfloat16 plain versions of K6 and K7 against the JAX package's
  relative-bias Pallas kernels in interpret mode on bfloat16 inputs: forward
  and the five gradients (as `tests/test_relbias_attention.py` runs them).
* The research model (HSTU and SASRec) and a training step in bfloat16
  against the JAX package's XLA path, with the types block by block: in
  HSTU the first block runs in bfloat16 and the later block in float32
  (the first block's float32 output projection promotes the residual
  stream), in both packages.
* The KV-cached encode in bfloat16.
* ``remat`` and ``loss_activation_checkpoint``: bit-equal gradients to the
  plain step with dropout on (the recomputation replays the dropout
  generator).

Tolerances, from bfloat16's 8-bit significand (one rounding is 2^-8 = 3.9e-3
relative): the kernels' bfloat16 outputs (out, dq, dk, dv) within 2^-7 of
their largest entry (two roundings: a sum that lands near a rounding
boundary rounds the other way when its float32 terms come in another
order), the table gradients (float32 sums of float32 dS) within 1e-5 of
their largest; the KV caches within 2^-6 of their largest (block 0's k and
v are silu outputs in bfloat16, which the JAX package rounds twice, x *
sigmoid(x), and PyTorch once, and block 1's carry that on); the model's
outputs (l2-normalised, so at most 1) within 4e-3 absolute, one rounding; a step's loss within 1e-4 relative; a gradient
within 3e-2 of its largest entry, the JAX package's own bfloat16 tolerance
(`tests/test_relbias_attention.py`): the first block's bfloat16 u, q, k and v
carry a rounding into every gradient, and the two packages round at
different points there (the JAX package's silu is x * sigmoid(x), two
roundings in bfloat16; PyTorch's one).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from generative_recommenders_tpu.data import features as j_features
from generative_recommenders_tpu.models import sequential as j_seq
from generative_recommenders_tpu.ops.pallas.hstu_attention_relbias import hstu_mha_dense_pallas_relbias
from generative_recommenders_tpu_torch.convert import params_from_flax
from generative_recommenders_tpu_torch.data import features as t_features
from generative_recommenders_tpu_torch.models import sequential as t_seq
from generative_recommenders_tpu_torch.ops.cuda import hstu_attention_relbias as t_rb

j_train = importlib.import_module("generative_recommenders_tpu.train.train_loop")
t_train = importlib.import_module("generative_recommenders_tpu_torch.train.train_loop")

KERNEL_TOL = 2.0**-7  # of the largest entry: the kernels' bfloat16 outputs
TABLE_TOL = 1e-5  # of the largest entry: the float32 table gradients
CACHE_TOL = 2.0**-6  # of the largest entry: the KV caches
MODEL_ATOL = 4e-3
LOSS_RTOL = 1e-4
GRAD_TOL = 3e-2  # of each gradient's largest entry
NUM_ITEMS = 120
SMALL = dict(
    main_module="HSTU", num_items=NUM_ITEMS, max_sequence_len=36, gr_output_length=3,
    item_embedding_dim=32, num_blocks=2, num_heads=2, dqk=16, dv=16,
    linear_dropout_rate=0.0, dropout_rate=0.0, compute_dtype="bfloat16",
)  # N = 36 + 3 + 1 = 40


def _flax_to_torch(tree):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, tree))


def _close_to_max(got, want, tol, what=""):
    got = np.asarray(torch.as_tensor(got).detach().float() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err:.2e} of the largest entry"


# ------------------------------------------------------- K6 / K7 in bfloat16
@pytest.mark.parametrize("B, N, H, D, Nm, lengths, alpha", [
    (2, 70, 2, 8, 80, (70, 41), 1.0),
    (3, 45, 1, 25, 45, (45, 1, 30), 1.0),
    (2, 70, 2, 8, 80, (70, 41), 0.125),
    (3, 45, 1, 25, 45, (45, 1, 30), 0.125),
    (2, 70, 2, 8, 80, (70, 41), 0.3),
    (3, 45, 1, 25, 45, (45, 1, 30), 0.3),
], ids=["N70_D8", "N45_D25", "N70_D8_alpha0.125", "N45_D25_alpha0.125", "N70_D8_alpha0.3", "N45_D25_alpha0.3"])
def test_bf16_plain_kernels_match_pallas_interpret(B, N, H, D, Nm, lengths, alpha):
    """The bfloat16 plain forward and backward (`_RelbiasPlainBf16`, the
    CPU path of `hstu_mha_dense_relbias_cuda`) against `jax.grad` through
    the Pallas kernels in interpret mode, on the same bfloat16 inputs, at
    alpha 1, 1/8 and 0.3. At 0.3, which bfloat16 does not hold exactly,
    bfloat16(alpha q) differs from alpha q in float32, so the case holds the
    port to the kernels' rounding point as well as to their formula."""
    rng = np.random.default_rng(N)
    q, k, v = (rng.standard_normal((B, N, H, D)).astype(np.float32) * 0.3 for _ in range(3))
    lengths = np.asarray(lengths, np.int32)
    ts = (1_600_000_000 + np.cumsum(rng.integers(1, 90000, (B, N)), axis=1)).astype(np.int64)
    pos_w = (rng.standard_normal(2 * Nm - 1) * 0.05).astype(np.float32)
    ts_w = (rng.standard_normal(129) * 0.05).astype(np.float32)
    w = rng.standard_normal((B, N, H, D)).astype(np.float32)

    def loss(q_, k_, v_, pw, tw):
        out = hstu_mha_dense_pallas_relbias(
            q_, k_, v_, jnp.asarray(lengths), jnp.asarray(ts), pw, tw, alpha=alpha,
            block_q=128, block_k=128, interpret=True,
        )
        return jnp.sum(out.astype(jnp.float32) * w), out

    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    (_, want_out), want = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        bf(q), bf(k), bf(v), jnp.asarray(pos_w), jnp.asarray(ts_w))
    leaves = [torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v)]
    leaves += [torch.as_tensor(pos_w), torch.as_tensor(ts_w)]
    for t in leaves:
        t.requires_grad_(True)
    out = t_rb.hstu_mha_dense_relbias_cuda(*leaves[:3], torch.as_tensor(lengths), torch.as_tensor(ts),
                                           *leaves[3:], alpha=alpha)
    assert out.dtype == torch.bfloat16
    (out.float() * torch.as_tensor(w)).sum().backward()
    _close_to_max(out, want_out, KERNEL_TOL, "out")
    for name, t, g in zip(("dq", "dk", "dv", "dpos_w", "dts_w"), leaves, want, strict=True):
        assert t.grad.dtype == t.dtype
        _close_to_max(t.grad, g, KERNEL_TOL if t.dtype == torch.bfloat16 else TABLE_TOL, name)
    # the wrapper of the backward alone: the same five gradients
    do = torch.as_tensor(w).to(torch.bfloat16)  # the gradient of out.float() * w, as autograd casts it
    grads = t_rb.hstu_mha_relbias_bwd_cuda(
        *(t.detach() for t in leaves[:3]), torch.as_tensor(lengths), torch.as_tensor(ts),
        *(t.detach() for t in leaves[3:]), do, alpha=alpha,
    )
    for t, g in zip(leaves, grads, strict=True):
        torch.testing.assert_close(g, t.grad, rtol=0, atol=0)


def test_bf16_plain_rounds_where_the_kernels_round():
    """P enters P V rounded to bfloat16: the forward equals the float32
    formula with P rounded, not the unrounded one; at alpha 0.5 the port
    rounds alpha q to bfloat16, as the TPU kernel does, and matches it."""
    rng = np.random.default_rng(3)
    B, N, H, D = 2, 20, 1, 8
    q, k, v = (torch.as_tensor(rng.standard_normal((B, N, H, D)).astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    lengths, ts = torch.tensor([20, 9]), torch.as_tensor(np.cumsum(rng.integers(1, 9000, (B, N)), axis=1))
    pos_w, ts_w = torch.zeros(2 * N - 1), torch.zeros(129)
    got = t_rb.hstu_mha_dense_relbias_plain(q, k, v, lengths, ts, pos_w, ts_w)
    live = torch.arange(N)[None, :] < lengths[:, None]  # [B, N]
    mask = torch.tril(torch.ones(N, N, dtype=torch.bool))[None] & live[:, None, :] & live[:, :, None]
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
    p = torch.where(mask[:, None], torch.nn.functional.silu(s), 0.0)
    rounded = (torch.einsum("bhnm,bmhv->bnhv", p.to(torch.bfloat16).float(), v.float()) / N).to(torch.bfloat16)
    unrounded = (torch.einsum("bhnm,bmhv->bnhv", p, v.float()) / N).to(torch.bfloat16)
    assert torch.equal(got, rounded) and not torch.equal(got, unrounded)
    half = t_rb.hstu_mha_dense_relbias_plain(q, k, v, lengths, ts, pos_w, ts_w, alpha=0.5)
    want = hstu_mha_dense_pallas_relbias(
        *(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)), jnp.asarray(lengths.numpy()),
        jnp.asarray(ts.numpy()), jnp.asarray(pos_w.numpy()), jnp.asarray(ts_w.numpy()), alpha=0.5,
        block_q=128, block_k=128, interpret=True,
    )
    assert half.dtype == torch.bfloat16
    _close_to_max(half, want, KERNEL_TOL, "out at alpha 0.5")


# ------------------------------------------------------------------- model
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


def _model_pair(**over):
    kw = {**SMALL, **over}
    jm = j_seq.SequentialRecommender(j_seq.ModelConfig(attn_kernel="xla", **kw))
    N = jm.config.total_seq_len
    params = jm.init(
        jax.random.PRNGKey(0), jnp.ones((2,), jnp.int32), jnp.zeros((2, N), jnp.int32),
        {"timestamps": jnp.zeros((2, N), jnp.int32), "ratings": jnp.zeros((2, N), jnp.int32)},
        method=j_seq.SequentialRecommender.initialize,
    )
    tm = t_seq.SequentialRecommender(t_seq.ModelConfig(**kw), torch.Generator().manual_seed(0))
    tm.load_state_dict(_flax_to_torch(params), strict=True)
    return jm, params, tm


def _features(batch):
    jf, _, _ = j_features.seq_features_from_row({k: jnp.asarray(v) for k, v in batch.items()},
                                                max_output_length=SMALL["gr_output_length"] + 1)
    tf, _, _ = t_features.seq_features_from_row({k: torch.as_tensor(v) for k, v in batch.items()},
                                                max_output_length=SMALL["gr_output_length"] + 1)
    return jf, tf


@pytest.mark.parametrize("main_module", ["HSTU", "SASRec"])
def test_bf16_model_matches_jax(main_module):
    """The user embeddings [B, N, D] of the bfloat16 model (dropout off),
    float32 after the output postprocessor, against the JAX package's XLA
    path on the rows below each length (its XLA path leaves values past
    them)."""
    jm, params, tm = _model_pair(main_module=main_module)
    batch = _batch(3, B=4, max_len=36)
    jf, tf = _features(batch)
    j_emb = jm.apply(params, jf.past_ids, method=j_seq.SequentialRecommender.get_item_embeddings)
    want = np.asarray(jm.apply(params, jf.past_lengths, jf.past_ids, j_emb, jf.past_payloads, True))
    with torch.no_grad():
        got = tm(tf.past_lengths, tf.past_ids, tm.get_item_embeddings(tf.past_ids), tf.past_payloads,
                 deterministic=True)
    assert got.dtype == torch.float32
    for b, n in enumerate(batch["history_lengths"]):
        np.testing.assert_allclose(got[b, :n].numpy(), want[b, :n], rtol=0, atol=MODEL_ATOL)


def test_bf16_runs_the_first_hstu_block_only_in_bfloat16():
    """Block 0 takes bfloat16 and gives float32 (its float32 output
    projection promotes the residual), every later block float32 in and
    out, in both packages; block 0's attention goes through the bfloat16
    relative-bias function."""
    jm, params, tm = _model_pair()
    batch = _batch(4, B=2, max_len=36)
    jf, tf = _features(batch)
    j_emb = jm.apply(params, jf.past_ids, method=j_seq.SequentialRecommender.get_item_embeddings)

    def keep_blocks(mdl, method_name):
        return method_name == "__call__" and mdl.name is not None and mdl.name.startswith("layer_")

    _, state = jm.apply(params, jf.past_lengths, jf.past_ids, j_emb, jf.past_payloads, True,
                        capture_intermediates=keep_blocks, mutable=["intermediates"])
    j_types = [state["intermediates"]["encoder"][f"layer_{i}"]["__call__"][0].dtype for i in range(2)]
    assert [str(t) for t in j_types] == ["float32"] * 2

    seen = []
    hooks = [getattr(tm.encoder, f"layer_{i}").register_forward_hook(
        lambda mod, args, out: seen.append((args[0].dtype, out.dtype))) for i in range(2)]
    attn_types = []
    real = t_rb.hstu_mha_dense_relbias_cuda
    from generative_recommenders_tpu_torch.models import hstu as t_hstu

    def spy(q, *args, **kw):
        attn_types.append(q.dtype)
        return real(q, *args, **kw)

    t_hstu.hstu_mha_dense_relbias_cuda = spy
    try:
        with torch.no_grad():
            tm(tf.past_lengths, tf.past_ids, tm.get_item_embeddings(tf.past_ids), tf.past_payloads,
               deterministic=True)
    finally:
        t_hstu.hstu_mha_dense_relbias_cuda = real
        for h in hooks:
            h.remove()
    bf, f32 = torch.bfloat16, torch.float32
    assert seen == [(bf, f32), (f32, f32)]
    assert attn_types == [bf, f32]


class _FixedNegatives:
    """Negatives that depend on the positives only, for both packages; the
    embedding function is the trainer's (the bfloat16 table's gather)."""

    def __init__(self, all_item_ids, sampler, xp):
        self.ids, self.sampler, self.xp = all_item_ids, sampler, xp

    def __call__(self, rng, positive_ids, num_to_sample, item_embedding_fn):
        r = self.xp.arange(num_to_sample)
        offsets = (positive_ids[..., None] * 7 + r * 13 + 1) % self.ids.shape[0]
        sampled = self.ids[offsets]
        return sampled, self.sampler.normalize_embeddings(item_embedding_fn(sampled))


@pytest.mark.parametrize("main_module", ["HSTU", "SASRec"])
def test_bf16_step_loss_and_gradients_match_jax(main_module):
    """One batch's loss and every parameter's gradient in bfloat16, the
    negatives gathered from the bfloat16 copy of the item table on both
    sides (their gradient reaches the float32 table through the cast)."""
    ids = np.arange(1, NUM_ITEMS + 1)
    kw = dict(local_batch_size=4, eval_batch_size=4, num_negatives=6)
    model = {**SMALL, "main_module": main_module}
    jt = j_train.ResearchTrainer(j_train.TrainConfig(model=j_seq.ModelConfig(attn_kernel="xla", **model), **kw), ids)
    jt.sampler = _FixedNegatives(jnp.asarray(ids), jt.sampler, jnp)
    params = jt.init_params(jax.random.PRNGKey(0))
    tt = t_train.ResearchTrainer(t_train.TrainConfig(model=t_seq.ModelConfig(**model), **kw), ids, device="cpu")
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


def test_bf16_kv_cached_encode_matches_jax():
    """`encode_with_cache` and `encode_delta` in bfloat16: block 0's caches
    are bfloat16 and the later blocks' float32, in both packages; the
    embeddings and the extended caches agree with the JAX package's below
    each new length."""
    jm, params, tm = _model_pair(max_sequence_len=12, gr_output_length=1, num_items=60,
                                 item_embedding_dim=16, num_blocks=2, dqk=8, dv=8)
    tm.eval()
    rng = np.random.default_rng(6)
    Bc, M, Ncap = 3, 2, tm.config.total_seq_len
    lengths = np.array([Ncap - M, 4, 7])
    ids, ts = np.zeros((Bc, Ncap), np.int64), np.zeros((Bc, Ncap), np.int64)
    for b, n in enumerate(lengths):
        ids[b, :n] = rng.integers(1, 60, size=n)
        ts[b, :n] = np.sort(rng.integers(1, 1 << 20, size=n))
    d_ids = rng.integers(1, 60, size=(Bc, M))
    d_ts = ts[np.arange(Bc), lengths - 1][:, None] + np.arange(1, M + 1)[None, :] * 100
    full_ts = ts.copy()
    full_ts[np.arange(Bc)[:, None], lengths[:, None] + np.arange(M)[None, :]] = d_ts
    pre_ts = ts.copy()
    pre_ts[np.arange(Bc), lengths] = d_ts[:, 0]
    pay = lambda t, xp: {"timestamps": xp(t), "ratings": xp(np.ones_like(t))}  # noqa: E731
    T, J = torch.as_tensor, jnp.asarray
    with torch.no_grad():
        emb = tm.get_item_embeddings
        q0, caches = tm.encode_with_cache(T(lengths), T(ids), emb(T(ids)), pay(pre_ts, T), reserved_slots=M)
        got, new = tm.encode_delta(T(lengths), T(d_ids), emb(T(d_ids)), pay(full_ts, T), caches)
    j_emb = lambda i: jm.apply(params, i, method=j_seq.SequentialRecommender.get_item_embeddings)  # noqa: E731
    j_q0, j_caches = jm.apply(params, J(lengths), J(ids), j_emb(J(ids)), pay(pre_ts, J), M,
                              method=j_seq.SequentialRecommender.encode_with_cache)
    j_got, j_new = jm.apply(params, J(lengths), J(d_ids), j_emb(J(d_ids)), pay(full_ts, J), j_caches,
                            method=j_seq.SequentialRecommender.encode_delta)
    assert [c[0].dtype for c in caches] == [torch.bfloat16, torch.float32]
    assert [str(c[0].dtype) for c in j_caches] == ["bfloat16", "float32"]
    np.testing.assert_allclose(q0.numpy(), np.asarray(j_q0), rtol=0, atol=MODEL_ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_got), rtol=0, atol=MODEL_ATOL)
    for (tk, tv), (jk, jv) in zip(new, j_new, strict=True):
        assert tk.dtype == tv.dtype and str(jk.dtype) == str(tk.dtype).replace("torch.", "")
        for b, n in enumerate(lengths + M):
            for t_, j_ in ((tk, jk), (tv, jv)):
                _close_to_max(t_[b, :n], np.asarray(jnp.asarray(j_, jnp.float32))[b, :n], CACHE_TOL)


# ---------------------------------------------------- remat, loss checkpoint
def _step_grads(remat, loss_checkpoint, compute_dtype):
    """One step's loss and gradients with dropout on (rate 0.2 in the
    preprocessor and every block) from seed 42, and the dropout generator's
    state after the backward."""
    model = {**SMALL, "linear_dropout_rate": 0.2, "dropout_rate": 0.2, "remat": remat,
             "compute_dtype": compute_dtype}
    tt = t_train.ResearchTrainer(
        t_train.TrainConfig(model=t_seq.ModelConfig(**model), local_batch_size=4, num_negatives=6,
                            loss_activation_checkpoint=loss_checkpoint),
        np.arange(1, NUM_ITEMS + 1), device="cpu",
    )
    loss, _ = tt.loss(t_train.to_device(_batch(8, B=4, max_len=36), tt.device))
    loss.backward()
    grads = {n: p.grad.clone() for n, p in tt.model.named_parameters()}
    return loss.detach(), grads, tt.dropout_gen.get_state()


@pytest.mark.parametrize("remat, loss_checkpoint, compute_dtype", [
    (True, False, "float32"),
    (False, True, "float32"),
    (True, True, "float32"),
    (True, False, "bfloat16"),
], ids=["remat", "loss_checkpoint", "both", "remat_bf16"])
def test_recomputation_gives_bit_equal_gradients(remat, loss_checkpoint, compute_dtype):
    """The recomputed step and the plain one: the same loss and every
    gradient bit for bit on the CPU, with dropout on, and the dropout
    generator left where the plain step leaves it (a checkpoint that did
    not replay the generator would draw other masks in the recomputation
    and give other gradients)."""
    want_loss, want, want_state = _step_grads(False, False, compute_dtype)
    loss, got, state = _step_grads(remat, loss_checkpoint, compute_dtype)
    assert torch.equal(loss, want_loss)
    assert set(got) == set(want)
    for name, w in want.items():
        assert torch.equal(got[name], w), name
    assert torch.equal(state, want_state)
