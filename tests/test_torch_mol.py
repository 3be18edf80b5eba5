"""The PyTorch port's MoL (Mixture-of-Logits, RAILS) learned similarity
against the JAX package, on the CPU at a small size: the GLU layers,
`MoLSimilarity` (joint and decoupled, the three gating combinations, the uid
tables), the load-balancing loss and the softmax-dropout combiner, a MoL
trainer step, the MoL eval's ranks and `MoLBruteForceTopK` through
`CandidateIndex`. JAX weights are carried over by
`convert.params_from_flax`; inputs come from numpy with a seed. Dropout is
off wherever the packages are compared (their random streams differ); the
combiner's dropout is tested by its own properties.

Tolerances (float32 on both sides, sums in other orders): outputs to 1e-5
relative (atol 1e-6 on values of order 1; the MoL logits are divided by the
temperature 0.05, so their tolerance is 1e-5 of their largest); a step's
loss to 1e-5 relative and each gradient to 1e-4 of its largest entry; ranks
and top-k ids equal.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from generative_recommenders_tpu.indexing import candidate_index as j_index
from generative_recommenders_tpu.indexing import mol_top_k as j_topk
from generative_recommenders_tpu.models import sequential as j_seq
from generative_recommenders_tpu.models.rails import layers as j_layers
from generative_recommenders_tpu.models.rails import mol as j_mol
from generative_recommenders_tpu_torch.convert import params_from_flax
from generative_recommenders_tpu_torch.indexing import candidate_index as t_index
from generative_recommenders_tpu_torch.indexing import mol_top_k as t_topk
from generative_recommenders_tpu_torch.models import sequential as t_seq
from generative_recommenders_tpu_torch.models.rails import layers as t_layers
from generative_recommenders_tpu_torch.models.rails import mol as t_mol

j_train = importlib.import_module("generative_recommenders_tpu.train.train_loop")
t_train = importlib.import_module("generative_recommenders_tpu_torch.train.train_loop")

OUT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = 1e-4  # of each gradient's largest entry
NUM_ITEMS = 120
D = 32
SMALL = dict(
    main_module="HSTU", num_items=NUM_ITEMS, max_sequence_len=36, gr_output_length=3,
    item_embedding_dim=D, num_blocks=2, num_heads=2, dqk=16, dv=16,
    linear_dropout_rate=0.0, dropout_rate=0.0, interaction_module_type="MoL",
)


def _flax_to_torch(tree):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, tree))


def _close_to_max(got, want, tol):
    """|got - want| within tol of want's largest entry."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{err:.2e} of the largest entry"


def _mol_configs(**kw):
    base = dict(query_embedding_dim=D, item_embedding_dim=D, **kw)
    return j_mol.MoLConfig(**base), t_mol.MoLConfig(**base)


def _mol_pair(**kw):
    """(JAX MoLSimilarity, its params, the port's with the same weights)."""
    jc, tc = _mol_configs(**kw)
    jm = j_mol.MoLSimilarity(jc)
    uid = jnp.zeros((2,), jnp.int32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, D)), jnp.zeros((1, 3, D)), uid)
    tm = t_mol.MoLSimilarity(tc, torch.Generator().manual_seed(0))
    tm.load_state_dict(_flax_to_torch(params), strict=True)
    return jm, params, tm


# ---------------------------------------------------------------- GLU layers
@pytest.mark.parametrize("name", ["SwiGLU", "GeGLU"])
def test_glu_layers_match_jax(name):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 7, 12)).astype(np.float32)
    jl = getattr(j_layers, name)(20)
    params = jl.init(jax.random.PRNGKey(1), jnp.asarray(x))
    tl = getattr(t_layers, name)(12, 20, torch.Generator().manual_seed(0))
    tl.load_state_dict(_flax_to_torch(params), strict=True)
    assert tl.w.shape == (12, 40) and tl.b.shape == (40,)
    np.testing.assert_allclose(
        tl(torch.as_tensor(x)).detach().numpy(), np.asarray(jl.apply(params, jnp.asarray(x))), **OUT_TOL
    )


# ------------------------------------------------------------ MoLSimilarity
COMBOS = [
    ("glu_silu", dict(uid_embedding_hash_sizes=(5, 9), uid_dropout_rate=0.0)),
    ("glu_silu_ln", dict(uid_embedding_hash_sizes=(7,), uid_dropout_rate=0.0, dot_product_l2_norm=False)),
    ("none", dict(gating_item_fn=False, query_dot_product_groups=3, item_dot_product_groups=2,
                  dot_product_dimension=16, gating_qi_hidden_dim=0)),
]


@pytest.mark.parametrize("items_batch", [1, 4], ids=["shared_items", "per_query_items"])
@pytest.mark.parametrize("combo, kw", COMBOS, ids=[c for c, _ in COMBOS])
def test_mol_similarity_matches_jax(combo, kw, items_batch):
    """`__call__` at inference and in training (dropout rates 0, so the
    training aux losses ``mi_loss`` and ``uid_embedding_l2_norm`` compare),
    with the uid tables read at explicit ids (hashed by (uid % size) + 1)
    where the configuration has them."""
    jm, params, tm = _mol_pair(gating_combination_type=combo, **kw)
    rng = np.random.default_rng(1)
    B, X = 4, 9
    q = rng.standard_normal((B, D)).astype(np.float32)
    items = rng.standard_normal((items_batch, X, D)).astype(np.float32)
    uid = rng.integers(0, 1000, size=(B,))
    for deterministic in (True, False):
        want, want_aux = jm.apply(
            params, jnp.asarray(q), jnp.asarray(items), jnp.asarray(uid), deterministic,
            rngs={"dropout": jax.random.PRNGKey(2)},
        )
        got, got_aux = tm(torch.as_tensor(q), torch.as_tensor(items), torch.as_tensor(uid), deterministic,
                          torch.Generator().manual_seed(3))
        assert got.shape == (B, X)
        _close_to_max(got.detach(), want, 1e-5)
        assert set(got_aux) == set(want_aux)
        assert ("mi_loss" in got_aux) == (not deterministic)
        for key, value in want_aux.items():
            np.testing.assert_allclose(got_aux[key].item(), float(value), rtol=1e-5, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("gating_item_fn", [True, False], ids=["item_gate", "no_item_gate"])
def test_decoupled_scoring_matches_joint_and_jax(gating_item_fn):
    """The corpus-side precompute (`mol_item_components`) and the query-side
    scoring (`mol_score_components`) of the sequential model: equal to the
    joint similarity and to the JAX package's decoupled methods. Without an
    item gate the combination is "none" (the glu forms multiply by it)."""
    combo = "glu_silu" if gating_item_fn else "none"
    jc, tc = _mol_configs(gating_item_fn=gating_item_fn, gating_combination_type=combo,
                          uid_embedding_hash_sizes=(6,))
    jm = j_seq.SequentialRecommender(j_seq.ModelConfig(mol_config=jc, **SMALL))
    N = jm.config.total_seq_len
    params = jm.init(
        jax.random.PRNGKey(0), jnp.ones((2,), jnp.int32), jnp.zeros((2, N), jnp.int32),
        {"timestamps": jnp.zeros((2, N), jnp.int32)}, method=j_seq.SequentialRecommender.initialize,
    )
    tm = t_seq.SequentialRecommender(t_seq.ModelConfig(mol_config=tc, **SMALL), torch.Generator().manual_seed(0))
    tm.load_state_dict(_flax_to_torch(params), strict=True)
    rng = np.random.default_rng(5)
    q = rng.standard_normal((3, D)).astype(np.float32)
    corpus = rng.standard_normal((11, D)).astype(np.float32)
    uid = np.array([4, 17, 30])
    j_ic, j_gi = jm.apply(params, jnp.asarray(corpus), method=j_seq.SequentialRecommender.mol_item_components)
    want = jm.apply(params, jnp.asarray(q), j_ic, j_gi, jnp.asarray(uid),
                    method=j_seq.SequentialRecommender.mol_score_components)
    with torch.no_grad():
        ic, gi = tm.mol_item_components(torch.as_tensor(corpus))
        assert (gi is None) == (not gating_item_fn) == (j_gi is None)
        got = tm.mol_score_components(torch.as_tensor(q), ic, gi, torch.as_tensor(uid))
        joint, _ = tm.similarity_fn(torch.as_tensor(q), torch.as_tensor(corpus)[None], torch.as_tensor(uid))
    _close_to_max(ic, j_ic, 1e-5)
    _close_to_max(got, want, 1e-5)
    np.testing.assert_allclose(got.numpy(), joint.numpy(), rtol=1e-6, atol=1e-6)


def test_uid_tables_need_user_ids():
    _, _, tm = _mol_pair(uid_embedding_hash_sizes=(5,))
    with pytest.raises(ValueError, match="needs user_ids"):
        tm(torch.zeros(2, D), torch.zeros(1, 3, D))


def test_l2_clamps_the_squared_sum():
    """``_l2`` is x rsqrt(max(sum x^2, eps^2)), the JAX package's form: an
    all-zero component stays zero with a finite gradient."""
    _, _, tm = _mol_pair()
    x = torch.zeros(2, 3, requires_grad=True)
    y = tm._l2(x)
    y.sum().backward()
    assert torch.equal(y, torch.zeros(2, 3)) and torch.isfinite(x.grad).all()
    np.testing.assert_allclose(x.grad.numpy(), np.full((2, 3), 1e6), rtol=1e-6)


# ------------------------------------------------- MI loss and the combiner
def test_mi_loss_and_combiner_match_jax():
    rng = np.random.default_rng(7)
    gw = rng.standard_normal((4, 9, 16)).astype(np.float32)
    logits = rng.standard_normal((4, 9, 16)).astype(np.float32) * 20
    for training in (False, True):  # training with dropout rate 0: no mask
        want_prs, want = j_mol.softmax_dropout_combiner(jnp.asarray(gw), jnp.asarray(logits), 0.0, None, training)
        prs, got = t_mol.softmax_dropout_combiner(torch.as_tensor(gw), torch.as_tensor(logits), 0.0, None, training)
        np.testing.assert_allclose(prs.numpy(), np.asarray(want_prs), **OUT_TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        t_mol.load_balancing_mi_loss(prs).item(), float(j_mol.load_balancing_mi_loss(want_prs)), rtol=1e-5
    )
    # a gate that puts everything on one logit: per-example entropy 0
    one_hot = torch.nn.functional.one_hot(torch.arange(6) % 3, 4).float()
    np.testing.assert_allclose(
        t_mol.load_balancing_mi_loss(one_hot).item(),
        float(j_mol.load_balancing_mi_loss(jnp.asarray(one_hot.numpy()))), rtol=1e-5,
    )


def test_softmax_dropout_renormalises():
    """With dropout in training: every dropped entry is 0, the kept entries
    keep their softmax ratios and sum to 1, the combined logit is the gate's
    sum of the logits; the same generator seed gives the same masks, and
    off training (or at rate 0) nothing is dropped."""
    rng = np.random.default_rng(8)
    gw = torch.as_tensor(rng.standard_normal((64, 16)).astype(np.float32))
    logits = torch.as_tensor(rng.standard_normal((64, 16)).astype(np.float32))
    soft = torch.softmax(gw, -1)
    prs, combined = t_mol.softmax_dropout_combiner(gw, logits, 0.5, torch.Generator().manual_seed(0), True)
    kept = prs > 0
    assert 0.3 < kept.float().mean() < 0.7
    rows = kept.any(-1)
    torch.testing.assert_close(prs.sum(-1)[rows], torch.ones(int(rows.sum())))
    ratio = torch.where(kept, prs / soft, 0.0)
    scale = ratio.max(-1, keepdim=True).values
    torch.testing.assert_close(torch.where(kept, ratio, scale), scale.expand_as(ratio))
    torch.testing.assert_close(combined, (prs * logits).sum(-1))
    again, _ = t_mol.softmax_dropout_combiner(gw, logits, 0.5, torch.Generator().manual_seed(0), True)
    assert torch.equal(again, prs)
    for rate, training in ((0.5, False), (0.0, True)):
        off, _ = t_mol.softmax_dropout_combiner(gw, logits, rate, torch.Generator().manual_seed(0), training)
        assert torch.equal(off, soft)


# ---------------------------------------------------------------- training
def _batch(seed, B, max_len):
    """One numpy batch as `batch_iterator` stacks it."""
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


class _FixedNegatives:
    """Negatives that depend on the positives only, for both packages."""

    def __init__(self, all_item_ids, sampler, xp):
        self.ids, self.sampler, self.xp = all_item_ids, sampler, xp

    def __call__(self, rng, positive_ids, num_to_sample, item_embedding_fn):
        r = self.xp.arange(num_to_sample)
        offsets = (positive_ids[..., None] * 7 + r * 13 + 1) % self.ids.shape[0]
        sampled = self.ids[offsets]
        return sampled, self.sampler.normalize_embeddings(item_embedding_fn(sampled))


def _trainer_pair(mol_kw=(), attn_kernel="xla", **train_kw):
    """The JAX `ResearchTrainer` and the port's with MoL, the same weights
    and the same injected negatives. The JAX package's "xla" path leaves
    values in rows at or past each length, where its "pallas" path and the
    port give zeros; MoL's ``mi_loss`` averages the gate over every row, so
    a step is compared on the "pallas" path."""
    ids = np.arange(1, NUM_ITEMS + 1)
    jc, tc = _mol_configs(**dict(mol_kw))
    kw = dict(local_batch_size=4, eval_batch_size=4, num_negatives=6,
              loss_weights=(("mi_loss", 0.001),), **train_kw)
    jt = j_train.ResearchTrainer(
        j_train.TrainConfig(model=j_seq.ModelConfig(attn_kernel=attn_kernel, mol_config=jc, **SMALL), **kw), ids
    )
    jt.sampler = _FixedNegatives(jnp.asarray(ids), jt.sampler, jnp)
    params = jt.init_params(jax.random.PRNGKey(0))
    tt = t_train.ResearchTrainer(
        t_train.TrainConfig(model=t_seq.ModelConfig(mol_config=tc, **SMALL), **kw), ids, device="cpu"
    )
    tt.sampler = _FixedNegatives(torch.as_tensor(ids), tt.sampler, torch)
    tt.model.load_state_dict(_flax_to_torch(params), strict=True)
    return jt, params, tt


@pytest.mark.parametrize("with_uid", [False, True], ids=["default_mol", "uid_tables"])
def test_mol_step_loss_and_gradients_match_jax(with_uid):
    """One batch's loss (sampled softmax over MoL logits plus 0.001 mi_loss)
    and every parameter's gradient against `jax.grad` through the JAX
    trainer's loss. The uid case puts ``"user_ids"`` in the batch, the key
    both trainers read (the dataset yields ``"user_id"``)."""
    mol_kw = dict(uid_embedding_hash_sizes=(5,), uid_dropout_rate=0.0) if with_uid else {}
    jt, params, tt = _trainer_pair(mol_kw, attn_kernel="pallas")
    batch = _batch(8, B=4, max_len=36)
    if with_uid:
        batch["user_ids"] = batch["user_id"] * 3
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (want_loss, want_aux), want = jax.value_and_grad(jt._loss, has_aux=True)(params, jb, jax.random.PRNGKey(1))
    loss, aux = tt.loss(t_train.to_device(batch, tt.device))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert set(aux) == set(want_aux) and "mi_loss" in aux
    want = _flax_to_torch(want)
    got = {n: p.grad for n, p in tt.model.named_parameters()}
    assert set(got) == set(want) and all(g is not None for g in got.values())
    assert any(n.startswith("mol.uid_embeddings") for n in got) == with_uid
    for name, w in want.items():
        assert w.abs().max().item() > 0, f"{name}: the reference gradient is all zero"
        _close_to_max(got[name], w, GRAD_TOL)


def test_uid_tables_fail_on_the_datasets_batches():
    """Both trainers read ``"user_ids"`` and the dataset yields
    ``"user_id"``: a MoL model with uid tables fails on its first step, in
    both packages (a finding about the reference, mirrored)."""
    jt, params, tt = _trainer_pair(dict(uid_embedding_hash_sizes=(5,)))
    batch = _batch(8, B=4, max_len=36)
    with pytest.raises(AssertionError, match="needs user_ids"):
        jt._loss(params, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1))
    with pytest.raises(ValueError, match="needs user_ids"):
        tt.loss(t_train.to_device(batch, tt.device))


@pytest.mark.parametrize("loss_module", ["BCELoss", "BCELossWithRatings"])
def test_bce_with_mol_is_refused(loss_module):
    cfg = t_train.TrainConfig(model=t_seq.ModelConfig(**SMALL), loss_module=loss_module)
    with pytest.raises(ValueError, match="MoL is not wired up"):
        t_train.ResearchTrainer(cfg, np.arange(1, NUM_ITEMS + 1), device="cpu")


def test_mol_eval_ranks_match_jax():
    """The MoL eval: the corpus (120 items) padded to a multiple of a chunk
    that does not divide it (50) and scored chunk by chunk; the ranks equal
    the JAX package's, and a chunk as large as the corpus gives the same."""
    jt, params, tt = _trainer_pair(eval_item_chunk_size=50)
    item_embs_j = jt._item_embs(params)
    with torch.no_grad():
        item_embs = tt.item_embeddings()
    for seed in (300, 301):
        batch = _batch(seed, B=4, max_len=36)
        want, want_r = jt._encode_step(params, batch, item_embs_j)
        got, got_r = tt.encode_step(batch, item_embs)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    whole = dataclasses.replace(tt.cfg, eval_item_chunk_size=4096)
    tt.cfg = whole
    again, _ = tt.encode_step(batch, item_embs)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_mol_train_loop_runs_on_the_cpu():
    """`train_loop` with MoL through an epoch and its full eval."""
    from generative_recommenders_tpu_torch.data import dataset as t_data

    seqs = t_data.synthetic_user_sequences(num_users=24, num_items=NUM_ITEMS, max_len=30, seed=0)
    train_ds = t_data.SequenceDataset(seqs, 36, ignore_last_n=1)
    eval_ds = t_data.SequenceDataset(seqs, 36, ignore_last_n=0)
    cfg = t_train.TrainConfig(
        model=t_seq.ModelConfig(**{**SMALL, "linear_dropout_rate": 0.2}),
        local_batch_size=8, eval_batch_size=8, num_epochs=1, num_negatives=6, num_workers=0,
        loss_weights=(("mi_loss", 0.001),), eval_item_chunk_size=50,
    )
    out = t_train.train_loop(cfg, train_ds, eval_ds, device="cpu")
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert 0.0 <= out["history"][0]["hr@10"] <= 1.0


# ------------------------------------------------------------------- top-k
def test_mol_top_k_through_candidate_index_matches_jax():
    """`MoLBruteForceTopK` (chunk 7 over 30 items) as the candidate index's
    ``top_k_module``, with and without seen-id filtering: ids equal, scores
    to 1e-5, against the JAX package's."""
    jc, tc = _mol_configs()
    jm = j_seq.SequentialRecommender(j_seq.ModelConfig(mol_config=jc, **SMALL))
    N = jm.config.total_seq_len
    params = jm.init(
        jax.random.PRNGKey(0), jnp.ones((2,), jnp.int32), jnp.zeros((2, N), jnp.int32),
        {"timestamps": jnp.zeros((2, N), jnp.int32)}, method=j_seq.SequentialRecommender.initialize,
    )
    tm = t_seq.SequentialRecommender(t_seq.ModelConfig(mol_config=tc, **SMALL), torch.Generator().manual_seed(0))
    tm.load_state_dict(_flax_to_torch(params), strict=True)
    rng = np.random.default_rng(11)
    X, B, k = 30, 5, 6
    ids = rng.permutation(np.arange(1, 100))[:X]
    embs = rng.standard_normal((X, D)).astype(np.float32)
    q = rng.standard_normal((B, D)).astype(np.float32)
    invalid = rng.choice(ids, size=(B, 4))
    j_mod = j_topk.MoLBruteForceTopK(jm, params, jnp.asarray(ids), jnp.asarray(embs), item_chunk_size=7)
    t_mod = t_topk.MoLBruteForceTopK(tm, torch.as_tensor(ids), torch.as_tensor(embs), item_chunk_size=7)
    j_idx = j_index.CandidateIndex(jnp.asarray(ids), jnp.asarray(embs))
    t_idx = t_index.CandidateIndex(torch.as_tensor(ids), torch.as_tensor(embs))
    for inv in (None, invalid):
        want_ids, want_s = j_idx.get_top_k_outputs(
            jnp.asarray(q), k, None if inv is None else jnp.asarray(inv), top_k_module=j_mod)
        got_ids, got_s = t_idx.get_top_k_outputs(
            torch.as_tensor(q), k, None if inv is None else torch.as_tensor(inv), top_k_module=t_mod)
        np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
        _close_to_max(got_s, want_s, 1e-5)
    # without a module, the inner product as before
    got_ids, _ = t_idx.get_top_k_outputs(torch.as_tensor(q), k)
    want_ids, _ = j_idx.get_top_k_outputs(jnp.asarray(q), k)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
