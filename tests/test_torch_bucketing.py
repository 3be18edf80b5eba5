"""The PyTorch port's stochastic length, length buckets, in-batch negatives
and candidate index (`utils/bucketing.py`, `models/samplers.py`,
`indexing/candidate_index.py` and their wiring in the research trainer)
against the JAX package, on the CPU at a small size. JAX weights are carried
over by `convert.params_from_flax`; inputs come from numpy with a seed.

Where randomness enters, both packages get the same draws: the stochastic
length's uniforms are replayed from the port's generator into the JAX
function, and the in-batch offsets are injected as a function of the
positives. Tolerances as in `test_torch_research.py`: exact where the
computation is integer, one step's loss 1e-5 relative, a gradient within
2e-4 of its own largest entry, losses over steps 1e-3 relative.
"""

import csv
import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from generative_recommenders_tpu.indexing import candidate_index as j_index
from generative_recommenders_tpu.models import samplers as j_samplers
from generative_recommenders_tpu.models import sequential as j_seq
from generative_recommenders_tpu.utils import bucketing as j_bucketing
from generative_recommenders_tpu_torch.cli import train_research as t_cli
from generative_recommenders_tpu_torch.convert import params_from_flax
from generative_recommenders_tpu_torch.indexing import candidate_index as t_index
from generative_recommenders_tpu_torch.models import samplers as t_samplers
from generative_recommenders_tpu_torch.models import sequential as t_seq
from generative_recommenders_tpu_torch.utils import bucketing as t_bucketing

j_train = importlib.import_module("generative_recommenders_tpu.train.train_loop")
t_train = importlib.import_module("generative_recommenders_tpu_torch.train.train_loop")

GRAD_TOL = 2e-4  # of each gradient's largest entry
NUM_ITEMS = 120
SMALL = dict(
    main_module="HSTU", num_items=NUM_ITEMS, max_sequence_len=20, gr_output_length=3,
    item_embedding_dim=16, num_blocks=2, num_heads=2, dqk=8, dv=8,
    linear_dropout_rate=0.0, dropout_rate=0.0,
)  # N = 20 + 3 + 1 = 24


def _flax_to_torch(tree):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, tree))


def _batch(seed, B, max_len, width=None, num_items=NUM_ITEMS):
    """One numpy batch as `batch_iterator` stacks it: histories of up to
    ``max_len`` events (one row that long) in arrays ``width`` wide."""
    width = width or max_len
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, max_len + 1, size=(B,))
    lengths[0] = max_len
    live = np.arange(width)[None, :] < lengths[:, None]
    ts = 1_400_000_000 + np.cumsum(rng.integers(60, 86400, size=(B, width + 1)), axis=1)
    return {
        "user_id": np.arange(1, B + 1, dtype=np.int64),
        "historical_ids": rng.integers(1, num_items + 1, size=(B, width)) * live,
        "historical_ratings": rng.integers(1, 6, size=(B, width)) * live,
        "historical_timestamps": ts[:, :-1] * live,
        "history_lengths": lengths.astype(np.int64),
        "target_ids": rng.integers(1, num_items + 1, size=(B,)),
        "target_ratings": rng.integers(1, 6, size=(B,)),
        "target_timestamps": ts[np.arange(B), lengths],
    }


def _ragged_ids(seed, B, N, max_len):
    """Left-aligned ids [B, N] with lengths 1..max_len, and the lengths."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, max_len + 1, size=(B,))
    ids = rng.integers(1, 1000, size=(B, N)) * (np.arange(N)[None, :] < lengths[:, None])
    return ids, lengths


# ----------------------------------------------------------- stochastic length
def _replay_uniforms(monkeypatch, u):
    """The JAX package's `apply_stochastic_length` draws ``u`` instead of
    its own uniforms (its module's ``jax`` serves nothing else)."""
    draw = lambda rng, shape: jnp.asarray(u.numpy()).reshape(shape)  # noqa: E731
    monkeypatch.setattr(j_bucketing, "jax", SimpleNamespace(random=SimpleNamespace(uniform=draw)))


@pytest.mark.parametrize("extra", [0, 1])
def test_truncate_to_stochastic_length_matches_jax(extra):
    ids, lengths = _ragged_ids(0, 6, 30, 26)
    new = np.minimum(lengths, np.array([3, 26, 1, 7, 12, 5]))
    want = j_bucketing.truncate_to_stochastic_length(
        jnp.asarray(ids), jnp.asarray(lengths), jnp.asarray(new), extra_positions=extra)
    got = t_bucketing.truncate_to_stochastic_length(
        torch.as_tensor(ids), torch.as_tensor(lengths), torch.as_tensor(new), extra_positions=extra)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    b = 3  # the most recent events, shifted to the front
    np.testing.assert_array_equal(got[b, : new[b]].numpy(), ids[b, lengths[b] - new[b] : lengths[b]])


@pytest.mark.parametrize("alpha", [1.6, 1.9])
def test_apply_stochastic_length_matches_jax_on_the_same_uniforms(alpha, monkeypatch):
    """The port draws its uniforms from a generator; the same uniforms fed
    to the JAX function give the same lengths."""
    lengths = torch.as_tensor(np.random.default_rng(1).integers(1, 201, size=(512,)))
    got = t_bucketing.apply_stochastic_length(lengths, alpha, 200, torch.Generator().manual_seed(3))
    u = torch.rand(lengths.shape, generator=torch.Generator().manual_seed(3))
    _replay_uniforms(monkeypatch, u)
    want = j_bucketing.apply_stochastic_length(jnp.asarray(lengths.numpy()), alpha, 200, jax.random.PRNGKey(0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    threshold = int(200 ** (alpha / 2))
    cut = got != lengths
    assert cut.any() and (got[cut] == threshold).all() and (lengths[cut] > threshold).all()
    assert (got <= lengths).all() and got.dtype == lengths.dtype


def test_length_bucket_choice_matches_jax():
    for x in (0, 1, 2, 3, 63, 64, 65, 200, 1025):
        assert t_bucketing.prev_power_of_2(x) == j_bucketing.prev_power_of_2(x)
        assert t_bucketing.next_power_of_2(x) == j_bucketing.next_power_of_2(x)
        for buckets in ((), (64, 128, 200), (200, 64)):
            for runtime in (False, True):
                assert t_bucketing.autotune_max_seq_len(x, buckets, runtime) == \
                    j_bucketing.autotune_max_seq_len(x, buckets, runtime), (x, buckets, runtime)


@pytest.mark.parametrize("max_len, buckets, runtime", [
    (20, (8, 24, 36), False),  # 24 holds it
    (9, (8, 24, 36), False),
    (40, (8, 24), False),  # no bucket holds it: full width
    (20, (), True),  # the next power of 2
    (3, (), True),
])
def test_bucket_batch_matches_jax(max_len, buckets, runtime):
    batch = _batch(2, B=5, max_len=max_len, width=40)
    want = j_bucketing.bucket_batch(batch, buckets, runtime)
    got = t_bucketing.bucket_batch(batch, buckets, runtime)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert type(got[key]) is np.ndarray
    assert got["historical_ids"].shape[1] >= max_len


# ------------------------------------------------------------ in-batch sampler
def _in_batch_inputs(seed, M=40, D=6):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 12, size=(M,))  # many repeats
    presences = rng.random(M) < 0.7
    ids = ids * presences
    emb = rng.standard_normal((M, D)).astype(np.float32)
    emb[ids == 0] = 0.0
    return ids, presences, emb


@pytest.mark.parametrize("dedup", [True, False])
def test_process_batch_matches_jax(dedup):
    """Ids, count and compacted embeddings exactly as the JAX package's
    (the l2 norm's sum may round one unit differently); the gradient flows
    back to the input embeddings of kept entries only."""
    ids, presences, emb = _in_batch_inputs(3)
    j_ids, j_pres = jnp.asarray(ids), jnp.asarray(presences)
    x = torch.as_tensor(emb).requires_grad_(True)
    for l2 in (False, True):
        js = j_samplers.InBatchNegativesSampler(l2, 1e-6, dedup).process_batch(j_ids, j_pres, jnp.asarray(emb))
        ts = t_samplers.InBatchNegativesSampler(l2, 1e-6, dedup).process_batch(
            torch.as_tensor(ids), torch.as_tensor(presences), x)
        np.testing.assert_array_equal(ts.ids.numpy(), np.asarray(js.ids))
        assert ts.count.dim() == 0 and int(ts.count) == int(js.count)
        if l2:
            np.testing.assert_allclose(ts.embeddings.detach().numpy(), np.asarray(js.embeddings),
                                       rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(ts.embeddings.detach().numpy(), np.asarray(js.embeddings))
    assert int(ts.count) == (len(set(ids[presences].tolist())) if dedup else presences.sum())
    w = np.random.default_rng(4).standard_normal(emb.shape).astype(np.float32)
    (ts.embeddings * torch.as_tensor(w)).sum().backward()
    j_grad = jax.grad(lambda e: jnp.sum(j_samplers.InBatchNegativesSampler(True, 1e-6, dedup).process_batch(
        j_ids, j_pres, e).embeddings * w))(jnp.asarray(emb))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(j_grad), rtol=1e-6, atol=1e-7)
    assert (x.grad[~torch.as_tensor(presences)] == 0).all()


def test_in_batch_sampler_draws_from_the_state():
    """Offsets are uniform over the first ``count`` entries, drawn from the
    generator without reading the count on the host."""
    ids, presences, emb = _in_batch_inputs(5)
    sampler = t_samplers.InBatchNegativesSampler(False, 1e-6, True)
    state = sampler.process_batch(torch.as_tensor(ids), torch.as_tensor(presences), torch.as_tensor(emb))
    pos = torch.zeros(50, 40, dtype=torch.long)
    draw = lambda seed: sampler(torch.Generator().manual_seed(seed), state, pos, 8)  # noqa: E731
    neg_ids, neg_emb = draw(0)
    assert neg_ids.shape == (50, 40, 8) and neg_emb.shape == (50, 40, 8, 6)
    assert set(neg_ids.unique().tolist()) == set(ids[presences].tolist())  # every unique id, no padding
    counts = torch.bincount(torch.searchsorted(state.ids[: int(state.count)], neg_ids.flatten()))
    assert counts.min() > 0.8 * counts.float().mean()
    assert torch.equal(draw(0)[0], neg_ids) and not torch.equal(draw(1)[0], neg_ids)
    empty = sampler.process_batch(torch.zeros(4, dtype=torch.long), torch.zeros(4, dtype=torch.bool),
                                  torch.zeros(4, 6))
    assert int(empty.count) == 0 and (sampler(torch.Generator(), empty, pos, 2)[0] == 0).all()


class _FixedNegatives:
    """Local negatives that depend on the positives only, for both packages."""

    def __init__(self, all_item_ids, sampler, xp):
        self.ids, self.sampler, self.xp = all_item_ids, sampler, xp

    def __call__(self, rng, positive_ids, num_to_sample, item_embedding_fn):
        r = self.xp.arange(num_to_sample)
        offsets = (positive_ids[..., None] * 7 + r * 13 + 1) % self.ids.shape[0]
        sampled = self.ids[offsets]
        return sampled, self.sampler.normalize_embeddings(item_embedding_fn(sampled))


class _FixedInBatchOffsets:
    """The package's own in-batch sampler with offsets injected as a
    function of the positives and the state's count."""

    def __init__(self, sampler, xp):
        self.sampler, self.xp = sampler, xp

    def process_batch(self, **kw):
        return self.sampler.process_batch(**kw)

    def __call__(self, rng, state, positive_ids, num_to_sample):
        r = self.xp.arange(num_to_sample)
        c = state.count.clip(1)
        offsets = (positive_ids[..., None] * 7 + r * 13 + 1) % c
        return state.ids[offsets], state.embeddings[offsets]


def _trainer_pair(loss_module="SampledSoftmaxLoss", **train_kw):
    """The JAX `ResearchTrainer` (XLA path) and the port's on the CPU, with
    the same weights and injected negatives. The port's rows at or past
    each length differ from the XLA path's, which masks causally only; the
    loss reads none of them."""
    ids = np.arange(1, NUM_ITEMS + 1)
    kw = dict(local_batch_size=4, eval_batch_size=4, num_negatives=6, loss_module=loss_module,
              learning_rate=1e-3, weight_decay=0.01, **train_kw)
    jt = j_train.ResearchTrainer(j_train.TrainConfig(model=j_seq.ModelConfig(**SMALL), **kw), ids)
    params = jt.init_params(jax.random.PRNGKey(0))
    tt = t_train.ResearchTrainer(t_train.TrainConfig(model=t_seq.ModelConfig(**SMALL), **kw), ids,
                                 device="cpu")
    tt.model.load_state_dict(_flax_to_torch(params))
    if train_kw.get("sampling_strategy") == "in-batch":
        jt.sampler, tt.sampler = _FixedInBatchOffsets(jt.sampler, jnp), _FixedInBatchOffsets(tt.sampler, torch)
    else:
        jt.sampler = _FixedNegatives(jnp.asarray(ids), jt.sampler, jnp)
        tt.sampler = _FixedNegatives(torch.as_tensor(ids), tt.sampler, torch)
    return jt, params, tt


def _assert_loss_and_grads(jt, params, tt, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (want_loss, _), want = jax.jit(jax.value_and_grad(jt._loss, has_aux=True))(
        params, jb, jax.random.PRNGKey(1))
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


@pytest.mark.parametrize("loss_module", ["SampledSoftmaxLoss", "BCELoss"])
def test_in_batch_loss_and_gradients_match_jax(loss_module):
    """The in-batch branch (deduplicated ids of the batch, one negative
    under `BCELoss`) with injected offsets: the loss and every gradient, the
    negatives' path into the item table included."""
    jt, params, tt = _trainer_pair(loss_module, sampling_strategy="in-batch")
    assert isinstance(tt.sampler.sampler, t_samplers.InBatchNegativesSampler)
    _assert_loss_and_grads(jt, params, tt, _batch(8, B=4, max_len=20))


def test_stochastic_length_loss_and_gradients_match_jax(monkeypatch):
    """Stochastic length inside the loss, before the target scatter, on the
    uniforms the port's length generator draws (replayed into the JAX
    trainer): the same cut histories, loss and gradients."""
    jt, params, tt = _trainer_pair(stochastic_length_alpha=1.6)  # threshold int(20^0.8) = 10
    batch = _batch(9, B=4, max_len=20)
    u = torch.rand(4, generator=torch.Generator().set_state(tt.length_gen.get_state()))
    _replay_uniforms(monkeypatch, u)
    cut = t_bucketing.apply_stochastic_length(
        torch.as_tensor(batch["history_lengths"]), 1.6, 20,
        torch.Generator().set_state(tt.length_gen.get_state()))
    assert (cut.numpy() < batch["history_lengths"]).any()  # the draw cuts a history
    _assert_loss_and_grads(jt, params, tt, batch)


@pytest.mark.parametrize("buckets, runtime", [((8, 12, 16), False), ((), True)])
def test_bucketed_train_steps_match_jax(buckets, runtime):
    """`train_step` slices each host batch to its bucket, as the JAX
    trainer does: the attention then runs at N below the position tables'
    Nm. Six steps over batches of three bucket widths: the losses within
    1e-3 relative."""
    jt, params, tt = _trainer_pair(seq_len_buckets=buckets, runtime_bucketing=runtime)
    opt_state = jt.init_opt_state(params)
    rows = [_batch(30 + i, B=4, max_len=n, width=20) for i, n in enumerate((5, 11, 20, 7, 14, 3))]
    j_l, t_l = [], []
    for step, batch in enumerate(rows):
        params, opt_state, loss = jt.train_step(params, opt_state, batch, jax.random.PRNGKey(step))
        j_l.append(float(loss))
        t_l.append(float(tt.train_step(batch)))
    np.testing.assert_allclose(t_l, j_l, rtol=1e-3)
    widths = {t_bucketing.bucket_batch(b, buckets, runtime)["historical_ids"].shape[1] for b in rows}
    assert len(widths) >= 3 and max(widths) <= 20


def test_research_cli_takes_the_length_flags(tmp_path):
    """`--stochastic_length_alpha` and `--seq_len_buckets` reach a preset's
    config: one epoch (one step) of the ml-1m preset over a csv of 128
    histories short enough for the 16 bucket."""
    rng = np.random.default_rng(0)
    path = tmp_path / "sasrec_format.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["user_id", "sequence_item_ids", "sequence_ratings", "sequence_timestamps"])
        for u in range(128):
            n = int(rng.integers(5, 15))
            items = rng.choice(np.arange(1, 3707), size=n, replace=False)
            ts = np.cumsum(rng.integers(1, 1000, size=n)) + 10**9
            w.writerow([u, ",".join(map(str, items)), ",".join(["4"] * n), ",".join(map(str, ts))])
    out = t_cli.main(["--preset", "ml-1m/hstu-sampled-softmax-n128", "--data_csv", str(path),
                      "--device", "cpu", "--num_epochs", "1",
                      "--stochastic_length_alpha", "1.6", "--seq_len_buckets", "8,16"])
    cfg = out["trainer"].cfg
    assert cfg.stochastic_length_alpha == 1.6 and cfg.seq_len_buckets == (8, 16)
    assert cfg.model.item_embedding_dim == 50 and cfg.num_epochs == 1
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0]) and len(out["history"]) == 1


# ----------------------------------------------------------- candidate index
@pytest.mark.parametrize("k, n_invalid", [(5, 3), (10, 0), (8, 40)])
def test_candidate_index_matches_jax(k, n_invalid):
    """Top-k over the corpus with each row's invalid ids dropped (the first
    k valid in score order); with k + N0 beyond the corpus, k' = X."""
    rng = np.random.default_rng(k + n_invalid)
    X, D, B = 45, 8, 5
    ids = (np.arange(1, X + 1) * 3).astype(np.int32)
    embs = rng.standard_normal((X, D)).astype(np.float32)
    q = rng.standard_normal((B, D)).astype(np.float32)
    invalid = None
    if n_invalid:
        invalid = rng.choice(ids, size=(B, n_invalid)).astype(np.int32)
        invalid[:, -1] = 0  # padding
    j_idx = j_index.CandidateIndex(ids=jnp.asarray(ids), embeddings=jnp.asarray(embs))
    t_idx = t_index.CandidateIndex(ids=torch.as_tensor(ids), embeddings=torch.as_tensor(embs))
    want_ids, want_s = j_idx.get_top_k_outputs(jnp.asarray(q), k, None if invalid is None else jnp.asarray(invalid))
    got_ids, got_s = t_idx.get_top_k_outputs(torch.as_tensor(q), k, None if invalid is None else torch.as_tensor(invalid))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6, atol=1e-6)
    assert got_ids.shape == (B, k)
    if invalid is not None:
        for b in range(B):
            valid = [i for i in ids[np.argsort(-(embs @ q[b]))] if i not in set(invalid[b].tolist())]
            assert got_ids[b].tolist() == valid[:k]


def test_mips_brute_force_top_k_matches_jax():
    rng = np.random.default_rng(11)
    q, items = rng.standard_normal((3, 8)).astype(np.float32), rng.standard_normal((30, 8)).astype(np.float32)
    ids = np.arange(100, 130)
    want_s, want_ids = j_index.mips_brute_force_top_k(jnp.asarray(q), jnp.asarray(items), jnp.asarray(ids), 7)
    got_s, got_ids = t_index.mips_brute_force_top_k(torch.as_tensor(q), torch.as_tensor(items), torch.as_tensor(ids), 7)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6, atol=1e-6)
    assert (got_s[:, :-1] >= got_s[:, 1:]).all()


def test_stochastic_length_with_ratings_loss_is_refused():
    cfg = t_train.TrainConfig(model=t_seq.ModelConfig(**SMALL), stochastic_length_alpha=1.6,
                              loss_module="BCELossWithRatings")
    with pytest.raises(ValueError, match="stochastic length"):
        t_train.ResearchTrainer(cfg, np.arange(1, 10), device="cpu")
