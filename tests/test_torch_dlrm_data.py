"""The PyTorch port's public datasets of the DLRM-v3 ranker against the JAX
package, on files the tests write in the published formats: the helpers,
the MovieLens and KuaiRand batches (training and inference candidate
counts), `preprocess_kuairand`, the dataset factory, and the
``movielens-1m`` and ``kuairand-1k`` models at small widths (loss and every
gradient against the JAX `DlrmTrainer` on a batch of the real format, then
three train steps). JAX weights are carried over by
`convert.params_from_flax`; the dropout rates are 0 where the packages are
compared. Tolerances as `tests/test_torch_training.py`."""

import csv
import dataclasses
import os
import zipfile

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from generative_recommenders_tpu.cli import preprocess_dlrm_data as j_kuai
from generative_recommenders_tpu.configs import dlrm as j_configs
from generative_recommenders_tpu.data import dlrm_factory as j_factory
from generative_recommenders_tpu.data import dlrm_public_datasets as j_pub
from generative_recommenders_tpu.parallel.mesh import make_mesh
from generative_recommenders_tpu.train import dlrm_train as j_train
from generative_recommenders_tpu_torch.cli import preprocess_dlrm_data as t_kuai
from generative_recommenders_tpu_torch.configs import dlrm as t_configs
from generative_recommenders_tpu_torch.convert import params_from_flax
from generative_recommenders_tpu_torch.data import dlrm_factory as t_factory
from generative_recommenders_tpu_torch.data import dlrm_public_datasets as t_pub
from generative_recommenders_tpu_torch.data.preprocessor import get_common_preprocessors
from generative_recommenders_tpu_torch.train import dlrm_train as t_train
from test_torch_data import ml1m_files

SMALL = dict(
    hstu_attn_num_layers=2, hstu_embedding_table_dim=16, hstu_transducer_embedding_dim=32,
    hstu_attn_linear_dim=16, hstu_attn_qk_dim=16, hstu_num_heads=2,
    num_position_buckets=128, num_time_buckets=64,
    hstu_input_dropout_ratio=0.0, hstu_linear_dropout_rate=0.0,
)
UIH, CANDS, BATCH = 24, 4, 4
# ids the datasets do not hash (MovieLens movies, users) index the tables directly
HASH = {"movielens-1m": 4000, "kuairand-1k": 64}

LOG_COLS = [
    "user_id", "video_id", "date", "hourmin", "time_ms", "is_click", "is_like", "is_follow",
    "is_comment", "is_forward", "is_hate", "long_view", "play_time_ms", "duration_ms",
    "profile_stay_time", "comment_stay_time", "is_profile_enter", "is_rand", "tab",
]
RANGES = {
    "user_active_degree": ["high_active", "full_active", "middle_active", "UNKNOWN"],
    "follow_user_num_range": ["0", "(0,10]", "(10,50]", "(50,100]", "500+"],
    "fans_user_num_range": ["0", "[1,10)", "[10,100)", "[100,1k)"],
    "friend_user_num_range": ["0", "[1,5)", "[5,30)", "[30,60)"],
    "register_days_range": ["15-30", "31-60", "61-90", "91-180", "181-365", "366-730", "730+"],
}


def write_kuairand(data_path, num_users=40, events=(3, 14), seed=0):
    """`KuaiRand-1K/data/` as published: the two `log_standard_*_1k.csv` files
    (their 19 columns, a user's events in time order) and
    `user_features_1k.csv` (31 columns: ids, the five range features as
    text, counts, 18 one-hot features, one of them with an empty cell).
    Some users log events in one file only."""
    rng = np.random.default_rng(seed)
    root = os.path.join(data_path, "KuaiRand-1K", "data")
    os.makedirs(root, exist_ok=True)
    t = 1_649_347_200_000
    for f, name in enumerate(("log_standard_4_08_to_4_21_1k.csv", "log_standard_4_22_to_5_08_1k.csv")):
        rows = []
        for u in rng.permutation(num_users):
            if (u + f) % 9 == 0:
                continue  # absent from this file
            for _ in range(int(rng.integers(*events))):
                t += int(rng.integers(1, 60_000))
                flags = (rng.random(8) < [0.4, 0.05, 0.01, 0.01, 0.01, 0.01, 0.3, 0.02]).astype(int)
                rows.append([u, int(rng.integers(0, 5000)), 20220408 + f * 14, 1200, t, *flags[:7],
                             int(rng.integers(0, 60_000)), int(rng.integers(1000, 90_000)), 0, 0, flags[7],
                             0, int(rng.integers(0, 4))])
        rows.sort(key=lambda r: r[4])  # the logs are in time order
        with open(os.path.join(root, name), "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(LOG_COLS)
            w.writerows(rows)
    header = ["user_id", "user_active_degree", "is_lowactive_period", "is_live_streamer",
              "is_video_author", "follow_user_num", "follow_user_num_range", "fans_user_num",
              "fans_user_num_range", "friend_user_num", "friend_user_num_range", "register_days",
              "register_days_range"] + [f"onehot_feat{i}" for i in range(18)]
    with open(os.path.join(root, "user_features_1k.csv"), "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(header)
        for u in range(num_users):
            r = {c: v[int(rng.integers(len(v)))] for c, v in RANGES.items()}
            onehot = [int(rng.integers(0, 9)) for _ in range(18)]
            w.writerow([u, r["user_active_degree"], 0, 0, u % 2, u * 3, r["follow_user_num_range"], u * 7,
                        r["fans_user_num_range"], u, r["friend_user_num_range"], 100 + u,
                        r["register_days_range"]] + ["" if u == 5 and i == 4 else x for i, x in enumerate(onehot)])
    return root


def test_helpers_match_jax():
    for x in ("1,2,3,4,5", "[7, 8, 9]", "5", [3, 4], 6, np.int64(2)):
        for m in (1, 2, 10):
            assert t_pub.separate_uih_candidates(x, m) == j_pub.separate_uih_candidates(x, m)
    for y, n in (([1, 2, 3], 2), ([1], 5), ([], 3)):
        assert t_pub.maybe_truncate_seq(y, n) == j_pub.maybe_truncate_seq(y, n)
    for x in ("[12, 130, 7]", "129", 200, [5, 70]):
        assert t_pub.process_and_hash_x(x, 64) == j_pub.process_and_hash_x(x, 64)
    for d in ("kuairand-1k", "kuairand-27k", "movielens-1m", "debug"):
        assert t_kuai.get_feature_merge_weights(d) == j_kuai.get_feature_merge_weights(d)
    assert t_kuai.SEQ_COLS == j_kuai.SEQ_COLS and t_kuai.USER_RANGE_COLS == j_kuai.USER_RANGE_COLS
    assert t_factory.DEFAULT_DATA_FILES == j_factory.DEFAULT_DATA_FILES


def test_preprocess_kuairand_writes_what_the_jax_package_writes(tmp_path):
    outs = {}
    for tag, mod in (("jax", j_kuai), ("port", t_kuai)):
        write_kuairand(str(tmp_path / tag))
        outs[tag] = mod.preprocess_kuairand("kuairand-1k", str(tmp_path / tag))
    with open(outs["jax"], "rb") as a, open(outs["port"], "rb") as b:
        want, got = a.read(), b.read()
    assert got == want
    with open(outs["port"], newline="") as f:
        rows = list(csv.DictReader(f))
    n_both = sum(1 for u in range(40) if u % 9 and (u + 1) % 9)
    assert len(rows) == n_both  # the inner join drops users absent from a file
    assert set(int(r["user_active_degree"]) for r in rows) <= {1, 2, 3, 4}
    # the CLI, nothing downloaded
    assert t_kuai.main(["--dataset", "kuairand-1k", "--data_path", str(tmp_path / "port"),
                        "--skip_download"]) == outs["port"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A `sasrec_format.csv` of ml-1m from the port's preprocessor and a
    `processed_seqs.csv` of KuaiRand-1K from the port's `preprocess_kuairand`."""
    root = str(tmp_path_factory.mktemp("data"))
    dp = get_common_preprocessors(root)["ml-1m"]
    with zipfile.ZipFile(dp.saved_name, "w") as z:
        for name, data in ml1m_files().items():
            z.writestr(name, data)
    dp.preprocess_rating()
    write_kuairand(root)
    return {"movielens-1m": dp.output_format_csv(),
            "kuairand-1k": t_kuai.preprocess_kuairand("kuairand-1k", root)}


def _cfgs(dataset, **over):
    over = {**SMALL, **over}
    return (
        dataclasses.replace(j_configs.get_hstu_configs(dataset, max_uih_len=UIH, max_num_candidates=CANDS), **over),
        dataclasses.replace(t_configs.get_hstu_configs(dataset, max_uih_len=UIH, max_num_candidates=CANDS), **over),
    )


def _equal_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, dict):
                assert a.keys() == b.keys()
                for k in b:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                np.testing.assert_array_equal(a, b)
    return got


@pytest.mark.parametrize("dataset", ["movielens-1m", "kuairand-1k"])
@pytest.mark.parametrize("is_inference", [False, True])
def test_public_batches_match_jax(files, dataset, is_inference):
    jcfg, tcfg = _cfgs(dataset)
    kw = dict(data_file=files[dataset], hash_size=HASH[dataset], batch_size=7, is_inference=is_inference)
    for shuffle in (False, True):
        got = _equal_batches(
            t_factory.make_dlrm_batches(dataset, tcfg, shuffle=shuffle, seed=3, **kw),
            j_factory.make_dlrm_batches(dataset, jcfg, shuffle=shuffle, seed=3, **kw),
        )
    M = tcfg.max_num_candidates_inference if is_inference else CANDS
    uih, ul, cands, nc = got[0]
    assert all(v.shape == (7, M) for v in cands.values()) and (nc == M).all()
    assert uih[tcfg.uih_post_id_feature_name].shape == (7, UIH) and (ul <= UIH).all()
    ctx = [n for n, _ in tcfg.contextual_feature_to_max_length]
    assert all(uih[n].shape == (7, 1) for n in ctx) and uih["user_id"].any()
    if dataset == "kuairand-1k":
        assert (uih["video_id"] < HASH[dataset]).all()
        assert uih["user_active_degree"].min() >= 1
    # every user of ml-1m; the 31 KuaiRand users present in both log files
    assert sum(b[1].shape[0] for b in got) == {"movielens-1m": 150, "kuairand-1k": 31}[dataset]


def test_factory_branches_and_missing_file(tmp_path, files):
    _, tcfg = _cfgs("debug")
    debug = list(t_factory.make_dlrm_batches("debug", tcfg, hash_size=50, batch_size=3, num_batches=2))
    assert len(debug) == 2 and debug[0][1].shape == (3,)
    _, mcfg = _cfgs("movielens-20m")
    assert next(t_factory.make_dlrm_batches("movielens-20m", mcfg, data_file=files["movielens-1m"],
                                             batch_size=5, num_batches=1))[1].shape == (5,)
    missing = str(tmp_path / "nowhere.csv")
    for dataset in ("movielens-1m", "kuairand-1k"):
        with pytest.raises(FileNotFoundError, match="run the preprocess CLI first"):
            t_factory.make_dlrm_batches(dataset, tcfg, data_file=missing)
    with pytest.raises(FileNotFoundError, match="data/ml-1m/sasrec_format.csv"):
        t_factory.make_dlrm_batches("movielens-1m", tcfg)


def _as_int32(batch):
    """The batch as the JAX package reads it: with 64-bit types off, every
    int64 array becomes int32, which wraps KuaiRand's millisecond
    timestamps (about 1.6e12). The port keeps int64; both are fed these
    int32 arrays so that they see the same timestamps."""
    uih, ul, cands, nc = batch
    cast = lambda d: {k: v.astype(np.int32) for k, v in d.items()}  # noqa: E731
    return cast(uih), ul, cast(cands), nc


@pytest.fixture(scope="module", params=["movielens-1m", "kuairand-1k"])
def trainers(request, files):
    dataset = request.param
    jcfg, tcfg = _cfgs(dataset)
    jt = j_train.DlrmTrainer(
        jcfg, j_configs.get_embedding_table_config(dataset, hash_size=HASH[dataset], dim=16),
        j_train.DlrmTrainConfig(batch_size=BATCH, num_batches=3),
        mesh=make_mesh(shape=(1, 1), devices=jax.devices("cpu")[:1]),
    )
    tt = t_train.DlrmTrainer(
        tcfg, t_configs.get_embedding_table_config(dataset, hash_size=HASH[dataset], dim=16),
        t_train.DlrmTrainConfig(), device="cpu",
    )
    batches = [_as_int32(b) for b in t_factory.make_dlrm_batches(
        dataset, tcfg, data_file=files[dataset], hash_size=HASH[dataset], batch_size=BATCH, num_batches=3)]
    params, _ = jt.init_sharded(jax.random.PRNGKey(0), j_train._to_device(batches[0]))
    init = jax.tree_util.tree_map(np.array, params)
    tt.model.load_state_dict(params_from_flax(init))
    return dataset, jt, tt, batches, init


def test_public_dataset_loss_and_gradients_match_jax(trainers):
    """The real datasets' models (MovieLens: five contextual features, one
    regression task; KuaiRand: six contextual features, eight tasks) on a
    batch of the real format."""
    dataset, jt, tt, batches, init = trainers
    assert len(tt.hstu_cfg.multitask_configs) == (1 if dataset == "movielens-1m" else 8)
    assert len(tt.model.embedding_tables) == (6 if dataset == "movielens-1m" else 7)
    (loss, _), grads = jax.jit(jax.value_and_grad(jt._loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, init), j_train._to_device(batches[0]), jax.random.PRNGKey(1)
    )
    tt.model.zero_grad(set_to_none=True)
    got, *_ = tt.loss(t_train.to_device(batches[0], tt.device))
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    named = dict(tt.model.named_parameters())
    assert named.keys() == want.keys()
    for name, p in named.items():
        w = want[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * max(float(np.abs(w).max()), 1e-30),
                                   err_msg=name)


def test_public_dataset_train_steps_match_jax(trainers):
    """Three optimizer steps from the same weights on the same batches: each
    step's loss within rtol 1e-4 (the second and third losses read the
    updated parameters), and every parameter moved by both packages. The
    parameters themselves are held to the JAX package's in
    `tests/test_torch_training.py` on the debug preset; here Adam turns the
    round-off of near-zero gradients into full steps of either sign in a few
    entries of the 8 task heads' inputs."""
    dataset, jt, _, batches, init = trainers
    _, tcfg = _cfgs(dataset)
    tt = t_train.DlrmTrainer(
        tcfg, t_configs.get_embedding_table_config(dataset, hash_size=HASH[dataset], dim=16),
        t_train.DlrmTrainConfig(), device="cpu",
    )
    tt.model.load_state_dict(params_from_flax(init))
    params, opt_state = jt.init_sharded(jax.random.PRNGKey(0), j_train._to_device(batches[0]))
    for step, raw in enumerate(batches):
        params, opt_state, loss, *_ = jt.train_step(params, opt_state, j_train._to_device(raw),
                                                    jax.random.PRNGKey(step))
        got = tt.train_step(t_train.to_device(raw, tt.device))[0]
        np.testing.assert_allclose(got.item(), float(loss), rtol=1e-4, err_msg=f"step {step}")
    start = params_from_flax(init)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    for name, p in tt.model.named_parameters():
        moved = (p.detach() - start[name]).abs().max().item()
        assert moved > 0 and float((want[name] - start[name]).abs().max()) > 0, f"{name} was not trained"
