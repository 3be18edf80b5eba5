"""The PyTorch port's real-data paths of the research stack against the JAX
package, on files the tests write in the published formats: the public-data
preprocessors (ml-1m, ml-20m, ml-1b, amzn-books), `preprocess_public_data`,
the dataset registry `get_reco_dataset` with its item features, the sharded
multi-file corpus (native reader and Python path) and the fractal expansion.

The port reads and writes with numpy and the `csv` module, the JAX package
with pandas: every output must be equal, row for row and byte for byte.
"""

import csv
import io
import os
import tarfile
import zipfile

import numpy as np
import pytest

from generative_recommenders_tpu.cli import run_fractal_expansion as j_frac
from generative_recommenders_tpu.data import dataset as j_data
from generative_recommenders_tpu.data import preprocessor as j_pre
from generative_recommenders_tpu.data import reco_dataset as j_reco
from generative_recommenders_tpu_torch.cli import preprocess_public_data as t_cli
from generative_recommenders_tpu_torch.cli import run_fractal_expansion as t_frac
from generative_recommenders_tpu_torch.data import dataset as t_data
from generative_recommenders_tpu_torch.data import native_reader as t_native
from generative_recommenders_tpu_torch.data import preprocessor as t_pre
from generative_recommenders_tpu_torch.data import reco_dataset as t_reco

ML1M_ITEMS = 3706  # the registry asserts this many distinct movies


def _zip(path, files):
    with zipfile.ZipFile(path, "w") as z:
        for name, data in files.items():
            z.writestr(name, data)


def ml1m_files(num_users=150, seed=0):
    """`ml-1m/{ratings,users,movies}.dat` as GroupLens publishes them:
    `::`-separated, iso-8859-1 titles "Title (YYYY)" with `|`-joined genres,
    exactly 3,706 distinct movie ids within 1..3952 and timestamps tied
    within a user."""
    rng = np.random.default_rng(seed)
    movie_ids = np.sort(rng.choice(np.arange(1, 3953), ML1M_ITEMS, replace=False))
    per_user = rng.integers(20, 40, num_users)
    items = rng.choice(movie_ids, per_user.sum())
    items[:ML1M_ITEMS] = movie_ids  # every movie rated at least once
    ratings, start = [], 0
    for u, n in enumerate(per_user, start=1):
        ts = 978_300_000 + np.sort(rng.integers(0, 5000, n)) // 7 * 7  # ties
        for m, r, t in zip(items[start:start + n], rng.integers(1, 6, n), ts):
            ratings.append(f"{u}::{m}::{r}::{t}\n")
        start += n
    rng.shuffle(ratings)
    zips = ["48067", "70072", "55117", "02460", "N3J3B8", "98107-2117"]
    users = "".join(
        f"{u}::{'FM'[u % 2]}::{[1, 18, 25, 35, 45, 50, 56][u % 7]}::{u % 21}::{zips[u % 6]}\n"
        for u in range(1, num_users + 1)
    )
    genres = ["Action", "Comedy", "Drama", "Children's", "Sci-Fi", "Film-Noir"]
    titles = ["Toy Story", "City of Lost Children, The", "Misérables, Les", "Heat", "Seven (Se7en)"]
    movies = "".join(
        f"{m}::{titles[m % 5]} {m} ({1919 + m % 81})::{'|'.join(genres[: 1 + m % 4])}\n"
        for m in movie_ids
    )
    return {
        "ml-1m/ratings.dat": "".join(ratings).encode(),
        "ml-1m/users.dat": users.encode(),
        "ml-1m/movies.dat": movies.encode("iso-8859-1"),
    }


def ml20m_files(num_users=60, num_items=300, seed=1):
    rng = np.random.default_rng(seed)
    lines = ["userId,movieId,rating,timestamp"]
    for u in range(1, num_users + 1):
        n = int(rng.integers(5, 30))
        for m, r, t in zip(rng.choice(num_items, n, replace=False) + 1, rng.integers(1, 11, n) / 2,
                           rng.integers(0, 300, n) * 3 + 1_100_000_000):
            lines.append(f"{u},{m},{r},{t}")
    movies = ["movieId,title,genres"] + [
        f'{m},"American President, The {m} (1995)",Comedy|Drama|Romance' if m % 3 == 0
        else f"{m},Heat {m} (1995),Action|Crime|Thriller" for m in range(1, num_items + 1)
    ]
    return {"ml-20m/ratings.csv": ("\n".join(lines) + "\n").encode(),
            "ml-20m/movies.csv": ("\n".join(movies) + "\n").encode()}


def _processor(pkg, name, root, **over):
    dp = pkg.get_common_preprocessors(root)[name]
    for k, v in over.items():
        setattr(dp, k, v)
    return dp


def _both(tmp_path, name, files_fn, archive, **over):
    """Runs the JAX and the port processor on the same archive, each under
    its own data root; returns both roots and both return values."""
    out = []
    for tag, pkg in (("jax", j_pre), ("port", t_pre)):
        root = str(tmp_path / tag)
        os.makedirs(root)
        dp = _processor(pkg, name, root, **over)
        files_fn(dp.saved_name) if archive else None
        out.append((root, dp.preprocess_rating()))
    return out


def _same_files(a, b, rel):
    with open(os.path.join(a, rel), "rb") as fa, open(os.path.join(b, rel), "rb") as fb:
        got, want = fb.read(), fa.read()
    assert got == want, rel


@pytest.mark.parametrize("name", ["ml-1m", "ml-20m"])
def test_movielens_processors_write_what_the_jax_package_writes(tmp_path, name):
    files = ml1m_files() if name == "ml-1m" else ml20m_files()
    over = {} if name == "ml-1m" else {"expected_num_unique_items": None}
    (jr, jn), (tr, tn) = _both(tmp_path, name, lambda p: _zip(p, files), True, **over)
    assert tn == jn == (ML1M_ITEMS if name == "ml-1m" else jn)
    _same_files(jr, tr, f"{name}/sasrec_format.csv")
    _same_files(jr, tr, f"processed/{name}/movies.csv")
    with open(os.path.join(tr, name, "sasrec_format.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["index"]) for r in rows] != sorted(int(r["index"]) for r in rows)  # shuffled
    if name == "ml-1m":
        assert set(rows[0]) >= {"sex", "age_group", "occupation", "zip_code"}
        # tied timestamps keep the sort's order; the sequence is chronological
        ts = [list(map(int, r["sequence_timestamps"].split(","))) for r in rows]
        assert all(t == sorted(t) for t in ts) and any(len(set(t)) < len(t) for t in ts)


def test_ml1b_processor_reads_the_npz_shards(tmp_path):
    rng = np.random.default_rng(2)

    def write_tar(path):
        with tarfile.open(path, "w") as tar:
            for i in range(16):
                buf = io.BytesIO()
                n = int(rng.integers(20, 40))
                np.savez(buf, np.stack([rng.integers(0, 30, n), rng.integers(0, 500, n)], 1))
                data = buf.getvalue()
                info = tarfile.TarInfo(f"ml-20mx16x32/trainx16x32_{i}.npz")
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))

    roots = []
    for tag, pkg in (("jax", j_pre), ("port", t_pre)):
        root = str(tmp_path / tag)
        os.makedirs(root)
        dp = _processor(pkg, "ml-1b", root)
        rng = np.random.default_rng(2)  # the same shards for both
        write_tar(dp.saved_name)
        roots.append((root, dp.preprocess_rating()))
    (jr, jn), (tr, tn) = roots
    assert tn == jn
    _same_files(jr, tr, "ml-20mx16x32/sasrec_format.csv")


def amzn_csv(num_users=60, num_items=40, seed=3):
    """`ratings_Books.csv` as SNAP publishes it: no header, user and ASIN
    strings, float ratings, unix seconds. Some users and items fall under
    the 5-core filter."""
    rng = np.random.default_rng(seed)
    lines = []
    for u in range(num_users):
        n = int(rng.integers(2, 12))
        for i in rng.choice(num_items, n, replace=False):
            lines.append(f"A{u * 7919 % 1000:04d}X{u},0{i:03d}{'X' if i % 4 == 0 else '9'},"
                         f"{float(rng.integers(1, 6))},{int(rng.integers(1e9, 1.1e9))}")
    lines.append("AONE,09999X,5.0,1000000000")  # a user and an item with one rating each
    return ("\n".join(lines) + "\n").encode()


def test_amazon_processor_filters_and_remaps_as_the_jax_package(tmp_path):
    data = amzn_csv()

    def write(path):
        with open(path, "wb") as f:
            f.write(data)

    (jr, jn), (tr, tn) = _both(tmp_path, "amzn-books", write, True, expected_num_unique_items=None)
    assert tn == jn
    _same_files(jr, tr, "amzn_books/sasrec_format.csv")
    with open(os.path.join(tr, "amzn_books", "sasrec_format.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    n_in = len({line.split(",")[0] for line in data.decode().split()})
    assert 0 < len(rows) < n_in  # the filter dropped users
    assert all(len(r["sequence_item_ids"].split(",")) >= 5 for r in rows)
    assert tn < 41  # and items


def test_preprocess_public_data_main_with_the_zip_in_place(tmp_path):
    """The CLI through the registry: the archive is at its registry path, so
    nothing is fetched; the registry's item count (3,706) holds."""
    root = str(tmp_path)
    _zip(os.path.join(root, "movielens1m.zip"), ml1m_files())
    assert t_cli.main(["--dataset_name", "ml-1m", "--data_root", root]) == ML1M_ITEMS
    assert os.path.exists(os.path.join(root, "ml-1m", "sasrec_format.csv"))
    assert os.path.exists(os.path.join(root, "processed", "ml-1m", "movies.csv"))
    assert t_cli.main(["--dataset_name", "ml-3b", "--data_root", root]) is None
    with pytest.raises(SystemExit):
        t_cli.main(["--dataset_name", "ml-7b", "--data_root", root])


def _rows_equal(got_ds, want_ds, idxs):
    for i in idxs:
        g, w = got_ds.get_row(int(i)), want_ds.get_row(int(i))
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"row {i} {k}")


def _registry_equal(got, want, n_rows):
    for f in ("max_sequence_length", "num_unique_items", "max_item_id", "all_item_ids"):
        assert getattr(got, f) == getattr(want, f), f
    for split in ("train_dataset", "eval_dataset"):
        g, w = getattr(got, split), getattr(want, split)
        assert len(g) == len(w)
        _rows_equal(g, w, np.linspace(0, len(w) - 1, n_rows).astype(int))
    assert (got.item_features is None) == (want.item_features is None)
    if want.item_features is not None:
        gf, wf = got.item_features, want.item_features
        assert (gf.num_items, gf.max_jagged_dimension, gf.max_ind_range) == (
            wf.num_items, wf.max_jagged_dimension, wf.max_ind_range)
        for a, b in zip(gf.lengths + gf.values, wf.lengths + wf.values):
            np.testing.assert_array_equal(a, b)
        assert gf.lengths[0].sum() > 0


def write_shards(prefix, rows_per_shard=(5, 7, 4), num_items=50, seed=4, single=()):
    """A fractal-expansion corpus: shards of ``user_id,"items","ratings"``
    rows with 0-based item ids and float ratings (single events unquoted, as
    csv.QUOTE_MINIMAL writes them), and the ``_users.csv`` row-count index."""
    rng = np.random.default_rng(seed)
    uid = 0
    for i in range(len(rows_per_shard)):
        with open(f"{prefix}_{i}.csv", "w", newline="") as f:
            w = csv.writer(f)
            for _ in range(rows_per_shard[i]):
                n = 1 if uid in single else int(rng.integers(2, 12))
                w.writerow([uid, ",".join(map(str, rng.integers(0, num_items, n))),
                            ",".join(f"{x}.0" for x in rng.integers(1, 6, n))])
                uid += 1
    with open(f"{prefix}_users.csv", "w", newline="") as f:
        csv.writer(f).writerows(enumerate(rows_per_shard))


@pytest.mark.parametrize("name", ["ml-1m", "ml-20m", "ml-3b", "amzn-books"])
def test_get_reco_dataset_matches_the_jax_package(tmp_path, name):
    root = str(tmp_path)
    if name == "ml-3b":
        os.makedirs(os.path.join(root, "ml-3b"))
        write_shards(os.path.join(root, "ml-3b", "16x32"), single=(3, 9))
    else:
        dp = _processor(t_pre, name, root, expected_num_unique_items=(
            ML1M_ITEMS if name == "ml-1m" else None))
        if name == "amzn-books":
            with open(dp.saved_name, "wb") as f:
                f.write(amzn_csv())
        else:
            _zip(dp.saved_name, ml1m_files() if name == "ml-1m" else ml20m_files())
        dp.preprocess_rating()
    for N in (8, 200):
        want = j_reco.get_reco_dataset(name, N, data_root=root)
        got = t_reco.get_reco_dataset(name, N, data_root=root)
        _registry_equal(got, want, 12)
    if name == "ml-3b":
        assert isinstance(got.train_dataset, t_data.MultiFileSequenceDataset)
        assert got.train_dataset._native is not None
    with pytest.raises(ValueError, match="Unknown dataset"):
        t_reco.get_reco_dataset("ml-1b", 8, data_root=root)


def test_item_features_match_and_cap_their_width(tmp_path):
    path = tmp_path / "movies.csv"
    path.write_text(
        "movie_id,title,genres\n"
        '1,"City of Lost Children, The (1995)",Adventure|Sci-Fi\n'
        "2,Heat (1995),A|B|C|D|E|F|G|H|I|J|K|L|M|N|O|P|Q|R\n"
        "3,Up,Comedy\n"
        "9,Past the largest id (2000),Drama\n"
    )
    want = j_reco.build_movielens_item_features(str(path), 5, max_jagged_dimension=16)
    got = t_reco.build_movielens_item_features(str(path), 5, max_jagged_dimension=16)
    for a, b in zip(got.lengths + got.values, want.lengths + want.values):
        np.testing.assert_array_equal(a, b)
    assert got.lengths[0][2] == 16 and got.lengths[1][1] == 5 and got.lengths[1][3] == 1


@pytest.mark.parametrize("shift, ignore", [(0, 0), (1, 1)])
def test_multifile_native_python_and_jax_give_the_same_rows(tmp_path, shift, ignore):
    prefix = str(tmp_path / "c")
    write_shards(prefix, single=(0, 6, 15))
    kw = dict(max_sequence_length=6, ignore_last_n=ignore, shift_id_by=shift, num_items_hint=50)
    native = t_data.MultiFileSequenceDataset(prefix, **kw)
    python = t_data.MultiFileSequenceDataset(prefix, native=False, **kw)
    want = j_data.MultiFileSequenceDataset(prefix, **kw)
    assert native._native is not None and python._native is None
    assert len(native) == len(python) == len(want) == 16
    _rows_equal(native, want, range(16))
    _rows_equal(python, want, range(16))
    r0 = native.get_row(0)  # a single unquoted event: no history, the event as target
    assert r0["history_lengths"] == 0 and r0["target_ids"] >= shift
    np.testing.assert_array_equal(native.all_item_ids(), want.all_item_ids())
    sync = list(t_data.batch_iterator(native, 4, shuffle=True, seed=1))
    pre = list(t_data.prefetched_batch_iterator(native, 4, shuffle=True, seed=1, num_workers=3))
    for a, b in zip(sync, pre):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
    """No silent fall back to the Python path: the compiler's message is
    raised."""
    prefix = str(tmp_path / "c")
    write_shards(prefix)
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setattr(t_native, "_SRC", str(bad))
    monkeypatch.setattr(t_native, "_LIB", str(tmp_path / "libbroken.so"))
    with pytest.raises(RuntimeError, match="building the native csv reader failed"):
        t_data.MultiFileSequenceDataset(prefix, 6, ignore_last_n=0, num_items_hint=50)
    # the Python path runs only when asked for
    ds = t_data.MultiFileSequenceDataset(prefix, 6, ignore_last_n=0, num_items_hint=50, native=False)
    assert len(ds) == 16 and ds.get_row(3)["history_lengths"] >= 1


def test_run_expansion_matches_the_jax_package(tmp_path):
    """The same shards, byte for byte: numpy's global state seeded alike
    before each call (`svds` draws its start vector from it)."""
    rng = np.random.default_rng(0)
    lines = ["userId,movieId,rating,timestamp"]
    for u in range(40):
        for i in rng.choice(25, size=int(rng.integers(5, 12)), replace=False):
            lines.append(f"{u + 1},{10 * i + 1},{rng.integers(1, 11) / 2},{1_000_000 + u}")
    csv_in = tmp_path / "ratings.csv"
    csv_in.write_text("\n".join(lines) + "\n")
    metas = {}
    for tag, run in (("jax", j_frac.run_expansion), ("port", t_frac.run_expansion)):
        np.random.seed(7)
        metas[tag] = run(str(csv_in), str(tmp_path / tag) + "/", 3, 2, seed=5)
    assert vars(metas["port"]) == vars(metas["jax"]) and metas["port"].num_rows > 0
    for i in range(3):
        _same_files(tmp_path / "jax", tmp_path / "port", f"3x2_{i}.csv")
    _same_files(tmp_path / "jax", tmp_path / "port", "3x2_users.csv")
    np.random.seed(7)
    assert t_frac.main(["--input-csv-file", str(csv_in), "--num-row-multiplier", "2",
                        "--num-col-multiplier", "2", "--write-dataset", "false"]) is None
    ds = t_data.MultiFileSequenceDataset(str(tmp_path / "port" / "3x2"), 8, ignore_last_n=1,
                                         shift_id_by=1, num_items_hint=50)
    assert len(ds) == metas["port"].num_rows
    assert (next(t_data.batch_iterator(ds, 4, shuffle=False))["target_ids"] >= 1).all()
