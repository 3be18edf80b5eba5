"""Public-dataset download and preprocessing into `sasrec_format.csv` (the
port's own copy of `generative_recommenders_tpu/data/preprocessor.py`, with
numpy and the `csv` module where the JAX package uses pandas; the output is
row for row the same). One row per user, comma-joined sequences sorted by
time, the users shuffled:

    index, user_id, sequence_item_ids, sequence_ratings, sequence_timestamps
    [+ sex, age_group, occupation, zip_code for ml-1m]

`get_common_preprocessors` is the registry of the JAX package: the same
prefixes, expected item counts and download URLs. `download` fetches only
when the archive is missing.

What pandas does here and how it is kept:
  * a column is read as int64 if every value parses as an integer, else as
    float64, else as text (`_typed`);
  * ``sort_values`` on one column is `np.argsort(kind="quicksort")`, and
    ``groupby`` keeps each group's rows in that order, its keys sorted;
  * ``pd.Categorical(...).codes`` index the sorted distinct values;
  * ``sample(frac=1, random_state=s)`` is `RandomState(s).permutation`, and
    ``reset_index()`` writes the pre-shuffle row number as ``index``.
"""

from __future__ import annotations

import csv
import dataclasses
import logging
import os
import tarfile
from typing import Dict, List, Optional
from urllib.request import urlretrieve
from zipfile import ZipFile

import numpy as np

logger = logging.getLogger(__name__)

Table = Dict[str, np.ndarray]  # column name -> values, one row per index


def _typed(values: List[str]) -> np.ndarray:
    """A text column as pandas' reader types it: int64, else float64 (an
    empty cell is NaN), else text."""
    try:
        return np.asarray(values, dtype=np.int64)
    except ValueError:
        pass
    try:
        return np.asarray([v or "nan" for v in values], dtype=np.float64)
    except ValueError:
        return np.asarray(values, dtype=object)


def _read_rows(path: str, sep: str, encoding: str = "utf-8") -> List[List[str]]:
    """Rows of a file with a multi-character separator (no quoting), as
    pandas' python engine splits them."""
    with open(path, encoding=encoding, newline="") as f:
        return [line.rstrip("\r\n").split(sep) for line in f if line.strip()]


def read_csv_columns(path: str, names: Optional[List[str]] = None, encoding: str = "utf-8") -> Table:
    """A csv file as typed columns; its first row is the header unless
    ``names`` are given."""
    with open(path, encoding=encoding, newline="") as f:
        rows = list(csv.reader(f))
    if names is None:
        names, rows = rows[0], rows[1:]
    return _columns(rows, names)


def _columns(rows: List[List[str]], names: List[str]) -> Table:
    cols = list(zip(*rows)) if rows else [()] * len(names)
    return {n: _typed(list(c)) for n, c in zip(names, cols)}


def _codes(x: np.ndarray) -> np.ndarray:
    """``pd.Categorical(x).codes``: each value's index among the sorted
    distinct values."""
    return np.unique(x, return_inverse=True)[1].astype(np.int64)


def _take(table: Table, idx: np.ndarray) -> Table:
    return {k: v[idx] for k, v in table.items()}


def _write_csv(path: str, header: List[str], rows) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows(rows)


def _join(xs: np.ndarray) -> str:
    return ",".join(str(v) for v in xs.tolist())


@dataclasses.dataclass
class DataProcessor:
    prefix: str
    data_root: str = "tmp"
    expected_num_unique_items: Optional[int] = None
    expected_max_item_id: Optional[int] = None

    def output_format_csv(self) -> str:
        return f"{self.data_root}/{self.prefix}/sasrec_format.csv"

    def _write_seq_csv(
        self, ratings: Table, users: Optional[Table],
        time_col: str, item_col: str, seed: int = 0,
    ) -> int:
        """Per-user sequences sorted by time, the users shuffled."""
        order = np.argsort(ratings[time_col], kind="quicksort")
        order = order[np.argsort(ratings["user_id"][order], kind="stable")]
        r = _take(ratings, order)
        user_ids, starts = np.unique(r["user_id"], return_index=True)
        bounds = list(starts) + [len(order)]
        seqs = [
            [_join(r[c][lo:hi]) for c in (item_col, "rating", time_col)]
            for lo, hi in zip(bounds[:-1], bounds[1:])
        ]
        header = ["index", "user_id", "sequence_item_ids", "sequence_ratings", "sequence_timestamps"]
        extra: List[List[str]] = [[] for _ in user_ids]
        if users is not None:
            # a left join on user_id; a user missing from `users` gets empty cells
            names = [c for c in users if c != "user_id"]
            header += names
            where = {u: i for i, u in enumerate(users["user_id"].tolist())}
            extra = [
                [str(users[c][where[u]]) if u in where else "" for c in names]
                for u in user_ids.tolist()
            ]
        os.makedirs(f"{self.data_root}/{self.prefix}", exist_ok=True)
        perm = np.random.RandomState(seed).permutation(len(user_ids))
        _write_csv(
            self.output_format_csv(), header,
            ([i, user_ids[i], *seqs[i], *extra[i]] for i in perm.tolist()),
        )
        num_unique_items = len(np.unique(ratings[item_col]))
        if self.expected_num_unique_items is not None:
            assert num_unique_items == self.expected_num_unique_items, (
                f"expected {self.expected_num_unique_items} items, got {num_unique_items}"
            )
        logger.info(
            "%s: %d users, %d items -> %s",
            self.prefix, len(user_ids), num_unique_items, self.output_format_csv(),
        )
        return num_unique_items

    def preprocess_rating(self) -> Optional[int]:
        raise NotImplementedError


@dataclasses.dataclass
class MovielensDataProcessor(DataProcessor):
    """ml-1m, ml-20m and ml-1b (the ``trainx16x32_{i}.npz`` shards)."""

    download_url: str = ""
    saved_name: str = ""

    def download(self) -> None:
        if not os.path.exists(self.saved_name):
            os.makedirs(os.path.dirname(self.saved_name) or ".", exist_ok=True)
            urlretrieve(self.download_url, self.saved_name)
        if self.saved_name.endswith(".zip"):
            with ZipFile(self.saved_name, "r") as z:
                z.extractall(path=f"{self.data_root}/")
        else:
            with tarfile.open(self.saved_name, "r:*") as tar:
                tar.extractall(f"{self.data_root}/", filter="data")

    def preprocess_rating(self) -> int:
        self.download()
        root = f"{self.data_root}/{self.prefix}"
        users = None
        if self.prefix == "ml-1m":
            users = _columns(
                _read_rows(f"{root}/users.dat", "::"),
                ["user_id", "sex", "age_group", "occupation", "zip_code"],
            )
            for col in ("sex", "age_group", "occupation", "zip_code"):
                users[col] = _codes(users[col])
            ratings = _columns(
                _read_rows(f"{root}/ratings.dat", "::"),
                ["user_id", "movie_id", "rating", "unix_timestamp"],
            )
        elif self.prefix == "ml-20m":
            ratings = read_csv_columns(f"{root}/ratings.csv")
            for old, new in (("userId", "user_id"), ("movieId", "movie_id"), ("timestamp", "unix_timestamp")):
                ratings[new] = ratings.pop(old)
        else:  # ml-20mx16x32 (ml-1b)
            user_ids, movie_ids = [], []
            for i in range(16):
                with np.load(f"{root}/trainx16x32_{i}.npz") as data:
                    user_ids.append(data["arr_0"][:, 0])
                    movie_ids.append(data["arr_0"][:, 1])
            u, m = np.concatenate(user_ids), np.concatenate(movie_ids)
            # the ratings and timestamps are placeholders, as in the reference
            ratings = {"user_id": u, "movie_id": m, "rating": u, "unix_timestamp": m}
        if self.prefix in ("ml-1m", "ml-20m"):
            movies_path = f"{root}/movies.dat" if self.prefix == "ml-1m" else f"{root}/movies.csv"
            if os.path.exists(movies_path):
                if self.prefix == "ml-1m":
                    rows = _read_rows(movies_path, "::", encoding="iso-8859-1")
                else:
                    with open(movies_path, encoding="iso-8859-1", newline="") as f:
                        rows = list(csv.reader(f))[1:]
                out_dir = f"{self.data_root}/processed/{self.prefix}"
                os.makedirs(out_dir, exist_ok=True)
                _write_csv(f"{out_dir}/movies.csv", ["movie_id", "title", "genres"], rows)
        return self._write_seq_csv(ratings, users, time_col="unix_timestamp", item_col="movie_id")


@dataclasses.dataclass
class AmazonDataProcessor(DataProcessor):
    """amzn-books: the 5-core filter, then ids remapped to category codes."""

    download_url: str = ""
    saved_name: str = ""

    def download(self) -> None:
        if not os.path.exists(self.saved_name):
            os.makedirs(os.path.dirname(self.saved_name) or ".", exist_ok=True)
            urlretrieve(self.download_url, self.saved_name)

    def preprocess_rating(self) -> int:
        self.download()
        ratings = read_csv_columns(self.saved_name, names=["user_id", "item_id", "rating", "timestamp"])

        def at_least_5(col: str) -> np.ndarray:
            _, inv, counts = np.unique(ratings[col], return_inverse=True, return_counts=True)
            return counts[inv] >= 5

        # the 5-core filter: items first, then users over what is left
        ratings = _take(ratings, at_least_5("item_id"))
        ratings = _take(ratings, at_least_5("user_id"))
        ratings["item_id"] = _codes(ratings["item_id"])
        ratings["user_id"] = _codes(ratings["user_id"])
        ratings = _take(ratings, at_least_5("user_id"))
        return self._write_seq_csv(ratings, None, time_col="timestamp", item_col="item_id")


@dataclasses.dataclass
class MovielensSyntheticDataProcessor(DataProcessor):
    """ml-3b / ml-13b: the fractal expansion writes them
    (`cli/run_fractal_expansion.py`); nothing to download."""

    def preprocess_rating(self) -> None:
        return None


def get_common_preprocessors(data_root: str = "tmp") -> Dict[str, DataProcessor]:
    return {
        "ml-1m": MovielensDataProcessor(
            prefix="ml-1m",
            data_root=data_root,
            download_url="http://files.grouplens.org/datasets/movielens/ml-1m.zip",
            saved_name=f"{data_root}/movielens1m.zip",
            expected_num_unique_items=3706,
            expected_max_item_id=3952,
        ),
        "ml-20m": MovielensDataProcessor(
            prefix="ml-20m",
            data_root=data_root,
            download_url="http://files.grouplens.org/datasets/movielens/ml-20m.zip",
            saved_name=f"{data_root}/movielens20m.zip",
            expected_num_unique_items=26744,
            expected_max_item_id=131262,
        ),
        "ml-1b": MovielensDataProcessor(
            prefix="ml-20mx16x32",
            data_root=data_root,
            download_url="https://files.grouplens.org/datasets/movielens/ml-20mx16x32.tar",
            saved_name=f"{data_root}/movielens1b.tar",
        ),
        "ml-3b": MovielensSyntheticDataProcessor(
            prefix="ml-3b",
            data_root=data_root,
            expected_num_unique_items=26743 * 32,
            expected_max_item_id=26743 * 32,
        ),
        "amzn-books": AmazonDataProcessor(
            prefix="amzn_books",
            data_root=data_root,
            download_url=(
                "http://snap.stanford.edu/data/amazon/productGraph/categoryFiles/ratings_Books.csv"
            ),
            saved_name=f"{data_root}/ratings_Books.csv",
            expected_num_unique_items=695762,
        ),
    }
