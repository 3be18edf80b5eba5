"""Sequence datasets (host side, numpy) and batch prefetching: the port's own
copy of what it needs from `generative_recommenders_tpu/data/dataset.py`
(which imports no JAX, but the port imports nothing of the JAX package). The
same seed gives the same rows as the JAX package's copy.
`MultiFileSequenceDataset` reads the sharded corpora of the fractal expansion
through the native reader (`data/native_reader.py`); its Python path runs
only when the caller asks for it (``native=False``).

Rows come from a `sasrec_format.csv`-compatible source (columns: user_id,
sequence_item_ids, sequence_ratings, sequence_timestamps: python-literal
lists, chronological order) or from the synthetic generators.

  * reverse-chronological split: target = most recent event, history = rest,
  * ``ignore_last_n`` drops the last n events (train vs eval split),
  * ``chronological=True`` emits history oldest-first,
  * ``sample_ratio`` keeps each event with that probability,
  * history is padded or truncated to ``max_sequence_length``.
"""

from __future__ import annotations

import ast
import csv
import dataclasses
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List

import numpy as np

from generative_recommenders_tpu_torch.data.native_reader import NativeCorpus


@dataclasses.dataclass
class UserSequences:
    """Column store of per-user event sequences (chronological)."""

    user_ids: np.ndarray  # int64[U]
    item_ids: List[np.ndarray]  # U arrays, chronological
    ratings: List[np.ndarray]
    timestamps: List[np.ndarray]

    def __len__(self) -> int:
        return len(self.item_ids)


def load_sasrec_format_csv(path: str) -> UserSequences:
    """Parses a preprocessed `sasrec_format.csv`."""
    users, items, ratings, ts = [], [], [], []
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        for row in reader:
            users.append(int(row["user_id"]))

            def parse(x: str) -> np.ndarray:
                v = ast.literal_eval(x)
                if isinstance(v, int):
                    v = [v]
                return np.asarray(list(v), dtype=np.int64)

            items.append(parse(row["sequence_item_ids"]))
            ratings.append(parse(row["sequence_ratings"]))
            ts.append(parse(row["sequence_timestamps"]))
    return UserSequences(
        user_ids=np.asarray(users, dtype=np.int64),
        item_ids=items,
        ratings=ratings,
        timestamps=ts,
    )


def synthetic_user_sequences(
    num_users: int,
    num_items: int,
    max_len: int = 60,
    min_len: int = 5,
    latent_dim: int = 16,
    seed: int = 0,
) -> UserSequences:
    """Learnable synthetic corpus: items carry latent factors; each user walks
    item-space with next ~ softmax(z_items @ (u + 0.5 * z_prev)).  A sequence
    model can beat popularity on this, so HR@k improving over training is a
    meaningful smoke signal.
    """
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((num_items + 1, latent_dim)).astype(np.float32)
    z[0] = 0.0
    items, ratings, ts = [], [], []
    lengths = rng.integers(min_len, max_len + 1, size=num_users)
    for u in range(num_users):
        n = int(lengths[u])
        uvec = rng.standard_normal((latent_dim,)).astype(np.float32)
        seq = np.empty((n,), dtype=np.int64)
        prev = np.zeros((latent_dim,), np.float32)
        # sample from a candidate pool per step to keep generation cheap
        for i in range(n):
            cands = rng.integers(1, num_items + 1, size=64)
            logits = z[cands] @ (uvec + 0.5 * prev)
            p = np.exp(logits - logits.max())
            p /= p.sum()
            pick = cands[rng.choice(64, p=p)]
            seq[i] = pick
            prev = z[pick]
        items.append(seq)
        ratings.append(rng.integers(1, 6, size=n).astype(np.int64))
        base = rng.integers(1_000_000_000, 1_100_000_000)
        ts.append(base + np.cumsum(rng.integers(60, 86400, size=n)).astype(np.int64))
    return UserSequences(
        user_ids=np.arange(1, num_users + 1, dtype=np.int64),
        item_ids=items,
        ratings=ratings,
        timestamps=ts,
    )


class SequenceDataset:
    """Padded fixed-length rows from `UserSequences`."""

    def __init__(
        self,
        sequences: UserSequences,
        max_sequence_length: int,
        ignore_last_n: int,
        chronological: bool = True,
        sample_ratio: float = 1.0,
        seed: int = 0,
        shift_id_by: int = 0,
    ) -> None:
        self._seq = sequences
        self._max_seq_len = max_sequence_length
        self._ignore_last_n = ignore_last_n
        self._chronological = chronological
        self._sample_ratio = sample_ratio
        self._rng = np.random.default_rng(seed)
        self._shift_id_by = shift_id_by  # amzn ids are 0-based

    def __len__(self) -> int:
        return len(self._seq)

    def get_row(self, idx: int) -> Dict[str, np.ndarray]:
        items = self._seq.item_ids[idx]
        if self._shift_id_by:
            items = items + self._shift_id_by
        ratings = self._seq.ratings[idx]
        ts = self._seq.timestamps[idx]
        if self._ignore_last_n > 0:
            # fractal-expansion corpora contain 1-event rows; clamp so the
            # row degrades to a cold-start sample (empty history, the event
            # as target) instead of crashing on an empty slice
            ign = min(self._ignore_last_n, len(items) - 1)
            if ign > 0:
                items = items[:-ign]
                ratings = ratings[:-ign]
                ts = ts[:-ign]
        if self._sample_ratio < 1.0 and len(items) > 1:
            keep = self._rng.random(len(items)) < self._sample_ratio
            keep[-1] = True  # never drop the target
            items, ratings, ts = items[keep], ratings[keep], ts[keep]
        # target = most recent event; history = all prior events.
        target_id, target_rating, target_ts = (
            int(items[-1]), int(ratings[-1]), int(ts[-1]),
        )
        hist_items, hist_ratings, hist_ts = items[:-1], ratings[:-1], ts[:-1]
        N = self._max_seq_len
        n = min(len(hist_items), N)
        if not self._chronological:
            hist_items = hist_items[::-1]
            hist_ratings = hist_ratings[::-1]
            hist_ts = hist_ts[::-1]
            sl = slice(0, n)
        else:
            sl = slice(len(hist_items) - n, len(hist_items))

        def pad(x: np.ndarray) -> np.ndarray:
            out = np.zeros((N,), dtype=np.int64)
            out[:n] = x[sl]
            return out

        return {
            "user_id": np.int64(self._seq.user_ids[idx]),
            "historical_ids": pad(hist_items),
            "historical_ratings": pad(hist_ratings),
            "historical_timestamps": pad(hist_ts),
            "history_lengths": np.int64(n),
            "target_ids": np.int64(target_id),
            "target_ratings": np.int64(target_rating),
            "target_timestamps": np.int64(target_ts),
        }

    def all_item_ids(self) -> np.ndarray:
        ids = np.unique(np.concatenate(self._seq.item_ids)) + self._shift_id_by
        return ids[ids > 0]


def batch_iterator(
    dataset: SequenceDataset,
    batch_size: int,
    shuffle: bool,
    seed: int = 0,
    drop_last: bool = True,
    num_shards: int = 1,
    shard_index: int = 0,
    shard_contiguous: bool = False,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yields stacked numpy batches; shards rows round-robin across hosts.
    ``shard_contiguous`` slices PER-BATCH contiguous blocks instead —
    multi-host global batches then reproduce the single-host logical batch
    exactly (host h takes rows [h*B/n, (h+1)*B/n) of every global batch)."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    if shard_contiguous and num_shards > 1:
        local = batch_size
        global_bs = batch_size * num_shards
        n_batches = len(order) // global_bs
        for gb in range(n_batches):
            start = gb * global_bs + shard_index * local
            idxs = order[start : start + local]
            yield _build_batch(dataset, idxs)
        return
    order = order[shard_index::num_shards]
    n_full = len(order) // batch_size
    end = n_full * batch_size if drop_last else len(order)
    for start in range(0, end, batch_size):
        idxs = order[start : start + batch_size]
        if len(idxs) < batch_size and drop_last:
            break
        yield _build_batch(dataset, idxs)


def _build_batch(dataset: SequenceDataset, idxs) -> Dict[str, np.ndarray]:
    rows = [dataset.get_row(int(i)) for i in idxs]
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def prefetched_batch_iterator(
    dataset: SequenceDataset,
    batch_size: int,
    shuffle: bool,
    seed: int = 0,
    drop_last: bool = True,
    num_shards: int = 1,
    shard_index: int = 0,
    num_workers: int = 8,
    prefetch_factor: int = 16,
) -> Iterator[Dict[str, np.ndarray]]:
    """Threaded, order-preserving batch prefetcher.

    Batches are built concurrently by a thread pool with a bounded
    in-flight window, so host-side CSV parsing / numpy stacking overlaps
    the device's step instead of serializing with it.
    """
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    order = order[shard_index::num_shards]
    n_full = len(order) // batch_size
    end = n_full * batch_size if drop_last else len(order)
    starts = [
        s
        for s in range(0, end, batch_size)
        if not (drop_last and s + batch_size > end)
    ]
    if not starts:
        return
    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        window: deque = deque()
        it = iter(starts)
        for s in it:
            window.append(
                ex.submit(_build_batch, dataset, order[s : s + batch_size])
            )
            if len(window) >= prefetch_factor:
                break
        for s in it:
            yield window.popleft().result()
            window.append(
                ex.submit(_build_batch, dataset, order[s : s + batch_size])
            )
        while window:
            yield window.popleft().result()


class MultiFileSequenceDataset(SequenceDataset):
    """Sharded-CSV dataset of the fractal-expansion corpora (ML-3B): shards
    ``<prefix>_{i}.csv`` with rows ``user_id,"items","ratings"`` and the
    ``<prefix>_users.csv`` index of each shard's row count, as
    `cli/run_fractal_expansion.py` writes them. The timestamps are the item
    ids (the reference's placeholder). Rows are read lazily.

    ``native=True`` (the default) reads through the native reader; a failed
    build or load raises. ``native=False`` reads with Python's `csv`, through
    a per-shard line-offset index and per-thread file handles.
    """

    def __init__(
        self,
        file_prefix: str,
        max_sequence_length: int,
        ignore_last_n: int,
        shift_id_by: int = 0,
        chronological: bool = True,
        sample_ratio: float = 1.0,
        seed: int = 0,
        num_items_hint: int = 0,
        native: bool = True,
    ) -> None:
        self._file_prefix = file_prefix
        with open(f"{file_prefix}_users.csv", newline="") as f:
            counts = [int(row[1]) for row in csv.reader(f)]
        self._cumsum = np.cumsum(counts)
        self._offsets_cache: Dict[int, np.ndarray] = {}
        self._offsets_lock = threading.Lock()
        self._handles = threading.local()
        self._native = NativeCorpus(file_prefix, counts) if native else None
        self._shift_id_by = shift_id_by
        self._num_items_hint = num_items_hint
        self._max_seq_len = max_sequence_length
        self._ignore_last_n = ignore_last_n
        self._chronological = chronological
        self._sample_ratio = sample_ratio
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return int(self._cumsum[-1])

    def _line_offsets(self, shard: int) -> np.ndarray:
        if shard not in self._offsets_cache:
            offs = [0]
            with open(f"{self._file_prefix}_{shard}.csv", "rb") as f:
                for line in f:
                    offs.append(offs[-1] + len(line))
            arr = np.asarray(offs[:-1], dtype=np.int64)
            with self._offsets_lock:
                self._offsets_cache.setdefault(shard, arr)
        return self._offsets_cache[shard]

    def _shard_handle(self, shard: int):
        cache = getattr(self._handles, "cache", None)
        if cache is None:
            cache = self._handles.cache = {}
        f = cache.get(shard)
        if f is None:
            f = cache[shard] = open(f"{self._file_prefix}_{shard}.csv", newline="")
        return f

    def _read_line(self, idx: int) -> List[str]:
        shard = int(np.searchsorted(self._cumsum, idx, side="right"))
        local = idx - (0 if shard == 0 else int(self._cumsum[shard - 1]))
        f = self._shard_handle(shard)
        f.seek(int(self._line_offsets(shard)[local]))
        return next(csv.reader([f.readline()]))

    def get_row(self, idx: int) -> Dict[str, np.ndarray]:
        if self._native is not None:
            user_id, items, ratings = self._native.read_row(int(idx))
            items = items + self._shift_id_by
        else:
            parts = self._read_line(int(idx))
            user_id = int(parts[0])
            items = np.asarray([int(x) + self._shift_id_by for x in parts[1].split(",")], dtype=np.int64)
            ratings = np.asarray([int(float(x)) for x in parts[2].split(",")], dtype=np.int64)
        seq = UserSequences(
            user_ids=np.asarray([user_id]), item_ids=[items], ratings=[ratings],
            timestamps=[items.copy()],  # placeholder timestamps: the item ids
        )
        row = SequenceDataset(
            seq, self._max_seq_len, self._ignore_last_n, self._chronological, self._sample_ratio
        ).get_row(0)
        row["user_id"] = np.int64(user_id)
        return row

    def all_item_ids(self) -> np.ndarray:
        assert self._num_items_hint > 0, "pass num_items_hint for multi-file corpora (no full scan)"
        return np.arange(1, self._num_items_hint + 1, dtype=np.int64)


def synthetic_user_sequences_vectorized(
    num_users: int,
    num_items: int,
    max_len: int = 60,
    min_len: int = 5,
    latent_dim: int = 16,
    seed: int = 0,
) -> UserSequences:
    """Vectorized twin of `synthetic_user_sequences` for corpus-scale
    generation (ML-20M-shaped parity runs): all users advance one step per
    iteration (Gumbel-max sampling over a 64-item candidate pool), so
    generation is O(max_len) numpy passes instead of O(total events) python
    steps. Same latent-factor sequential structure."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((num_items + 1, latent_dim)).astype(np.float32)
    z[0] = 0.0
    U = num_users
    lengths = rng.integers(min_len, max_len + 1, size=U)
    uvec = rng.standard_normal((U, latent_dim)).astype(np.float32)
    prev = np.zeros((U, latent_dim), np.float32)
    seq = np.zeros((U, max_len), np.int64)
    for i in range(max_len):
        active = lengths > i
        cands = rng.integers(1, num_items + 1, size=(U, 64))
        logits = np.einsum("ucl,ul->uc", z[cands], uvec + 0.5 * prev)
        gumbel = -np.log(-np.log(rng.random((U, 64)) + 1e-12) + 1e-12)
        pick = cands[np.arange(U), np.argmax(logits + gumbel, axis=1)]
        seq[:, i] = np.where(active, pick, 0)
        prev = np.where(active[:, None], z[pick], prev)
    items, ratings, ts = [], [], []
    base = rng.integers(1_000_000_000, 1_100_000_000, size=U)
    for u in range(U):
        n = int(lengths[u])
        items.append(seq[u, :n].copy())
        ratings.append(rng.integers(1, 6, size=n).astype(np.int64))
        ts.append(base[u] + np.cumsum(rng.integers(60, 86400, size=n)).astype(np.int64))
    return UserSequences(
        user_ids=np.arange(1, U + 1, dtype=np.int64),
        item_ids=items,
        ratings=ratings,
        timestamps=ts,
    )


def background_prefetch(iterable, size: int = 8):
    """Runs any batch generator on a background thread with a bounded
    queue, so that host batch assembly overlaps the device steps. An error
    in the generator is raised again in the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    done = object()
    failed = []

    def _worker():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # re-raised in the consumer
            failed.append(e)
        finally:
            q.put(done)

    t = threading.Thread(target=_worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is done:
            if failed:
                raise failed[0]
            break
        yield item
