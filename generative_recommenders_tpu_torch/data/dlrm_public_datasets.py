"""Public datasets of the DLRM-v3 ranker (the port's own copy of
`generative_recommenders_tpu/data/dlrm_public_datasets.py`, reading its csv
with the `csv` module instead of pandas): MovieLens from a
`sasrec_format.csv`, KuaiRand from the `processed_seqs.csv` of
`cli/preprocess_dlrm_data.py`.

Each user row's last ``M`` events become the candidates and the rest, cut to
``max_uih_len``, the user history (uih); the contextual features ride along
and the query time is the history's latest timestamp. ``M`` is the config's
``max_num_candidates``, or ``max_num_candidates_inference`` for inference.
Batches are the padded numpy format of `data/dlrm_dataset.py`:
(uih_features, uih_lengths, cand_features, num_candidates).
"""

from __future__ import annotations

import csv
import json
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from generative_recommenders_tpu_torch.modules.dlrm_hstu import DlrmHSTUConfig


def separate_uih_candidates(x: Any, candidates_max_seq_len: int) -> Tuple[List[int], List[int]]:
    """(all but the last ``candidates_max_seq_len`` events, those last ones)
    of a list, or of its text ("1,2,3" or "[1, 2, 3]")."""
    if isinstance(x, str):
        if not (x.startswith("[") and x.endswith("]")):
            x = "[" + x + "]"
        y = json.loads(x)
    else:
        y = x
    y_list = [y] if isinstance(y, (int, np.integer)) else list(y)
    return y_list[:-candidates_max_seq_len], y_list[-candidates_max_seq_len:]


def maybe_truncate_seq(y: List[int], max_seq_len: int) -> List[int]:
    return y[:max_seq_len] if len(y) > max_seq_len else y


def process_and_hash_x(x: Any, hash_size: int) -> Any:
    """An id, or a list of ids (or their JSON text), modulo ``hash_size``."""
    if isinstance(x, str):
        x = json.loads(x)
    if isinstance(x, list):
        return [int(v) % hash_size for v in x]
    return int(x) % hash_size


def _int(x: str) -> int:
    """A csv cell as pandas would hand it to ``int()``."""
    try:
        return int(x)
    except ValueError:
        return int(float(x))


def _read_rows(path: str) -> List[Dict[str, str]]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


class _PaddedPublicDataset:
    """Padded batching over per-row (uih dict, uih length, candidates dict,
    number of candidates) samples."""

    def __init__(self, cfg: DlrmHSTUConfig, is_inference: bool = False):
        self._cfg = cfg
        self._M = cfg.max_num_candidates_inference if is_inference else cfg.max_num_candidates

    def __len__(self) -> int:
        raise NotImplementedError

    def load_item(self, idx: int):
        raise NotImplementedError

    def batches(
        self, batch_size: int, num_batches: Optional[int] = None,
        shuffle: bool = False, seed: int = 0,
    ) -> Iterator[Tuple]:
        """Batches of ``batch_size`` rows in file order (or shuffled by
        ``seed``), rows without a history skipped; the last one may be
        partial."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        rows: List[Tuple] = []
        emitted = 0
        for idx in order:
            item = self.load_item(int(idx))
            if item is None:
                continue
            rows.append(item)
            if len(rows) == batch_size:
                yield self._collate(rows)
                rows = []
                emitted += 1
                if num_batches is not None and emitted >= num_batches:
                    return
        if rows and (num_batches is None or emitted < num_batches):
            yield self._collate(rows)

    def _collate(self, rows: List[Tuple]) -> Tuple:
        M, Nu = self._M, self._cfg.max_uih_len
        B = len(rows)
        uih_lengths = np.asarray([r[1] for r in rows], np.int32)
        num_candidates = np.asarray([r[3] for r in rows], np.int32)
        uih_features = {}
        for name in rows[0][0]:
            first = rows[0][0][name]
            width = 1 if np.isscalar(first) or np.ndim(first) == 0 else Nu
            arr = np.zeros((B, width), np.int64)
            for b, r in enumerate(rows):
                v = np.atleast_1d(np.asarray(r[0][name], np.int64))
                arr[b, : len(v)] = v[:width]
            uih_features[name] = arr
        cand_features = {}
        for name in rows[0][2]:
            arr = np.zeros((B, M), np.int64)
            for b, r in enumerate(rows):
                v = np.atleast_1d(np.asarray(r[2][name], np.int64))
                arr[b, : len(v)] = v[:M]
            cand_features[name] = arr
        return uih_features, uih_lengths, cand_features, num_candidates


class DLRMv3MovieLensDataset(_PaddedPublicDataset):
    """MovieLens rows of a `sasrec_format.csv`."""

    def __init__(self, cfg: DlrmHSTUConfig, ratings_file: str, is_inference: bool = False) -> None:
        super().__init__(cfg, is_inference)
        self._rows = _read_rows(ratings_file)
        self._ctx = dict(cfg.contextual_feature_to_max_length)

    def __len__(self) -> int:
        return len(self._rows)

    def load_item(self, idx: int):
        cfg, M = self._cfg, self._M
        data = self._rows[idx]
        ids_uih, ids_cand = separate_uih_candidates(data["sequence_item_ids"], M)
        if len(ids_uih) < 1:
            return None
        ratings_uih, _ = separate_uih_candidates(data["sequence_ratings"], M)
        ts_uih, _ = separate_uih_candidates(data["sequence_timestamps"], M)
        ids_uih = maybe_truncate_seq(ids_uih, cfg.max_uih_len)
        ratings_uih = maybe_truncate_seq(ratings_uih, cfg.max_uih_len)
        ts_uih = maybe_truncate_seq(ts_uih, cfg.max_uih_len)
        n = len(ids_uih)
        query_time = max(ts_uih)
        uih = {
            "movie_id": ids_uih,
            "action_timestamp": ts_uih,
            "dummy_weights": [0] * n,
            "dummy_watch_time": [0] * n,
        }
        for name in self._ctx:
            uih[name] = _int(data[name]) if name in data else 0
        cands = {
            "item_movie_id": ids_cand,
            "item_query_time": [query_time] * M,
            "item_dummy_weights": [1] * M,
            "item_dummy_watchtime": [1] * M,
        }
        return uih, n, cands, M


class DLRMv3KuaiRandDataset(_PaddedPublicDataset):
    """KuaiRand rows of a `processed_seqs.csv`; the columns named in
    ``hash_sizes`` are taken modulo their size."""

    def __init__(
        self,
        cfg: DlrmHSTUConfig,
        seq_logs_file: str,
        hash_sizes: Optional[Dict[str, int]] = None,
        is_inference: bool = False,
    ) -> None:
        super().__init__(cfg, is_inference)
        self._rows: List[Dict[str, Any]] = _read_rows(seq_logs_file)
        self._ctx = dict(cfg.contextual_feature_to_max_length)
        for key, hash_size in (hash_sizes or {}).items():
            if self._rows and key in self._rows[0]:
                for row in self._rows:
                    row[key] = process_and_hash_x(row[key], hash_size)

    def __len__(self) -> int:
        return len(self._rows)

    def load_item(self, idx: int):
        cfg, M = self._cfg, self._M
        data = self._rows[idx]
        vids_uih, vids_cand = separate_uih_candidates(data["video_id"], M)
        if len(vids_uih) < 1:
            return None
        w_uih, w_cand = separate_uih_candidates(data["action_weights"], M)
        ts_uih, _ = separate_uih_candidates(data["time_ms"], M)
        wt_uih, wt_cand = separate_uih_candidates(data["play_time_ms"], M)
        vids_uih = maybe_truncate_seq(vids_uih, cfg.max_uih_len)
        w_uih = maybe_truncate_seq(w_uih, cfg.max_uih_len)
        ts_uih = maybe_truncate_seq(ts_uih, cfg.max_uih_len)
        wt_uih = maybe_truncate_seq(wt_uih, cfg.max_uih_len)
        n = len(vids_uih)
        query_time = max(ts_uih)
        uih = {
            "video_id": vids_uih,
            "action_timestamp": ts_uih,
            "action_weight": w_uih,
            "watch_time": wt_uih,
        }
        for name in self._ctx:
            uih[name] = _int(data[name]) if name in data else 0
        cands = {
            "item_video_id": vids_cand,
            "item_action_weight": w_cand,
            "item_target_watchtime": wt_cand,
            "item_query_time": [query_time] * M,
        }
        return uih, n, cands, M
