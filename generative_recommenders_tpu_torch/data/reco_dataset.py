"""The dataset registry of the research stack (port of
`generative_recommenders_tpu/data/reco_dataset.py`): train and eval datasets,
item ids and, for MovieLens, the item features, found by dataset name under
``data_root`` where the preprocessors wrote them.

The item features hash genres, title words and the year with Python's
``hash()``, as the reference does; string hashes are salted per process
(``PYTHONHASHSEED``), so they are equal only within one process.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import List, Optional

import numpy as np

from generative_recommenders_tpu_torch.data.dataset import (
    MultiFileSequenceDataset,
    SequenceDataset,
    load_sasrec_format_csv,
)
from generative_recommenders_tpu_torch.data.preprocessor import get_common_preprocessors


@dataclasses.dataclass
class ItemFeatures:
    """Per-item jagged categorical features."""

    num_items: int
    max_jagged_dimension: int
    max_ind_range: List[int]  # per feature
    lengths: List[np.ndarray]  # [(num_items,)] x num_features
    values: List[np.ndarray]  # [(num_items, max_jagged_dimension)] x num_features


@dataclasses.dataclass
class RecoDataset:
    max_sequence_length: int
    num_unique_items: int
    max_item_id: int
    all_item_ids: List[int]
    train_dataset: SequenceDataset
    eval_dataset: SequenceDataset
    item_features: Optional[ItemFeatures] = None


def build_movielens_item_features(
    movies_csv: str,
    max_item_id: int,
    max_jagged_dimension: int = 16,
) -> ItemFeatures:
    """Hashed genre, title-word and year features of each movie (hash ranges
    63, 16383 and 511)."""
    max_ind_range = [63, 16383, 511]
    n = max_item_id + 1
    feats = ItemFeatures(
        num_items=n,
        max_jagged_dimension=max_jagged_dimension,
        max_ind_range=max_ind_range,
        lengths=[np.zeros((n,), np.int64) for _ in range(3)],
        values=[np.zeros((n, max_jagged_dimension), np.int64) for _ in range(3)],
    )
    with open(movies_csv, newline="") as f:
        for row in csv.DictReader(f):
            movie_id = int(row["movie_id"])
            if movie_id > max_item_id:
                continue
            title = row["title"]
            genres = row["genres"].split("|")
            titles = title[:-7].split(" ") if len(title) > 7 else [title]
            year = title[-5:-1]
            vecs = [
                [hash(x) % max_ind_range[0] for x in genres],
                [hash(x) % max_ind_range[1] for x in titles],
                [hash(year) % max_ind_range[2]],
            ]
            for i, v in enumerate(vecs):
                m = min(len(v), max_jagged_dimension)
                feats.lengths[i][movie_id] = m
                feats.values[i][movie_id, :m] = v[:m]
    return feats


def get_reco_dataset(
    dataset_name: str,
    max_sequence_length: int,
    chronological: bool = True,
    positional_sampling_ratio: float = 1.0,
    data_root: str = "tmp",
    with_item_features: bool = True,
) -> RecoDataset:
    """ml-1m, ml-20m, ml-3b or amzn-books, split chronologically: train
    leaves out each user's last event, eval targets it."""
    dp = get_common_preprocessors(data_root)[dataset_name]
    kw = dict(chronological=chronological, sample_ratio=positional_sampling_ratio)
    item_features = None
    if dataset_name in ("ml-1m", "ml-20m"):
        seqs = load_sasrec_format_csv(dp.output_format_csv())
        train_ds, eval_ds = (
            SequenceDataset(seqs, max_sequence_length, ignore_last_n=n, **kw) for n in (1, 0)
        )
        max_item_id = dp.expected_max_item_id
        movies_csv = f"{data_root}/processed/{dp.prefix}/movies.csv"
        if with_item_features and os.path.exists(movies_csv):
            item_features = build_movielens_item_features(movies_csv, max_item_id)
        all_item_ids = [int(x) for x in train_ds.all_item_ids()]
    elif dataset_name == "ml-3b":
        prefix = f"{data_root}/{dp.prefix}/16x32"
        train_ds, eval_ds = (
            MultiFileSequenceDataset(
                prefix, max_sequence_length, ignore_last_n=n, shift_id_by=1,
                num_items_hint=dp.expected_num_unique_items, **kw,
            )
            for n in (1, 0)
        )
        max_item_id = dp.expected_max_item_id
        all_item_ids = list(range(1, max_item_id + 1))
    elif dataset_name == "amzn-books":
        seqs = load_sasrec_format_csv(dp.output_format_csv())
        train_ds, eval_ds = (
            # amzn ids are 0-based category codes
            SequenceDataset(seqs, max_sequence_length, ignore_last_n=n, shift_id_by=1, **kw)
            for n in (1, 0)
        )
        max_item_id = dp.expected_num_unique_items
        all_item_ids = [x + 1 for x in range(max_item_id)]
    else:
        raise ValueError(f"Unknown dataset {dataset_name}")
    return RecoDataset(
        max_sequence_length=max_sequence_length,
        num_unique_items=dp.expected_num_unique_items or len(all_item_ids),
        max_item_id=max_item_id,
        all_item_ids=all_item_ids,
        train_dataset=train_ds,
        eval_dataset=eval_ds,
        item_features=item_features,
    )
