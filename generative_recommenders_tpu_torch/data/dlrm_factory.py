"""DLRM dataset selection for the train and serve CLIs (port of
`generative_recommenders_tpu/data/dlrm_factory.py`): ``debug`` keeps the
random dataset, ``movielens-1m`` / ``movielens-20m`` / ``kuairand-1k`` read
the files the preprocess CLIs write, and a missing file fails loudly instead
of serving random data."""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

from generative_recommenders_tpu_torch.data.dlrm_dataset import DLRMv3RandomDataset
from generative_recommenders_tpu_torch.data.dlrm_public_datasets import (
    DLRMv3KuaiRandDataset,
    DLRMv3MovieLensDataset,
)
from generative_recommenders_tpu_torch.modules.dlrm_hstu import DlrmHSTUConfig

DEFAULT_DATA_FILES = {
    # outputs of cli.preprocess_public_data / cli.preprocess_dlrm_data
    "movielens-1m": "data/ml-1m/sasrec_format.csv",
    "movielens-20m": "data/ml-20m/sasrec_format.csv",
    "kuairand-1k": "data/KuaiRand-1K/data/processed_seqs.csv",
}


def make_dlrm_batches(
    dataset: str,
    hstu_cfg: DlrmHSTUConfig,
    *,
    data_file: Optional[str] = None,
    hash_size: int = 10000,
    batch_size: int = 32,
    num_batches: Optional[int] = None,
    shuffle: bool = False,
    seed: int = 0,
    is_inference: bool = False,
) -> Iterator[Tuple]:
    """Yields (uih_features, uih_lengths, cand_features, num_candidates)
    numpy batches of the selected dataset."""
    if dataset == "debug":
        ds = DLRMv3RandomDataset(hstu_cfg, hash_size=hash_size, batch_size=batch_size, seed=seed)
        return ds.batches(num_batches or 1)
    data_file = data_file or DEFAULT_DATA_FILES[dataset]
    if not os.path.exists(data_file):
        raise FileNotFoundError(
            f"{data_file} not found — run the preprocess CLI first "
            "(cli.preprocess_public_data for movielens, "
            "cli.preprocess_dlrm_data for kuairand) or pass --data_file"
        )
    if dataset in ("movielens-1m", "movielens-20m"):
        ds = DLRMv3MovieLensDataset(hstu_cfg, ratings_file=data_file, is_inference=is_inference)
    else:
        ds = DLRMv3KuaiRandDataset(
            hstu_cfg, seq_logs_file=data_file, hash_sizes={"video_id": hash_size},
            is_inference=is_inference,
        )
    return ds.batches(batch_size, num_batches=num_batches, shuffle=shuffle, seed=seed)
