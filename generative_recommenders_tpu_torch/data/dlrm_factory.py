"""DLRM dataset selection for the serving CLI (port of the debug branch of
`generative_recommenders_tpu/data/dlrm_factory.py`). The real-dataset
loaders (movielens, kuairand) are still to port."""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

from generative_recommenders_tpu_torch.data.dlrm_dataset import DLRMv3RandomDataset
from generative_recommenders_tpu_torch.modules.dlrm_hstu import DlrmHSTUConfig


def make_dlrm_batches(
    dataset: str,
    hstu_cfg: DlrmHSTUConfig,
    *,
    hash_size: int = 10000,
    batch_size: int = 32,
    num_batches: Optional[int] = None,
    seed: int = 0,
) -> Iterator[Tuple]:
    """Yields (uih_features, uih_lengths, cand_features, num_candidates)
    numpy batches."""
    if dataset != "debug":
        raise NotImplementedError(
            f"dataset {dataset!r}: only the random 'debug' dataset is ported"
        )
    ds = DLRMv3RandomDataset(hstu_cfg, hash_size=hash_size, batch_size=batch_size, seed=seed)
    return ds.batches(num_batches or 1)
