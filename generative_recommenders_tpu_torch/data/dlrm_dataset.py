"""Random batches for the DlrmHSTU ranker (port of
`generative_recommenders_tpu/data/dlrm_dataset.py`): the same numpy draws
from the same seed. Batches are dicts of padded numpy arrays:

  uih_features:        {name: [B, max_uih_len]}    + uih_lengths int[B]
  candidates_features: {name: [B, max_num_candidates]} + num_candidates int[B]

The debug-config feature set, with lognormal-ish uih lengths.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

from generative_recommenders_tpu_torch.modules.dlrm_hstu import DlrmHSTUConfig


class DLRMv3RandomDataset:

    def __init__(
        self,
        cfg: DlrmHSTUConfig,
        hash_size: int,
        batch_size: int,
        seed: int = 0,
    ) -> None:
        self._cfg = cfg
        self._hash = hash_size
        self._B = batch_size
        self._rng = np.random.default_rng(seed)

    def _sparse_lengths(self, max_len: int) -> np.ndarray:
        r = self._rng
        lens = np.minimum(
            np.exp(r.normal(np.log(max_len) - 1.0, 0.8, self._B)), max_len
        ).astype(np.int32)
        return np.maximum(lens, 1)

    def batch(self) -> Tuple[Dict[str, np.ndarray], np.ndarray, Dict[str, np.ndarray], np.ndarray]:
        cfg, r, B = self._cfg, self._rng, self._B
        Nu, M = cfg.max_uih_len, cfg.max_num_candidates
        uih_lengths = self._sparse_lengths(Nu)
        num_candidates = np.minimum(
            r.integers(1, M + 1, B).astype(np.int32), M
        )
        uih_mask = np.arange(Nu)[None, :] < uih_lengths[:, None]
        cand_mask = np.arange(M)[None, :] < num_candidates[:, None]

        def ids(n, mask):
            x = r.integers(0, self._hash, (B, n)).astype(np.int32)
            return np.where(mask, x, 0)

        ts = np.sort(
            r.integers(1, 1 << 20, (B, Nu)).astype(np.int32), axis=1
        )
        ts = np.where(uih_mask, ts, 0)
        query_time = ts.max(axis=1, keepdims=True) + 1
        uih_features = {
            "uih_post_id": ids(Nu, uih_mask),
            "uih_owner_id": ids(Nu, uih_mask),
            "uih_action_time": ts,
            "uih_weight": np.where(
                uih_mask, r.integers(0, 16, (B, Nu)), 0
            ).astype(np.int32),
            "uih_watchtime": np.where(
                uih_mask, r.integers(0, 600, (B, Nu)), 0
            ).astype(np.int32),
            "viewer_id": ids(1, np.ones((B, 1), bool)),
            "dummy_contexual": ids(1, np.ones((B, 1), bool)),
        }
        candidates_features = {
            "item_post_id": ids(M, cand_mask),
            "item_owner_id": ids(M, cand_mask),
            "item_query_time": np.where(cand_mask, query_time, 0).astype(
                np.int32
            ),
            "item_action_weight": np.where(
                cand_mask, r.integers(0, 16, (B, M)), 0
            ).astype(np.int32),
            "item_target_watchtime": np.where(
                cand_mask, r.integers(0, 600, (B, M)), 0
            ).astype(np.int32),
        }
        return uih_features, uih_lengths, candidates_features, num_candidates

    def batches(self, n: int) -> Iterator[Tuple]:
        for _ in range(n):
            yield self.batch()
