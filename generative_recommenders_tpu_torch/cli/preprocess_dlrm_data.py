"""KuaiRand preprocessing for the DLRM-v3 ranker (the port's own copy of
`generative_recommenders_tpu/cli/preprocess_dlrm_data.py`, with numpy and the
`csv` module where the JAX package uses pandas; the output is the same): the
standard log files grouped per user (the sequence columns as lists, the files
joined on ``user_id``), the 8 interaction columns packed into one action
bitmask per event (``is_click`` = 1 ... ``is_profile_enter`` = 128), the user
range features coded 1, 2, ... in order of first appearance, all written to
`processed_seqs.csv` for `data/dlrm_public_datasets.DLRMv3KuaiRandDataset`.

    python -m generative_recommenders_tpu_torch.cli.preprocess_dlrm_data \\
        --dataset kuairand-1k --data_path tmp/ [--skip_download]
"""

from __future__ import annotations

import argparse
import csv
import logging
import math
import os
import tarfile
from typing import Dict, List, Optional
from urllib.request import urlretrieve

import numpy as np

from generative_recommenders_tpu_torch.data.preprocessor import read_csv_columns

logger = logging.getLogger(__name__)

SEQ_COLS = ["video_id", "time_ms", "action_weights", "play_time_ms", "duration_ms"]
USER_RANGE_COLS = [
    "user_active_degree",
    "follow_user_num_range",
    "fans_user_num_range",
    "friend_user_num_range",
    "register_days_range",
]


def get_feature_merge_weights(dataset: str = "debug") -> Dict[str, int]:
    if "kuairand" in dataset:
        return {
            "is_click": 1,
            "is_like": 2,
            "is_follow": 4,
            "is_comment": 8,
            "is_forward": 16,
            "is_hate": 32,
            "long_view": 64,
            "is_profile_enter": 128,
        }
    return {"dummy": 1}


def _dataset_files(dataset: str, data_path: str):
    prefix = "KuaiRand-1K" if "1k" in dataset else "KuaiRand-27K"
    root = os.path.join(data_path, prefix, "data")
    if "1k" in dataset:
        logs = [
            f"{root}/log_standard_4_08_to_4_21_1k.csv",
            f"{root}/log_standard_4_22_to_5_08_1k.csv",
        ]
        users = f"{root}/user_features_1k.csv"
    else:
        logs = [
            f"{root}/log_standard_4_08_to_4_21_27k_part1.csv",
            f"{root}/log_standard_4_08_to_4_21_27k_part2.csv",
            f"{root}/log_standard_4_22_to_5_08_27k_part1.csv",
            f"{root}/log_standard_4_22_to_5_08_27k_part2.csv",
        ]
        users = f"{root}/user_features_27k.csv"
    return logs, users, f"{root}/processed_seqs.csv"


def _cell(v) -> str:
    """A value as pandas writes it to csv: NaN as an empty cell."""
    return "" if isinstance(v, float) and math.isnan(v) else str(v)


def _per_user(log_file: str, weights: Dict[str, int]) -> Dict[int, Dict[str, list]]:
    """One log file's sequence columns as lists per user, the users in
    sorted order, each list in file order."""
    log = read_csv_columns(log_file)
    order = np.argsort(log["user_id"], kind="stable")
    users, starts = np.unique(log["user_id"][order], return_index=True)
    bounds = list(starts) + [len(order)]
    cols = {c: log[c][order] for c in SEQ_COLS if c != "action_weights"}
    # the action bitmask: each nonzero interaction column adds its weight
    packed = sum(np.where(log[e][order] == 0, 0, w) for e, w in weights.items())
    cols["action_weights"] = np.asarray(packed, dtype=np.int64)
    return {
        u: {c: cols[c][lo:hi].tolist() for c in SEQ_COLS}
        for u, lo, hi in zip(users.tolist(), bounds[:-1], bounds[1:])
    }


def preprocess_kuairand(
    dataset: str, data_path: str, log_files: Optional[List[str]] = None,
    user_features_file: Optional[str] = None, output_file: Optional[str] = None,
) -> str:
    """Writes `processed_seqs.csv` and returns its path."""
    files, users_f, out_f = _dataset_files(dataset, data_path)
    log_files = log_files or files
    user_features_file = user_features_file or users_f
    output_file = output_file or out_f
    weights = get_feature_merge_weights(dataset)

    seqs: Optional[Dict[int, Dict[str, list]]] = None
    for log_file in log_files:
        logger.info("processing %s", log_file)
        g = _per_user(log_file, weights)
        if seqs is None:
            seqs = g
        else:  # an inner join on user_id, the left's order kept
            seqs = {u: {c: s[c] + g[u][c] for c in SEQ_COLS} for u, s in seqs.items() if u in g}

    lens = [len(s["video_id"]) for s in seqs.values()]
    if lens:
        logger.info("seq len: max %d, min %d, mean %.1f", max(lens), min(lens), sum(lens) / len(lens))
    user_df = read_csv_columns(user_features_file)
    for col in USER_RANGE_COLS:
        mapping: Dict = {}
        for cat in user_df[col].tolist():
            mapping.setdefault(cat, len(mapping) + 1)
        user_df[col] = np.asarray([mapping[c] for c in user_df[col].tolist()], dtype=np.int64)
    user_cols = [c for c in user_df if c != "user_id"]
    user_rows: Dict[int, List[int]] = {}
    for i, u in enumerate(user_df["user_id"].tolist()):
        user_rows.setdefault(u, []).append(i)
    n = 0
    with open(output_file, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["user_id"] + SEQ_COLS + user_cols)
        for u, s in seqs.items():  # an inner join with the user features
            for i in user_rows.get(u, ()):
                w.writerow([u] + [s[c] for c in SEQ_COLS] + [_cell(user_df[c][i]) for c in user_cols])
                n += 1
    logger.info("wrote %s (%d users)", output_file, n)
    return output_file


def download_kuairand(dataset: str, data_path: str) -> None:
    """Fetches and unpacks the KuaiRand tarball unless its folder is there."""
    prefix = "KuaiRand-1K" if "1k" in dataset else "KuaiRand-27K"
    tar = os.path.join(data_path, f"{prefix}.tar.gz")
    if not os.path.exists(os.path.join(data_path, prefix)):
        if not os.path.exists(tar):
            os.makedirs(data_path, exist_ok=True)
            urlretrieve(f"https://zenodo.org/records/10439422/files/{prefix}.tar.gz", tar)
        with tarfile.open(tar, "r:*") as t:
            t.extractall(data_path, filter="data")


def main(argv: Optional[List[str]] = None) -> str:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="kuairand-1k", choices=["kuairand-1k", "kuairand-27k"])
    p.add_argument("--data_path", default="tmp/")
    p.add_argument("--skip_download", action="store_true")
    args = p.parse_args(argv)
    if not args.skip_download:
        download_kuairand(args.dataset, args.data_path)
    return preprocess_kuairand(args.dataset, args.data_path)
