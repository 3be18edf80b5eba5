"""Fractal-expansion synthetic dataset generator (ML-20M → ML-3B); the
port's own copy of `generative_recommenders_tpu/cli/run_fractal_expansion.py`,
reading its input with the `csv` module instead of pandas. It implements
algorithm 2 of arXiv:1901.08910 — SVD of the normalized rating matrix, graph reduction to a
small (R x C) "meta" matrix, then a randomized Kronecker expansion where
each meta-cell (i, j) contributes a row/col-shuffled, dropout-thinned copy
of the original rating matrix. Output: sharded CSV files
``<prefix>RxC_{i}.csv`` (rows: user_id, items, ratings) plus the
``<prefix>RxC_users.csv`` per-shard row-count index that
`data/dataset.py:MultiFileSequenceDataset` reads.

Differences: no skimage/sklearn dependency (bilinear resize + permutation
are numpy); everything else mirrors the reference's math.

    python -m generative_recommenders_tpu_torch.cli.run_fractal_expansion \
        --input-csv-file tmp/ml-20m/ratings.csv \
        --num-row-multiplier 16 --num-col-multiplier 32 \
        --write-dataset true --output-prefix tmp/ml-3b/
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import logging
import os
from typing import List, Optional, Tuple

import numpy as np
import scipy.linalg
from scipy import sparse
from scipy.sparse import linalg as slinalg

from generative_recommenders_tpu_torch.data.preprocessor import read_csv_columns

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class SparseMatrixMetadata:
    num_interactions: int = 0
    num_rows: int = 0
    num_cols: int = 0


def _resize_bilinear(m: np.ndarray, out_shape: Tuple[int, int]) -> np.ndarray:
    """skimage.transform.resize replacement (separable linear interp)."""

    def interp_axis(a: np.ndarray, n_out: int, axis: int) -> np.ndarray:
        n_in = a.shape[axis]
        if n_in == n_out:
            return a
        src = np.linspace(0, n_in - 1, n_out)
        lo = np.floor(src).astype(np.int64)
        hi = np.minimum(lo + 1, n_in - 1)
        frac = (src - lo).reshape(
            [-1 if i == axis else 1 for i in range(a.ndim)]
        )
        a_lo = np.take(a, lo, axis=axis)
        a_hi = np.take(a, hi, axis=axis)
        return a_lo * (1 - frac) + a_hi * frac

    return interp_axis(interp_axis(m, out_shape[0], 0), out_shape[1], 1)


def _dropout_sparse_coo(
    m: sparse.coo_matrix,
    rate: float,
    rng: np.random.Generator,
    min_dropout_rate: float = 0.005,
    max_dropout_rate: float = 0.999,
) -> sparse.coo_matrix:
    """Keep a (clipped) 1-rate fraction of the nonzeros
    (`run_fractal_expansion.py:60-86`)."""
    sampling_rate = 1.0 - rate
    frac = min(max(sampling_rate, 1.0 - max_dropout_rate), 1.0 - min_dropout_rate)
    num = min(max(int(m.nnz * frac), 1), m.nnz)
    idx = rng.choice(m.nnz, size=num, replace=False)
    return sparse.coo_matrix(
        (m.data[idx], (m.row[idx], m.col[idx])), shape=m.shape
    )


def shuffle_sparse_matrix(
    m: sparse.coo_matrix, dropout_rate: float, rng: np.random.Generator
) -> sparse.csr_matrix:
    """Independent row/col permutation + dropout (:88-107)."""
    num_rows, num_cols = m.shape
    m = _dropout_sparse_coo(m, dropout_rate, rng)
    new_row = rng.permutation(num_rows)[m.row]
    new_col = rng.permutation(num_cols)[m.col]
    return sparse.csr_matrix(
        (m.data, (new_row, new_col)), shape=(num_rows, num_cols)
    )


def graph_reduce(usv, num_rows: int, num_cols: int) -> np.ndarray:
    """Algorithm 2 of arXiv:1901.08910 (:109-124)."""

    def closest_orth(a: np.ndarray) -> np.ndarray:
        return a @ np.linalg.inv(scipy.linalg.sqrtm(a.T @ a)).real

    u, s, v = usv
    k = min(num_rows, num_cols)
    u_proj = _resize_bilinear(u[:, :k], (num_rows, k))
    v_proj = _resize_bilinear(v[:k, :], (k, num_cols))
    return closest_orth(u_proj) @ np.diag(s[:k]) @ closest_orth(v_proj.T).T


def rescale(m: np.ndarray, element_sample_rate: float = 1.0) -> np.ndarray:
    out = (m - m.min()) / (m.max() - m.min())
    return out * element_sample_rate


def build_randomized_kronecker(
    left_matrix: np.ndarray,  # [R, C] sampling rates in [0, 1]
    right_matrix: sparse.coo_matrix,  # original ratings [U, I]
    output_prefix: str,
    block_sample_rate: float = 1.0,
    seed: int = 0,
    remove_empty_rows: bool = True,
) -> SparseMatrixMetadata:
    """One shard per left-matrix row i: vstack over j of shuffled thinned
    copies; columns offset by j*I; rows get global user ids
    (:130-258). Also writes the `<prefix>_users.csv` shard index."""
    R, C = left_matrix.shape
    U, I = right_matrix.shape
    rng = np.random.default_rng(seed)
    total = SparseMatrixMetadata(num_cols=C * I)
    shard_rows = []
    os.makedirs(os.path.dirname(output_prefix) or ".", exist_ok=True)
    for i in range(R):
        blocks = []
        for j in range(C):
            if rng.random() <= block_sample_rate:
                blocks.append(
                    shuffle_sparse_matrix(
                        right_matrix, 1.0 - left_matrix[i, j], rng
                    )
                )
            else:
                blocks.append(sparse.csr_matrix((U, I)))
        rows = sparse.hstack(blocks).tocsr()
        n_written = 0
        with open(f"{output_prefix}_{i}.csv", "w", newline="") as f:
            writer = csv.writer(f)
            for k in range(U):
                row = rows.getrow(k)
                if remove_empty_rows and row.nnz == 0:
                    continue
                writer.writerow(
                    [
                        i * U + k,
                        ",".join(str(x) for x in row.indices),
                        ",".join(str(x) for x in row.data),
                    ]
                )
                n_written += 1
                total.num_interactions += row.nnz
        shard_rows.append(n_written)
        total.num_rows += n_written
        logger.info(
            "shard %d/%d: %d rows, cumulative %d interactions",
            i + 1, R, n_written, total.num_interactions,
        )
    with open(f"{output_prefix}_users.csv", "w", newline="") as f:
        writer = csv.writer(f)
        for i, n in enumerate(shard_rows):
            writer.writerow([i, n])
    return total


def _normalize(m: sparse.csr_matrix) -> sparse.csr_matrix:
    """L2 row normalization (sklearn.preprocessing.normalize analogue)."""
    norms = np.sqrt(np.asarray(m.multiply(m).sum(axis=1)).ravel())
    norms[norms == 0] = 1.0
    inv = sparse.diags(1.0 / norms)
    return inv @ m


def run_expansion(
    input_csv_file: str,
    output_prefix: str,
    num_row_multiplier: int,
    num_col_multiplier: int,
    element_sample_rate: float = 1.0,
    block_sample_rate: float = 1.0,
    write_dataset: bool = True,
    seed: int = 0,
) -> Optional[SparseMatrixMetadata]:
    df = read_csv_columns(input_csv_file)
    cols = {c.lower(): c for c in df}
    uid = df[cols.get("userid", cols.get("user_id"))]
    iid = df[cols.get("movieid", cols.get("movie_id", cols.get("item_id")))]
    rating = df[cols.get("rating")]
    # compact ids
    uid = np.unique(uid, return_inverse=True)[1]
    iid = np.unique(iid, return_inverse=True)[1]
    U, I = uid.max() + 1, iid.max() + 1
    ratings_matrix = sparse.csr_matrix(
        (rating.astype(np.float32), (uid, iid)), shape=(U, I)
    )
    R, C = num_row_multiplier, num_col_multiplier
    k = min(R, C)
    logger.info("SVD of %dx%d rating matrix (k=%d)", U, I, k)
    u, s, v = slinalg.svds(_normalize(ratings_matrix), k=k)
    reduced = graph_reduce((u, s, v), R, C)
    reduced = rescale(reduced, element_sample_rate)
    est = reduced.sum() * ratings_matrix.nnz * block_sample_rate
    logger.info(
        "reduced matrix mean %.4f; expected synthetic samples %.3g "
        "(avg seqlen %.1f)",
        reduced.mean(), est, est / (U * R),
    )
    if not write_dataset:
        return None
    out = f"{output_prefix}{R}x{C}"
    return build_randomized_kronecker(
        reduced, ratings_matrix.tocoo(), out,
        block_sample_rate=block_sample_rate, seed=seed,
    )


def main(argv: Optional[List[str]] = None) -> Optional[SparseMatrixMetadata]:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--input-csv-file", required=True)
    p.add_argument("--output-prefix", default="")
    p.add_argument("--num-row-multiplier", type=int, default=16)
    p.add_argument("--num-col-multiplier", type=int, default=32)
    p.add_argument("--element-sample-rate", type=float, default=1.0)
    p.add_argument("--block-sample-rate", type=float, default=1.0)
    p.add_argument("--write-dataset", type=lambda s: s.lower() == "true", default=True)
    p.add_argument("--random-seed", type=int, default=0)
    args = p.parse_args(argv)
    return run_expansion(
        args.input_csv_file,
        args.output_prefix,
        args.num_row_multiplier,
        args.num_col_multiplier,
        args.element_sample_rate,
        args.block_sample_rate,
        args.write_dataset,
        args.random_seed,
    )


if __name__ == "__main__":
    main()
