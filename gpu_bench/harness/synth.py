"""Inputs made from the seed: the research corpus and the ranker's request
batches. The arithmetic is copied from the port's generators
(`data/dataset.py:synthetic_user_sequences_vectorized`,
`data/dlrm_dataset.py:DLRMv3RandomDataset`), so that a later change to the
program cannot change the yardstick; the traffic file sets every size.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Callable, Dict, List, Tuple

import numpy as np


def stratified(rng: np.random.Generator, n: int, ppf: Callable[[float], float]) -> np.ndarray:
    """``n`` draws of a distribution given by its quantile function, one from
    each of n equal slices of probability, in an order drawn from ``rng``:
    every seed gets the same sizes, in another order, so that the seed does
    not change the amount of work."""
    return rng.permutation(np.array([ppf((i + 0.5) / n) for i in range(n)]))


def _uniform_int(lo: int, hi: int) -> Callable[[float], float]:
    """The quantile function of the integers uniform in [lo, hi]."""
    return lambda u: lo + min(int(u * (hi - lo + 1)), hi - lo)


@dataclasses.dataclass
class Corpus:
    """Chronological event sequences, one per user."""

    user_ids: np.ndarray  # int64[U]
    item_ids: List[np.ndarray]
    ratings: List[np.ndarray]
    timestamps: List[np.ndarray]


def research_corpus(
    num_users: int, num_items: int, max_len: int, min_len: int, latent_dim: int, seed: int,
    device: str = "cpu",
) -> Corpus:
    """Latent-factor sequences: every user advances one step per pass, each
    step a Gumbel-max draw over 64 candidates uniform over the whole table;
    lengths uniform in [min_len, max_len] (stratified: the same lengths for
    every seed). Drawn on ``device`` from a generator seeded with ``seed``,
    then copied to the host."""
    import torch

    g = torch.Generator(device).manual_seed(seed)
    U = num_users

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=device)

    z = torch.randn((num_items + 1, latent_dim), generator=g, device=device)
    z[0] = 0.0
    lengths = torch.as_tensor(
        stratified(np.random.default_rng(seed), U, _uniform_int(min_len, max_len)), device=device
    )
    uvec = torch.randn((U, latent_dim), generator=g, device=device)
    prev = torch.zeros((U, latent_dim), device=device)
    seq = torch.zeros((U, max_len), dtype=torch.int64, device=device)
    rows = torch.arange(U, device=device)
    for i in range(max_len):
        active = lengths > i
        cands = ints(1, num_items + 1, (U, 64))
        logits = torch.bmm(z[cands], (uvec + 0.5 * prev)[:, :, None])[:, :, 0]
        u = torch.rand((U, 64), generator=g, device=device)
        gumbel = -torch.log(-torch.log(u + 1e-12) + 1e-12)
        pick = cands[rows, torch.argmax(logits + gumbel, dim=1)]
        seq[:, i] = torch.where(active, pick, 0)
        prev = torch.where(active[:, None], z[pick], prev)
    base = ints(1_000_000_000, 1_100_000_000, (U, 1))
    ratings = ints(1, 6, (U, max_len)).cpu().numpy()
    ts = (base + torch.cumsum(ints(60, 86400, (U, max_len)), dim=1)).cpu().numpy()
    seq = seq.cpu().numpy()
    n = [int(x) for x in lengths.cpu()]
    return Corpus(
        user_ids=np.arange(1, U + 1, dtype=np.int64),
        item_ids=[seq[u, : n[u]].copy() for u in range(U)],
        ratings=[ratings[u, : n[u]].copy() for u in range(U)],
        timestamps=[ts[u, : n[u]].copy() for u in range(U)],
    )


def epoch_order(num_rows: int, seed: int) -> np.ndarray:
    """The rows of one shuffled epoch, as the port's batch iterators order
    them for ``seed``."""
    order = np.arange(num_rows)
    np.random.default_rng(seed).shuffle(order)
    return order


def _zipf_rows(rng: np.random.Generator, shape, rows: int, a: float) -> np.ndarray:
    """Ids with a bounded power law of exponent ``a`` over ``rows`` rows (rank
    r drawn with weight r^-a by the inverse of the continuous CDF), ranks
    scattered over the rows by a fixed odd multiplier."""
    u = rng.random(shape)
    e = 1.0 - a
    rank = np.floor(((float(rows) ** e - 1.0) * u + 1.0) ** (1.0 / e)).astype(np.int64) - 1
    rank = np.clip(rank, 0, rows - 1)
    return (rank * 2654435761) % rows


RankerBatch = Tuple[Dict[str, np.ndarray], np.ndarray, Dict[str, np.ndarray], np.ndarray]


def ranker_batches(rng: np.random.Generator, t: dict, rows: int, n: int) -> List[RankerBatch]:
    """``n`` request batches of the ranker's debug feature set, ``t["batch"]``
    users each. Over all n x batch users the uih lengths are the strata of
    exp(N(ln L - 1, 0.8)) capped at L = ``max_uih_len`` and the candidate
    counts those of the uniform [1, ``max_num_candidates``], in an order
    drawn from ``rng`` (the same work for every seed). Post and owner ids
    follow the power law ``t["zipf_a"]`` over ``rows``, the contextual ids are
    uniform; action weights, watch times and sorted timestamps as the port's
    random dataset draws them."""
    B, Nu, M = t["batch"], t["max_uih_len"], t["max_num_candidates"]
    normal = statistics.NormalDist(np.log(Nu) - 1.0, 0.8)
    uih_all = stratified(rng, n * B, lambda u: max(1, min(int(np.exp(normal.inv_cdf(u))), Nu)))
    cand_all = stratified(rng, n * B, _uniform_int(1, M))
    return [
        _ranker_batch(rng, t, rows, uih_all[i * B : (i + 1) * B], cand_all[i * B : (i + 1) * B]) for i in range(n)
    ]


def _ranker_batch(rng, t, rows, uih_lengths, num_candidates) -> RankerBatch:
    B, Nu, M = t["batch"], t["max_uih_len"], t["max_num_candidates"]
    uih_lengths = uih_lengths.astype(np.int32)
    num_candidates = num_candidates.astype(np.int32)
    uih_mask = np.arange(Nu)[None, :] < uih_lengths[:, None]
    cand_mask = np.arange(M)[None, :] < num_candidates[:, None]

    def skewed(n, mask):
        return np.where(mask, _zipf_rows(rng, (B, n), rows, t["zipf_a"]), 0).astype(np.int32)

    def uniform(n):
        return rng.integers(0, rows, (B, n)).astype(np.int32)

    ts = np.sort(rng.integers(1, 1 << 20, (B, Nu)).astype(np.int32), axis=1)
    ts = np.where(uih_mask, ts, 0)
    query_time = ts.max(axis=1, keepdims=True) + 1
    uih = {
        "uih_post_id": skewed(Nu, uih_mask),
        "uih_owner_id": skewed(Nu, uih_mask),
        "uih_action_time": ts,
        "uih_weight": np.where(uih_mask, rng.integers(0, 16, (B, Nu)), 0).astype(np.int32),
        "uih_watchtime": np.where(uih_mask, rng.integers(0, 600, (B, Nu)), 0).astype(np.int32),
        "viewer_id": uniform(1),
        "dummy_contexual": uniform(1),
    }
    cands = {
        "item_post_id": skewed(M, cand_mask),
        "item_owner_id": skewed(M, cand_mask),
        "item_query_time": np.where(cand_mask, query_time, 0).astype(np.int32),
        "item_action_weight": np.where(cand_mask, rng.integers(0, 16, (B, M)), 0).astype(np.int32),
        "item_target_watchtime": np.where(cand_mask, rng.integers(0, 600, (B, M)), 0).astype(np.int32),
    }
    return uih, uih_lengths, cands, num_candidates
