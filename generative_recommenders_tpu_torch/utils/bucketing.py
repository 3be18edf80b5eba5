"""Sequence-length utilities of the research trainer (port of
`generative_recommenders_tpu/utils/bucketing.py`): stochastic length (the
paper's SL: long histories are cut to N^(alpha / 2) events with probability
1 - N^alpha / n^2) and length buckets (each batch sliced to the narrowest
bucket that holds its longest history).

`bucket_batch` works on the host batch (numpy in, numpy out). On the card a
narrower batch is a narrower launch: the attention kernels take the runtime
width and the position tables keep the model's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def apply_stochastic_length(
    lengths: torch.Tensor,  # int[B]
    alpha: float,
    max_seq_len: int,
    gen: torch.Generator,  # on the lengths' device
) -> torch.Tensor:
    """Rows longer than N^(alpha / 2) are cut to that threshold with
    probability 1 - N^alpha / n^2; the uniform draw comes from ``gen``."""
    threshold = int(max_seq_len ** (alpha / 2))
    no_sample_prob = (max_seq_len**alpha) / lengths.float().square()
    u = torch.rand(lengths.shape, generator=gen, device=lengths.device)
    sample = (lengths > threshold) & (u < 1.0 - no_sample_prob)
    return torch.where(sample, threshold, lengths).to(lengths.dtype)


def truncate_to_stochastic_length(
    ids: torch.Tensor,  # [B, N], chronological, left-aligned
    lengths: torch.Tensor,  # int[B]
    new_lengths: torch.Tensor,  # int[B], <= lengths
    extra_positions: int = 0,
) -> torch.Tensor:
    """Keeps each row's ``new_lengths`` most recent events, shifted to the
    front. ``extra_positions`` keeps that many slots past the new length:
    the timestamps carry the target's at position ``lengths``, which the
    shift moves to ``new_lengths``."""
    B, N = ids.shape
    pos = torch.arange(N, device=ids.device)[None, :]
    cols = (pos + (lengths - new_lengths).long()[:, None]).clamp(0, N - 1)
    gathered = torch.gather(ids, 1, cols)
    keep = pos < (new_lengths.long() + extra_positions)[:, None]
    return torch.where(keep, gathered, torch.zeros_like(gathered))


def prev_power_of_2(x: int) -> int:
    if x <= 1:
        return 1
    return 1 << (int(x).bit_length() - 1)


def next_power_of_2(x: int) -> int:
    if x <= 1:
        return 1
    return 1 << ((int(x) - 1).bit_length())


def autotune_max_seq_len(
    runtime_max_seq_len: int,
    static_max_seq_lens: Optional[Sequence[int]] = None,
    use_runtime: bool = False,
) -> int:
    """The bucket for a batch's longest history: the smallest static bucket
    that holds it (the largest if none does), or the previous power of 2 in
    runtime mode."""
    if use_runtime or not static_max_seq_lens:
        return prev_power_of_2(runtime_max_seq_len)
    for m in sorted(static_max_seq_lens):
        if m >= runtime_max_seq_len:
            return m
    return sorted(static_max_seq_lens)[-1]


def bucket_batch(
    batch: dict,
    static_max_seq_lens: Optional[Sequence[int]] = None,
    use_runtime: bool = False,
) -> dict:
    """Slices every [B, max_seq_len] array of a host batch to the smallest
    bucket that holds its longest history (the next power of 2 in runtime
    mode). Never cuts a real event: without a covering bucket the batch
    keeps its full width."""
    lengths = np.asarray(batch["history_lengths"])
    runtime = int(lengths.max()) if lengths.size else 1
    full = batch["historical_ids"].shape[1]
    if use_runtime or not static_max_seq_lens:
        width = min(next_power_of_2(runtime), full)
    else:
        covering = [m for m in sorted(static_max_seq_lens) if m >= runtime]
        width = min(covering[0], full) if covering else full
    if width >= full:
        return batch
    return {
        k: v[:, :width] if getattr(v, "ndim", 0) == 2 and v.shape[1] == full else v
        for k, v in batch.items()
    }
