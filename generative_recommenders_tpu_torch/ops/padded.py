"""Padded-dense concat/split of merged [uih | candidates] sequences (port of
`generative_recommenders_tpu/ops/padded.py`).

Row layout: row b holds uih tokens at [0, uih_lengths[b]), candidates at
[uih_lengths[b], uih_lengths[b] + num_candidates[b]), zeros after.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def concat_tail(
    uih: torch.Tensor,  # [B, Nu, ...]
    uih_lengths: torch.Tensor,  # int[B]
    tail: torch.Tensor,  # [B, M, ...]
) -> torch.Tensor:
    """Appends the dense tail rows at each row's jagged end; [B, Nu + M, ...]."""
    B, M = uih.shape[0], tail.shape[1]
    pad = [0, 0] * (uih.dim() - 2) + [0, M]
    out = F.pad(uih, pad)
    rows = torch.arange(B, device=uih.device)[:, None]
    cols = uih_lengths.long()[:, None] + torch.arange(M, device=uih.device)[None, :]
    out[rows, cols] = tail.to(out.dtype)
    return out


def gather_tail(
    seq: torch.Tensor,  # [B, N, ...]
    uih_lengths: torch.Tensor,  # int[B]: the tail starts at uih_lengths[b]
    max_tail: int,
) -> torch.Tensor:
    """Gathers max_tail positions from each row's uih length on, with the
    indices clipped to the row."""
    B, N = seq.shape[:2]
    rows = torch.arange(B, device=seq.device)[:, None]
    cols = uih_lengths.long()[:, None] + torch.arange(max_tail, device=seq.device)[None, :]
    return seq[rows, cols.clamp(0, N - 1)]


def prepend_prefix(
    seq: torch.Tensor,  # [B, N, ...]
    prefix: torch.Tensor,  # [B, C, ...]: every row gets all C tokens
) -> torch.Tensor:
    """[B, C + N, ...] with the contextual tokens in front."""
    return torch.cat([prefix.to(seq.dtype), seq], dim=1)


def valid_mask(lengths: torch.Tensor, N: int) -> torch.Tensor:
    """bool[B, N]: position < length."""
    return torch.arange(N, device=lengths.device)[None, :] < lengths[:, None]
