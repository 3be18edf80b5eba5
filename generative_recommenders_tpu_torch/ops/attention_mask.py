"""HSTU attention validity masks (port of
`generative_recommenders_tpu/ops/attention_mask.py`).

Semantics: causal with the diagonal always valid; target-aware clamping of
the last ``num_targets[b]`` positions (candidates see the whole history but
not each other); an optional ``max_attn_len`` window with a
``min_full_attn_seq_len`` recent full-attention band; ``contextual_seq_len``
prefix rows that attend to, and are attended by, the whole sequence. The
CUDA kernels (`csrc/hstu_attention.cuh`, ``valid_elem``) apply the same
rules one element at a time.
"""

from __future__ import annotations

from typing import Optional

import torch


def make_valid_attn_mask(
    N: int,
    seq_lengths: torch.Tensor,  # int[B]
    causal: bool = True,
    num_targets: Optional[torch.Tensor] = None,  # int[B]
    max_attn_len: int = 0,
    contextual_seq_len: int = 0,
    min_full_attn_seq_len: int = 0,
) -> torch.Tensor:
    """bool[B, N, N]; entry [b, i, j] is True iff query i may attend key j."""
    B = seq_lengths.shape[0]
    dev = seq_lengths.device
    ids = torch.arange(N, device=dev, dtype=torch.int32)[None, :]  # [1, N]
    max_ids = seq_lengths.reshape(B, 1, 1).to(torch.int32)
    if contextual_seq_len > 0:
        ids = (ids - contextual_seq_len + 1).clamp_min(0)
        max_ids = max_ids - contextual_seq_len + 1
    if num_targets is not None:
        max_ids = max_ids - num_targets.reshape(B, 1, 1).to(torch.int32)
        ids_b = torch.minimum(ids[:, None, :], max_ids)  # [B, 1, N]
        row_ids = ids_b.transpose(1, 2).expand(B, N, N)
        col_ids = ids_b.expand(B, N, N)
    else:
        row_ids = ids.reshape(1, N, 1).expand(B, N, N)
        col_ids = ids.reshape(1, 1, N).expand(B, N, N)
    dist = row_ids - col_ids
    if not causal:
        dist = dist.abs()
    valid = torch.eye(N, dtype=torch.bool, device=dev)[None] | (dist > 0)
    if max_attn_len > 0:
        window = dist <= max_attn_len
        if min_full_attn_seq_len > 0:
            window = window | (row_ids >= max_ids - min_full_attn_seq_len)
        valid = valid & window
    if contextual_seq_len > 0:
        valid = valid | ((row_ids == 0) & (col_ids < max_ids))
    return valid


def apply_padding_guard(
    valid: torch.Tensor,  # bool[B, N, N]
    seq_lengths: torch.Tensor,  # int[B]
) -> torch.Tensor:
    """ANDs the mask with row < length and col < length: in the padded
    layout the pad positions hold real projections and must be masked."""
    B, N, _ = valid.shape
    pos = torch.arange(N, device=valid.device)
    lens = seq_lengths.reshape(B, 1, 1)
    return valid & (pos[None, None, :] < lens) & (pos[None, :, None] < lens)


def make_delta_attn_mask(
    N: int,
    seq_lengths: torch.Tensor,  # int[B]: full (cache + delta) lengths
    row_positions: torch.Tensor,  # int[B, M]: absolute query positions
    causal: bool = True,
    num_targets: Optional[torch.Tensor] = None,
    max_attn_len: int = 0,
    contextual_seq_len: int = 0,
    min_full_attn_seq_len: int = 0,
) -> torch.Tensor:
    """Rows ``row_positions[b, m]`` of `make_valid_attn_mask`, built directly
    as bool[B, M, N] (the M-FALCON delta path needs only the M newest rows)."""
    B, M = row_positions.shape
    dev = row_positions.device
    cols = torch.arange(N, device=dev, dtype=torch.int32)[None, None, :]
    rows_raw = row_positions.to(torch.int32)[:, :, None]  # [B, M, 1]
    max_ids = seq_lengths.reshape(B, 1, 1).to(torch.int32)
    rows, col_ids = rows_raw, cols
    if contextual_seq_len > 0:
        rows = (rows - contextual_seq_len + 1).clamp_min(0)
        col_ids = (cols - contextual_seq_len + 1).clamp_min(0)
        max_ids = max_ids - contextual_seq_len + 1
    if num_targets is not None:
        max_ids = max_ids - num_targets.reshape(B, 1, 1).to(torch.int32)
        rows = torch.minimum(rows, max_ids)
        col_ids = torch.minimum(col_ids, max_ids)
    dist = rows - col_ids
    if not causal:
        dist = dist.abs()
    valid = (dist > 0) | (rows_raw == cols)
    if max_attn_len > 0:
        window = dist <= max_attn_len
        if min_full_attn_seq_len > 0:
            window = window | (rows >= max_ids - min_full_attn_seq_len)
        valid = valid & window
    if contextual_seq_len > 0:
        valid = valid | ((rows == 0) & (col_ids < max_ids))
    return valid
