"""Jagged tensors in plain PyTorch (port of
`generative_recommenders_tpu/ops/jagged.py`).

A jagged tensor is ``(values, offsets)``: ``values`` [L, ...] with a fixed
capacity L (typically B * max_len) and ``offsets`` int[B + 1], the exclusive
scan of the rows' lengths. Slots past ``offsets[-1]`` are padding: the ops
here write zeros there and ignore what they read there. Every op is a gather,
a scatter or one matmul over the padded layout, as the JAX package leaves
them to XLA; no kernel of ours serves them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class JaggedTensor(NamedTuple):
    """values: [L, ...] with capacity L; offsets: int[B + 1]."""

    values: torch.Tensor
    offsets: torch.Tensor

    @property
    def num_rows(self) -> int:
        return self.offsets.shape[0] - 1

    def lengths(self) -> torch.Tensor:
        return self.offsets[1:] - self.offsets[:-1]


def lengths_to_offsets(lengths: torch.Tensor) -> torch.Tensor:
    """int32[B + 1] offsets from lengths [B] (an exclusive scan)."""
    lengths = lengths.to(torch.int32)
    return torch.cat([lengths.new_zeros(1), torch.cumsum(lengths, 0, dtype=torch.int32)])


def offsets_to_lengths(offsets: torch.Tensor) -> torch.Tensor:
    return offsets[1:] - offsets[:-1]


def row_ids_from_offsets(offsets: torch.Tensor, total: int) -> torch.Tensor:
    """For each slot l in [0, total) the row b with offsets[b] <= l <
    offsets[b + 1]; slots >= offsets[-1] map to B - 1. int64."""
    slot = torch.arange(total, device=offsets.device)
    b = torch.searchsorted(offsets.long(), slot, right=True) - 1
    return b.clamp(0, offsets.shape[0] - 2)


def _bcast(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return mask.reshape(tuple(mask.shape) + (1,) * (ndim - mask.dim()))


def jagged_to_padded_dense(
    values: torch.Tensor, offsets: torch.Tensor, max_len: int, padding_value: float = 0.0
) -> torch.Tensor:
    """[L, ...] jagged -> [B, max_len, ...]: shorter rows padded with
    ``padding_value``, longer ones cut."""
    L = values.shape[0]
    off = offsets.long()
    pos = torch.arange(max_len, device=values.device)[None, :]
    src = (off[:-1, None] + pos).clamp(0, max(L - 1, 0))
    valid = pos < (off[1:] - off[:-1])[:, None]
    gathered = values[src]  # [B, max_len, ...]
    fill = torch.full((), padding_value, dtype=values.dtype, device=values.device)
    return torch.where(_bcast(valid, gathered.dim()), gathered, fill)


def dense_to_jagged(
    dense: torch.Tensor, offsets: torch.Tensor, total: Optional[int] = None
) -> torch.Tensor:
    """[B, N, ...] dense -> [total, ...] jagged values (default capacity
    B * N), zeros past ``offsets[-1]``."""
    B, N = dense.shape[:2]
    total = B * N if total is None else total
    off = offsets.long()
    b = row_ids_from_offsets(offsets, total)
    slot = torch.arange(total, device=dense.device)
    n = (slot - off[b]).clamp(0, N - 1)
    idx = (b * N + n).clamp(0, B * N - 1)
    out = dense.reshape((B * N,) + tuple(dense.shape[2:]))[idx]
    return torch.where(_bcast(slot < off[-1], out.dim()), out, torch.zeros((), dtype=out.dtype, device=out.device))


def concat_2D_jagged(
    values_left: torch.Tensor,
    offsets_left: torch.Tensor,
    values_right: torch.Tensor,
    offsets_right: torch.Tensor,
    total: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row b of the output is row b of the left tensor followed by row b of
    the right one. Returns (values, offsets)."""
    if total is None:
        total = values_left.shape[0] + values_right.shape[0]
    off_l, off_r = offsets_left.long(), offsets_right.long()
    len_l = off_l[1:] - off_l[:-1]
    out_offsets = lengths_to_offsets(len_l + (off_r[1:] - off_r[:-1]))
    b = row_ids_from_offsets(out_offsets, total)
    slot = torch.arange(total, device=values_left.device)
    pos = slot - out_offsets.long()[b]
    from_left = pos < len_l[b]
    idx_l = (off_l[b] + pos).clamp(0, values_left.shape[0] - 1)
    idx_r = (off_r[b] + pos - len_l[b]).clamp(0, values_right.shape[0] - 1)
    out = torch.where(from_left[:, None], values_left[idx_l], values_right[idx_r])
    valid = slot < out_offsets.long()[-1]
    return torch.where(valid[:, None], out, torch.zeros((), dtype=out.dtype, device=out.device)), out_offsets


def split_2D_jagged(
    values: torch.Tensor,
    offsets: torch.Tensor,
    offsets_left: torch.Tensor,
    offsets_right: torch.Tensor,
    total_left: int,
    total_right: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inverse of `concat_2D_jagged`: row b holds len_l[b] left slots,
    then len_r[b] right ones; returns the two value tensors."""
    off = offsets.long()
    len_l = offsets_left.long()[1:] - offsets_left.long()[:-1]

    def gather(out_offsets: torch.Tensor, extra: torch.Tensor, total: int) -> torch.Tensor:
        out_off = out_offsets.long()
        b = row_ids_from_offsets(out_offsets, total)
        slot = torch.arange(total, device=values.device)
        src = (off[b] + extra[b] + slot - out_off[b]).clamp(0, values.shape[0] - 1)
        out = values[src]
        return torch.where((slot < out_off[-1])[:, None], out, torch.zeros((), dtype=out.dtype, device=out.device))

    return gather(offsets_left, torch.zeros_like(len_l), total_left), gather(offsets_right, len_l, total_right)


def concat_2D_jagged_dense_first(
    dense_left: torch.Tensor,  # [B, P, D]
    values_right: torch.Tensor,
    offsets_right: torch.Tensor,
    total: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A fixed-width dense prefix [B, P, D] followed by a jagged suffix."""
    B, P, D = dense_left.shape
    left_offsets = torch.arange(B + 1, dtype=torch.int32, device=dense_left.device) * P
    return concat_2D_jagged(dense_left.reshape(B * P, D), left_offsets, values_right, offsets_right, total)


def jagged_dense_bmm_broadcast_add(
    values: torch.Tensor,  # [L, D]
    offsets: torch.Tensor,
    dense: torch.Tensor,  # [B, D, K]
    bias: Optional[torch.Tensor] = None,  # [B, K]
    max_len: Optional[int] = None,
) -> torch.Tensor:
    """Row b's values times dense[b] (+ bias[b]), through one padded batched
    matmul in float32; jagged [L, K]."""
    B = offsets.shape[0] - 1
    if max_len is None:
        max_len = max(values.shape[0] // max(B, 1), 1)
    padded = jagged_to_padded_dense(values, offsets, max_len)
    out = torch.einsum("bnd,bdk->bnk", padded.float(), dense.float()).to(values.dtype)
    if bias is not None:
        out = out + bias[:, None, :].to(out.dtype)
    return dense_to_jagged(out, offsets, total=values.shape[0])


def jagged_reduce_sum(values: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """The sum of each row's values -> [B, ...]."""
    total = values.shape[0]
    b = row_ids_from_offsets(offsets, total)
    valid = torch.arange(total, device=values.device) < offsets.long()[-1]
    masked = torch.where(_bcast(valid, values.dim()), values, torch.zeros((), dtype=values.dtype, device=values.device))
    out = values.new_zeros((offsets.shape[0] - 1,) + tuple(values.shape[1:]))
    return out.index_add(0, b, masked)


def jagged_boolean_mask_lengths(lengths: torch.Tensor, keep: torch.Tensor, max_len: int) -> torch.Tensor:
    """The rows' lengths after dropping the positions where the dense
    ``keep`` [B, max_len] is false."""
    valid = torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]
    return (keep.bool() & valid).sum(dim=1).to(torch.int32)
