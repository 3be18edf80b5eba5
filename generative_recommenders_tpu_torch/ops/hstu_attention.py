"""Jagged HSTU attention (port of
`generative_recommenders_tpu/ops/xla/hstu_attention.py`).

The jagged entry points of the reference's dispatcher over ``(values,
offsets)``: `hstu_mha` and the delta-query `delta_hstu_mha`. Each pads the
jagged rows to ``max_seq_len``, attends, and gathers the rows back. The
attention goes through the kernel wrappers of `ops/cuda/hstu_attention.py`,
which launch K1 (`hstu_mha_dense_cuda`) and K5 (`delta_hstu_mha_cuda`) on
CUDA tensors and run their plain versions on CPU ones. `hstu_mha` with
attention dropout runs the plain composite (`hstu_mha_dense`) on either
device: no kernel has dropout, as no Pallas kernel has it.
"""

from __future__ import annotations

from typing import Optional

import torch

from generative_recommenders_tpu_torch.ops.attention_mask import make_valid_attn_mask
from generative_recommenders_tpu_torch.ops.cuda.hstu_attention import (
    delta_hstu_mha_cuda,
    hstu_mha_dense,
    hstu_mha_dense_cuda,
)
from generative_recommenders_tpu_torch.ops.jagged import (
    dense_to_jagged,
    jagged_to_padded_dense,
    offsets_to_lengths,
)

__all__ = ["delta_hstu_mha", "hstu_mha", "hstu_mha_dense"]


def hstu_mha(
    max_seq_len: int,
    alpha: float,
    q: torch.Tensor,  # jagged [L, H, D]
    k: torch.Tensor,  # jagged [L, H, D]
    v: torch.Tensor,  # jagged [L, H, V]
    seq_offsets: torch.Tensor,  # int[B + 1]
    causal: bool = True,
    num_targets: Optional[torch.Tensor] = None,
    max_attn_len: int = 0,
    contextual_seq_len: int = 0,
    min_full_attn_seq_len: int = 0,
    dropout_pr: float = 0.0,
    dropout_gen: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Jagged HSTU attention, normalised by ``max_seq_len``; jagged [L, H, V]
    (zeros past ``seq_offsets[-1]``)."""
    L, H, D = q.shape
    V = v.shape[2]
    B = seq_offsets.shape[0] - 1
    pad = lambda t, d: jagged_to_padded_dense(t.reshape(L, H * d), seq_offsets, max_seq_len).reshape(  # noqa: E731
        B, max_seq_len, H, d
    )
    pq, pk, pv = pad(q, D), pad(k, D), pad(v, V)
    lengths = offsets_to_lengths(seq_offsets)
    if dropout_pr > 0.0:
        mask = make_valid_attn_mask(
            max_seq_len, lengths, causal=causal, num_targets=num_targets,
            max_attn_len=max_attn_len, contextual_seq_len=contextual_seq_len,
            min_full_attn_seq_len=min_full_attn_seq_len,
        )
        out = hstu_mha_dense(
            pq, pk, pv, alpha=alpha, max_seq_len=max_seq_len, mask=mask,
            dropout_pr=dropout_pr, dropout_gen=dropout_gen,
        )
    else:
        out = hstu_mha_dense_cuda(
            pq, pk, pv, lengths, alpha=alpha, max_seq_len=max_seq_len, causal=causal,
            num_targets=num_targets, max_attn_len=max_attn_len,
            contextual_seq_len=contextual_seq_len, min_full_attn_seq_len=min_full_attn_seq_len,
        )
    return dense_to_jagged(out.reshape(B, max_seq_len, H * V), seq_offsets, total=L).reshape(L, H, V)


def delta_hstu_mha(
    max_seq_len: int,
    alpha: float,
    delta_q: torch.Tensor,  # [B * M, H, D]: the M newest queries of each row
    k: torch.Tensor,  # jagged [L, H, D]: the full keys, cache included
    v: torch.Tensor,  # jagged [L, H, V]
    seq_offsets: torch.Tensor,  # int[B + 1]: offsets of the full sequences
    num_targets: Optional[torch.Tensor] = None,
    max_attn_len: int = 0,
    contextual_seq_len: int = 0,
) -> torch.Tensor:
    """Delta-query attention: row b's M queries sit at positions [len_b - M,
    len_b) and attend over its full keys under the full mask, normalised by
    ``max_seq_len``. Returns [B * M, H, V]."""
    B = seq_offsets.shape[0] - 1
    _, H, D = delta_q.shape
    V = v.shape[2]
    M = delta_q.shape[0] // B
    L = k.shape[0]
    full_k = jagged_to_padded_dense(k.reshape(L, H * D), seq_offsets, max_seq_len)
    full_v = jagged_to_padded_dense(v.reshape(L, H * V), seq_offsets, max_seq_len)
    out = delta_hstu_mha_cuda(
        delta_q.reshape(B, M, H, D), full_k.reshape(B, max_seq_len, H, D),
        full_v.reshape(B, max_seq_len, H, V), offsets_to_lengths(seq_offsets),
        alpha=alpha, num_targets=num_targets, max_attn_len=max_attn_len,
        contextual_seq_len=contextual_seq_len, norm_len=max_seq_len,
    )
    return out.reshape(B * M, H, V)
