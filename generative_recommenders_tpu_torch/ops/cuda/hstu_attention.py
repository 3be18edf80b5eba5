"""HSTU attention kernels for Hopper, with their plain PyTorch versions.

Port of `generative_recommenders_tpu/ops/pallas/hstu_attention.py` (the
forward kernels on the serving path):

* ``hstu_mha_dense_cuda``: kernel K1 (`csrc/hstu_mha_fwd.cu`), replacing
  `_fwd_kernel_rkv` / `_fwd_kernel` behind `hstu_mha_dense_pallas`;
* ``delta_hstu_mha_cuda``: kernel K5 (`csrc/delta_hstu_mha_fwd.cu`),
  replacing `_delta_fwd_kernel_rkv` behind `delta_hstu_mha_pallas`.

Both keep the JAX signatures and the [B, N, H, D] layout. A wrapper given
CPU tensors computes its plain version; given CUDA tensors it launches its
kernel on the current stream or raises, and counts the launch in its
``launches`` counter. The TPU wrappers' transposes, their padding of N to
tile multiples and their block-size tables are VMEM artefacts and are not
ported: the kernels read strided [B, N, H, D] views and mask the ragged
edge themselves. Both kernels compute in float32, the serving path's type.

HSTU attention replaces softmax with a pointwise gate:

    attn = silu(alpha * q @ k^T) / max_seq_len * valid_mask
    out  = attn @ v
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from generative_recommenders_tpu_torch.ops.attention_mask import (
    apply_padding_guard,
    make_delta_attn_mask,
    make_valid_attn_mask,
)
from generative_recommenders_tpu_torch.ops.cuda.build import LaunchCounter, load

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signatures of the two entry points (csrc/*.cu)
_ARGTYPES = {
    "hstu_mha_fwd": [_P] * 6 + [_I] * 5 + [_L] * 9 + [_F, _F] + [_I] * 4 + [_P],
    "delta_hstu_mha_fwd": [_P] * 6 + [_I] * 6 + [_L] * 9 + [_F, _F] + [_I] * 3 + [_P],
}
_SUPPORTED_V = (16, 32, 64, 128)
_MAX_D = 256


# ------------------------------------------------------------ plain versions
def hstu_mha_dense(
    q: torch.Tensor,  # [B, N, H, D]
    k: torch.Tensor,  # [B, N, H, D]
    v: torch.Tensor,  # [B, N, H, V]
    *,
    alpha: float,
    max_seq_len: int,  # the silu normaliser
    mask: torch.Tensor,  # bool [B or 1, N, N]
) -> torch.Tensor:
    """Dense HSTU multi-head attention over an explicit mask, in float32
    (port of `generative_recommenders_tpu/ops/xla/hstu_attention.py:
    hstu_mha_dense`); returns [B, N, H, V]."""
    scores = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * alpha
    p = F.silu(scores) / max_seq_len
    p = p * mask[:, None, :, :].to(p.dtype)
    out = torch.einsum("bhnm,bmhv->bnhv", p, v.float())
    return out.to(v.dtype)


def hstu_mha_dense_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    *,
    alpha: float = 1.0,
    max_seq_len: Optional[int] = None,
    causal: bool = True,
    num_targets: Optional[torch.Tensor] = None,
    max_attn_len: int = 0,
    contextual_seq_len: int = 0,
    min_full_attn_seq_len: int = 0,
) -> torch.Tensor:
    """K1's function in plain PyTorch: the spec mask AND row/col < length,
    then `hstu_mha_dense`. Rows >= length come out 0."""
    N = q.shape[1]
    mask = apply_padding_guard(
        make_valid_attn_mask(
            N, lengths, causal=causal, num_targets=num_targets,
            max_attn_len=max_attn_len, contextual_seq_len=contextual_seq_len,
            min_full_attn_seq_len=min_full_attn_seq_len,
        ),
        lengths,
    )
    return hstu_mha_dense(q, k, v, alpha=alpha, max_seq_len=max_seq_len or N, mask=mask)


def delta_hstu_mha_plain(
    delta_q: torch.Tensor,  # [B, M, H, D]
    k: torch.Tensor,  # [B, N, H, D]
    v: torch.Tensor,  # [B, N, H, V]
    seq_lengths: torch.Tensor,  # int[B]: full (cache + delta) lengths
    *,
    alpha: float = 1.0,
    num_targets: Optional[torch.Tensor] = None,
    max_attn_len: int = 0,
    contextual_seq_len: int = 0,
    min_full_attn_seq_len: int = 0,
    norm_len: Optional[int] = None,
) -> torch.Tensor:
    """K5's function in plain PyTorch (the XLA branch of
    `ops/hstu_compute.py:delta_hstu_mha`): the M delta queries sit at
    positions [length - M, length) and see the matching rows of the full
    mask. Returns [B, M, H, V]."""
    B, M = delta_q.shape[:2]
    N = k.shape[1]
    qk = torch.einsum("bmhd,bnhd->bhmn", delta_q.float(), k.float()) * alpha
    p = F.silu(qk) / (norm_len or N)
    row_idx = seq_lengths.long()[:, None] - M + torch.arange(M, device=k.device)[None, :]
    delta_mask = make_delta_attn_mask(
        N, seq_lengths, row_idx.clamp(0, N - 1), causal=True,
        num_targets=num_targets, max_attn_len=max_attn_len,
        contextual_seq_len=contextual_seq_len,
        min_full_attn_seq_len=min_full_attn_seq_len,
    )
    p = p * delta_mask[:, None, :, :].to(p.dtype)
    return torch.einsum("bhmn,bnhv->bmhv", p, v.float()).to(v.dtype)


# ------------------------------------------------------------------ kernels
def _check(name: str, t: torch.Tensor, ndim: int, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 (the serving path's type), got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous in its last dim")


def _int_vector(name: str, t: torch.Tensor, B: int, device: torch.device) -> torch.Tensor:
    if t.shape != (B,):
        raise ValueError(f"{name} must have shape ({B},), got {tuple(t.shape)}")
    if t.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name} must be an integer tensor, got {t.dtype}")
    return t.to(device=device, dtype=torch.int32).contiguous()


def _check_qkv(q, k, v) -> torch.device:
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CPU or CUDA tensors, got {device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, 4, device)
    B, _, H, D = q.shape
    if k.shape[0] != B or k.shape[2:] != (H, D) or v.shape[:3] != k.shape[:3]:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    if D > _MAX_D or v.shape[3] not in _SUPPORTED_V:
        raise ValueError(
            f"the kernels take D <= {_MAX_D} and V in {_SUPPORTED_V}; "
            f"got D={D}, V={v.shape[3]}"
        )
    return device


def _launch(name: str, *args) -> None:
    """Calls the kernel's C entry point; raises on a nonzero
    cudaGetLastError() from the launch."""
    fn = getattr(load(name), name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES[name], ctypes.c_int
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def hstu_mha_dense_cuda(
    q: torch.Tensor,  # [B, N, H, D]
    k: torch.Tensor,  # [B, N, H, D]
    v: torch.Tensor,  # [B, N, H, V]
    lengths: torch.Tensor,  # int[B]
    *,
    alpha: float = 1.0,
    max_seq_len: Optional[int] = None,
    bias: Optional[torch.Tensor] = None,
    causal: bool = True,
    num_targets: Optional[torch.Tensor] = None,
    max_attn_len: int = 0,
    contextual_seq_len: int = 0,
    min_full_attn_seq_len: int = 0,
) -> torch.Tensor:
    """Dense HSTU attention with jagged ``lengths`` (rows/cols >= length are
    dead, their outputs 0). Returns [B, N, H, V]. The optional [B, N, N]
    ``bias`` of the TPU kernel is not ported yet and raises."""
    if bias is not None:
        raise NotImplementedError("the additive [B, N, N] bias is not ported yet")
    kw = dict(
        alpha=alpha, max_seq_len=max_seq_len, causal=causal,
        num_targets=num_targets, max_attn_len=max_attn_len,
        contextual_seq_len=contextual_seq_len,
        min_full_attn_seq_len=min_full_attn_seq_len,
    )
    if q.device.type == "cpu":
        return hstu_mha_dense_plain(q, k, v, lengths, **kw)
    device = _check_qkv(q, k, v)
    B, N, H, D = q.shape
    V = v.shape[3]
    if k.shape[1] != N:
        raise ValueError(f"k has {k.shape[1]} rows, q has {N}")
    lens = _int_vector("lengths", lengths, B, device)
    nt = None if num_targets is None else _int_vector("num_targets", num_targets, B, device)
    out = torch.empty((B, N, H, V), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    _launch(
        "hstu_mha_fwd",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lens.data_ptr(), None if nt is None else nt.data_ptr(),
        B, N, H, D, V, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        alpha, 1.0 / (max_seq_len or N), int(causal),
        max_attn_len, contextual_seq_len, min_full_attn_seq_len,
        torch.cuda.current_stream(device).cuda_stream,
    )
    hstu_mha_dense_cuda.launches.add()
    return out


def delta_hstu_mha_cuda(
    delta_q: torch.Tensor,  # [B, M, H, D]: queries of the M newest tokens
    k: torch.Tensor,  # [B, N, H, D]: full (cache + delta) keys
    v: torch.Tensor,  # [B, N, H, V]
    seq_lengths: torch.Tensor,  # int[B]: full valid length per row (<= N)
    *,
    alpha: float = 1.0,
    num_targets: Optional[torch.Tensor] = None,
    max_attn_len: int = 0,
    contextual_seq_len: int = 0,
    min_full_attn_seq_len: int = 0,
    norm_len: Optional[int] = None,
) -> torch.Tensor:
    """Delta-q attention of the M-FALCON cached path: the M delta queries sit
    at positions [length - M, length) and attend over the full K/V under
    `make_delta_attn_mask`, scaled by 1 / ``norm_len`` (default N). It must
    equal the normaliser of the prefill forward. Returns [B, M, H, V]."""
    kw = dict(
        alpha=alpha, num_targets=num_targets, max_attn_len=max_attn_len,
        contextual_seq_len=contextual_seq_len,
        min_full_attn_seq_len=min_full_attn_seq_len, norm_len=norm_len,
    )
    if delta_q.device.type == "cpu":
        return delta_hstu_mha_plain(delta_q, k, v, seq_lengths, **kw)
    device = _check_qkv(delta_q, k, v)
    B, M, H, D = delta_q.shape
    N, V = k.shape[1], v.shape[3]
    lens = _int_vector("seq_lengths", seq_lengths, B, device)
    nt = None if num_targets is None else _int_vector("num_targets", num_targets, B, device)
    out = torch.empty((B, M, H, V), dtype=torch.float32, device=device)
    if out.numel() == 0 or N == 0:
        return out.zero_()
    _launch(
        "delta_hstu_mha_fwd",
        delta_q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lens.data_ptr(), None if nt is None else nt.data_ptr(),
        B, M, N, H, D, V, *delta_q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        alpha, 1.0 / (norm_len or N),
        max_attn_len, contextual_seq_len, min_full_attn_seq_len,
        torch.cuda.current_stream(device).cuda_stream,
    )
    delta_hstu_mha_cuda.launches.add()
    return out


hstu_mha_dense_cuda.launches = LaunchCounter()
delta_hstu_mha_cuda.launches = LaunchCounter()
