"""HSTU attention with the relative position and time bias rebuilt inside
the kernel, forward and backward, with its plain PyTorch version.

Port of `generative_recommenders_tpu/ops/pallas/hstu_attention_relbias.py`:

* ``hstu_mha_dense_relbias_cuda``: kernel K6 (`csrc/hstu_mha_relbias_fwd.cu`),
  replacing `_fwd_kernel_relbias` behind `hstu_mha_dense_pallas_relbias`; on
  CUDA tensors differentiable in q, k, v, ``pos_w`` and ``ts_w`` through
* ``hstu_mha_relbias_bwd_cuda``: kernel K7 (`csrc/hstu_mha_relbias_bwd.cu`),
  replacing `_bwd_kernel_relbias` (the custom VJP `_relbias_call` becomes
  `_HstuMhaRelbias`): 3xTF32 products on the tensor cores, a group of heads
  inside one block (`_relbias_bwd_plan`), head widths up to 64.

    bias[b, i, j] = pos_w[clip(j - i + Nm - 1, 0, 2 Nm - 2)]
                  + ts_w[clip(floor(ln(max(|ts[b, min(i + 1, N - 1)]
                                          - ts[b, j]|, 1)) / 0.301), 0, NB)]
    out = silu(alpha * q k^T + bias) / max_seq_len * valid_mask @ v

The kernels never build the [B, N, N] bias: both tables sit in shared memory
and each element looks its two entries up. The plain version builds it.
Timestamps are cast to float32 before they are subtracted, as the JAX
package casts them (near 1.6e9 that rounds them to 128 s), and row i reads
the timestamp of position i + 1 whether or not it lies past the row's
length: in training the target's timestamp sits exactly there. The bucket is
``floor(ln(x) * (1 / 0.301))``, the Pallas kernel's form, in the plain
version and in the CUDA kernels alike. The TPU wrapper's padding of N to a
multiple of 128, its 128-wide table rows, its `_pack_rows` residuals and the
host scatter-add that rebuilds ``dpos_w`` are not ported.

K7 sums dq, ``dpos_w`` and ``dts_w`` with atomics, in an order that changes
from run to run, and the JAX package has no other backward for this
function: under ``torch.use_deterministic_algorithms(True)`` the backward
raises (or warns, with ``warn_only``), as PyTorch's own atomics-based
operations do.
"""

from __future__ import annotations

import ctypes
import warnings
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from generative_recommenders_tpu_torch.ops.attention_mask import (
    apply_padding_guard,
    make_valid_attn_mask,
)
from generative_recommenders_tpu_torch.ops.cuda import hstu_attention as ha
from generative_recommenders_tpu_torch.ops.cuda.build import LaunchCounter

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signatures of the entry points (csrc/hstu_mha_relbias_*.cu)
ha._ARGTYPES.update({
    "hstu_mha_relbias_fwd": [_P] * 9 + [_I] * 5 + [_L] * 9 + [_F, _F] + [_I] * 6 + [_P],
    "hstu_mha_relbias_bwd": [_P] * 14 + [_I] * 5 + [_L] * 12 + [_F, _F] + [_I] * 10 + [_P],
})
# K7's tiling (csrc/hstu_mha_relbias_bwd.cu): 64 x 64 tile pairs, every tile
# at a pitch of its width + 8; a Hopper block's shared memory
_BWD_TILE, _BWD_PITCH, _BWD_WARPS = 64, 72, 16
_MAX_BWD_WIDTH = 64
_MAX_BWD_BUCKETS = 65535
_MAX_SHARED_BYTES = 232448
_INV_LOG_BASE = 1.0 / 0.301  # bucket(x) = floor(ln(x) / 0.301)
RelbiasGrads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


# -------------------------------------------------------------- plain version
def relative_bias_plain(
    timestamps: torch.Tensor,  # [B, N], integer or float
    pos_w: torch.Tensor,  # float32 [2 * Nm - 1]
    ts_w: torch.Tensor,  # float32 [num_buckets + 1]
    num_buckets: int,
) -> torch.Tensor:
    """The [B, N, N] bias, materialised (port of
    `models/hstu.py:RelativeBucketedTimeAndPositionBasedBias` with the
    kernel's bucket form)."""
    N = timestamps.shape[1]
    Nm = (pos_w.shape[0] + 1) // 2
    i = torch.arange(N, device=timestamps.device)
    rel = (i[None, :] - i[:, None] + Nm - 1).clamp(0, 2 * Nm - 2)
    ts = timestamps.to(torch.float32)
    ts_next = ts[:, (i + 1).clamp_max(N - 1)]  # [B, N]: row i reads ts[i + 1]
    dt = ts_next[:, :, None] - ts[:, None, :]
    bucket = torch.floor(torch.log(dt.abs().clamp_min(1.0)) * _INV_LOG_BASE)
    bucket = bucket.clamp(0, num_buckets).long()
    return pos_w[rel][None] + ts_w[bucket]


def hstu_mha_dense_relbias_plain(
    q: torch.Tensor,  # [B, N, H, D]
    k: torch.Tensor,  # [B, N, H, D]
    v: torch.Tensor,  # [B, N, H, V]
    lengths: torch.Tensor,  # int[B]
    timestamps: torch.Tensor,  # [B, N]
    pos_w: torch.Tensor,  # float32 [2 * Nm - 1]
    ts_w: torch.Tensor,  # float32 [num_buckets + 1]
    *,
    alpha: float = 1.0,
    max_seq_len: Optional[int] = None,
    num_buckets: int = 128,
    causal: bool = True,
    num_targets: Optional[torch.Tensor] = None,
    max_attn_len: int = 0,
    contextual_seq_len: int = 0,
    min_full_attn_seq_len: int = 0,
) -> torch.Tensor:
    """K6's function in plain PyTorch: the materialised bias, the spec mask
    AND row/col < length, silu, einsum. Rows >= length come out 0.
    Differentiable by autograd in q, k, v, ``pos_w`` and ``ts_w``: its
    gradient is the plain backward."""
    N = q.shape[1]
    mask = apply_padding_guard(
        make_valid_attn_mask(
            N, lengths, causal=causal, num_targets=num_targets,
            max_attn_len=max_attn_len, contextual_seq_len=contextual_seq_len,
            min_full_attn_seq_len=min_full_attn_seq_len,
        ),
        lengths,
    )
    bias = relative_bias_plain(timestamps, pos_w, ts_w, num_buckets)
    scores = torch.einsum("bnhd,bmhd->bhnm", q, k) * alpha + bias[:, None]
    p = F.silu(scores) / (max_seq_len or N)
    p = p * mask[:, None, :, :].to(p.dtype)
    return torch.einsum("bhnm,bmhv->bnhv", p, v)


def hstu_mha_relbias_bwd_plain(q, k, v, lengths, timestamps, pos_w, ts_w, do, **kw) -> RelbiasGrads:
    """K7's function in plain PyTorch: (dq, dk, dv, dpos_w, dts_w) of
    `hstu_mha_dense_relbias_plain` (same keywords) at the output gradient
    ``do``, by autograd."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v, pos_w, ts_w)]
        out = hstu_mha_dense_relbias_plain(*leaves[:3], lengths, timestamps, *leaves[3:], **kw)
        return torch.autograd.grad(out, leaves, do)


# -------------------------------------------------------------------- kernels
def _checked(q, k, v, lengths, timestamps, pos_w, ts_w, num_buckets: int, num_targets):
    """Checks the CUDA inputs of both kernels; returns the timestamps as
    contiguous float32 and lengths and num_targets as int32 (or None)."""
    device = ha._check_qkv(q, k, v)
    B, N = q.shape[:2]
    if k.shape[1] != N:
        raise ValueError(f"k has {k.shape[1]} rows, q has {N}")
    for name, t in (("pos_w", pos_w), ("ts_w", ts_w)):
        ha._check(name, t, 1, device)
    if pos_w.shape[0] % 2 != 1:
        raise ValueError("pos_w must have 2 * Nm - 1 entries")
    Nm = (pos_w.shape[0] + 1) // 2
    if N > Nm + 127:
        raise ValueError(f"runtime N = {N} beyond the position table's range (Nm = {Nm})")
    if num_buckets < 0 or ts_w.shape[0] != num_buckets + 1:
        raise ValueError(f"ts_w must have num_buckets + 1 = {num_buckets + 1} entries")
    if timestamps.shape != (B, N):
        raise ValueError(f"timestamps must have shape ({B}, {N}), got {tuple(timestamps.shape)}")
    # cast first, subtract in the kernel: the reference's rounding
    ts = timestamps.to(device=device, dtype=torch.float32).contiguous()
    lens = ha._int_vector("lengths", lengths, B, device)
    nt = None if num_targets is None else ha._int_vector("num_targets", num_targets, B, device)
    return ts, lens, nt


def _relbias_fwd(q, k, v, lens, nt, ts, pos_w, ts_w, kw: dict) -> torch.Tensor:
    """Launches K6 on checked CUDA tensors (lens, nt: int32 or nt None; ts
    float32 [B, N]; both tables contiguous float32)."""
    B, N, H, D = q.shape
    V = v.shape[3]
    out = torch.empty((B, N, H, V), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    ha._launch(
        "hstu_mha_relbias_fwd",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lens.data_ptr(), None if nt is None else nt.data_ptr(),
        ts.data_ptr(), pos_w.data_ptr(), ts_w.data_ptr(),
        B, N, H, D, V, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *ha._mask_args(kw, N), (pos_w.shape[0] + 1) // 2, ts_w.shape[0] - 1,
        ha._stream(q.device),
    )
    hstu_mha_dense_relbias_cuda.launches.add()
    return out


def _relbias_bwd_plan(D: int, V: int, H: int, Nm: int, NB: int) -> dict:
    """K7's launch: the head width both D and V are padded to (32 or 64), the
    heads a block loops inside (4 or 2: their K, V, dK and dV tiles fill its
    shared memory and registers), the head groups (H need not be a multiple)
    and the block's shared memory: K and V of the group, two (Q, dO)
    buffers, P, dS and dS summed over the heads, both tables, ``dpos_w``'s
    sums and one copy of ``dts_w``'s sums per warp. Raises on
    heads wider than 64, on more than 65535 buckets and on tables that do
    not fit beside the tiles."""
    if D > _MAX_BWD_WIDTH or V > _MAX_BWD_WIDTH:
        raise ValueError(
            f"the relative-bias backward kernel takes D, V <= {_MAX_BWD_WIDTH}; got D={D}, V={V}"
        )
    if NB > _MAX_BWD_BUCKETS:
        raise ValueError(f"the relative-bias backward kernel takes at most {_MAX_BWD_BUCKETS} buckets, got {NB}")
    width = 32 if max(D, V) <= 32 else 64
    head_group = 128 // width
    tiles = (
        (2 * head_group + 4) * _BWD_TILE * (width + 8)  # K, V of the group; two (Q, dO) buffers
        + 3 * _BWD_TILE * _BWD_PITCH  # P, dS, dS summed over the heads
    )
    tables = 2 * (2 * Nm - 1) + (1 + _BWD_WARPS) * (NB + 1)
    shared_bytes = 4 * (tiles + tables)
    if shared_bytes > _MAX_SHARED_BYTES:
        raise ValueError(
            f"the relative-bias backward kernel needs {shared_bytes} bytes of shared memory "
            f"({4 * tiles} of tiles, {4 * tables} of tables for Nm={Nm}, NB={NB}); "
            f"a block has {_MAX_SHARED_BYTES}"
        )
    return dict(width=width, head_group=head_group, head_groups=-(-H // head_group),
                shared_bytes=shared_bytes)


def _relbias_bwd(q, k, v, lens, nt, ts, pos_w, ts_w, do, kw: dict) -> RelbiasGrads:
    """Launches K7 on checked CUDA tensors (as `_relbias_fwd`; do contiguous
    in its last dim) and counts it. dq and both table gradients are summed
    into zeroed buffers."""
    B, N, H, D = q.shape
    V = v.shape[3]
    Nm, NB = (pos_w.shape[0] + 1) // 2, ts_w.shape[0] - 1
    _relbias_bwd_plan(D, V, H, Nm, NB)  # raises on what the kernel does not take
    new = lambda fn, *shape: fn(shape, dtype=torch.float32, device=q.device)  # noqa: E731
    dq = new(torch.zeros, B, N, H, D)
    dk, dv = new(torch.empty, B, N, H, D), new(torch.empty, B, N, H, V)
    dpos, dts = new(torch.zeros, pos_w.shape[0]), new(torch.zeros, ts_w.shape[0])
    if B * N * H == 0:
        return dq, dk, dv, dpos, dts
    ha._launch(
        "hstu_mha_relbias_bwd",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        lens.data_ptr(), None if nt is None else nt.data_ptr(),
        ts.data_ptr(), pos_w.data_ptr(), ts_w.data_ptr(), dpos.data_ptr(), dts.data_ptr(),
        B, N, H, D, V, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        *ha._mask_args(kw, N), Nm, NB,
        *(int(ha._vec16(t)) for t in (q, k, v, do)), ha._stream(q.device),
    )
    hstu_mha_relbias_bwd_cuda.launches.add()
    return dq, dk, dv, dpos, dts


class _HstuMhaRelbias(torch.autograd.Function):
    """K6 forward, K7 backward: gradients for q, k, v, ``pos_w`` and
    ``ts_w``, none for the timestamps and the lengths. Saves q, k and v as
    they are (views of the uvqk projection on the STU path)."""

    @staticmethod
    def forward(ctx, q, k, v, pos_w, ts_w, ts, lens, nt, kw):
        ctx.save_for_backward(q, k, v, pos_w, ts_w, ts, lens, nt)
        ctx.kw = kw
        return _relbias_fwd(q, k, v, lens, nt, ts, pos_w, ts_w, kw)

    @staticmethod
    def backward(ctx, do):
        q, k, v, pos_w, ts_w, ts, lens, nt = ctx.saved_tensors
        if torch.are_deterministic_algorithms_enabled():
            msg = (
                "hstu_mha_relbias_bwd_cuda does not have a deterministic implementation: "
                "kernel K7 sums dq, dpos_w and dts_w with atomicAdd, and the relative-bias "
                "attention has no split backward. Turn it off for this operation with "
                "torch.use_deterministic_algorithms(False), or only warn with warn_only=True."
            )
            if not torch.is_deterministic_algorithms_warn_only_enabled():
                raise RuntimeError(msg)
            warnings.warn(msg)
        grads = hstu_mha_relbias_bwd_cuda(
            q, k, v, lens, ts, pos_w, ts_w, do, num_targets=nt,
            num_buckets=ts_w.shape[0] - 1, **ctx.kw,
        )
        return (*grads, None, None, None, None)


def hstu_mha_dense_relbias_cuda(
    q: torch.Tensor,  # [B, N, H, D]
    k: torch.Tensor,  # [B, N, H, D]
    v: torch.Tensor,  # [B, N, H, V]
    lengths: torch.Tensor,  # int[B]
    timestamps: torch.Tensor,  # [B, N], integer or float, full length
    pos_w: torch.Tensor,  # float32 [2 * Nm - 1]
    ts_w: torch.Tensor,  # float32 [num_buckets + 1]
    *,
    alpha: float = 1.0,
    max_seq_len: Optional[int] = None,
    num_buckets: int = 128,
    causal: bool = True,
    num_targets: Optional[torch.Tensor] = None,
    max_attn_len: int = 0,
    contextual_seq_len: int = 0,
    min_full_attn_seq_len: int = 0,
) -> torch.Tensor:
    """Dense HSTU attention with jagged ``lengths`` and the relative position
    and time bias computed in the kernel. Returns [B, N, H, V] (rows >=
    length are 0), differentiable in q, k, v, ``pos_w`` and ``ts_w``. CPU
    tensors go through the plain version; CUDA tensors launch K6 (and K7 in
    the backward) or raise."""
    kw = ha._dense_kw(alpha, max_seq_len, causal, num_targets, max_attn_len,
                      contextual_seq_len, min_full_attn_seq_len)
    if q.device.type == "cpu":
        return hstu_mha_dense_relbias_plain(
            q, k, v, lengths, timestamps, pos_w, ts_w, num_buckets=num_buckets, **kw
        )
    ts, lens, nt = _checked(q, k, v, lengths, timestamps, pos_w, ts_w, num_buckets, num_targets)
    kw.pop("num_targets")
    return _HstuMhaRelbias.apply(q, k, v, pos_w, ts_w, ts, lens, nt, kw)


def hstu_mha_relbias_bwd_cuda(
    q: torch.Tensor,  # [B, N, H, D]
    k: torch.Tensor,  # [B, N, H, D]
    v: torch.Tensor,  # [B, N, H, V]
    lengths: torch.Tensor,  # int[B]
    timestamps: torch.Tensor,  # [B, N]
    pos_w: torch.Tensor,  # float32 [2 * Nm - 1]
    ts_w: torch.Tensor,  # float32 [num_buckets + 1]
    do: torch.Tensor,  # [B, N, H, V]: the gradient of the output
    *,
    alpha: float = 1.0,
    max_seq_len: Optional[int] = None,
    num_buckets: int = 128,
    causal: bool = True,
    num_targets: Optional[torch.Tensor] = None,
    max_attn_len: int = 0,
    contextual_seq_len: int = 0,
    min_full_attn_seq_len: int = 0,
) -> RelbiasGrads:
    """(dq, dk, dv, dpos_w, dts_w) of `hstu_mha_dense_relbias_cuda` at
    ``do``, by kernel K7; dq and the table gradients are summed with atomics,
    so their last bits vary from run to run (dk and dv are the same bits
    every run). Heads wider than 64, or tables that do not fit a block's
    shared memory beside the tiles, raise. CPU tensors go through the plain
    backward."""
    kw = ha._dense_kw(alpha, max_seq_len, causal, num_targets, max_attn_len,
                      contextual_seq_len, min_full_attn_seq_len)
    if q.device.type == "cpu":
        return hstu_mha_relbias_bwd_plain(
            q, k, v, lengths, timestamps, pos_w, ts_w, do, num_buckets=num_buckets, **kw
        )
    ts, lens, nt = _checked(q, k, v, lengths, timestamps, pos_w, ts_w, num_buckets, num_targets)
    if do.shape != v.shape:
        raise ValueError(f"shape mismatch: v {tuple(v.shape)}, do {tuple(do.shape)}")
    do = ha._last_dim_contiguous(do)
    ha._check("do", do, 4, q.device)
    kw.pop("num_targets")
    return _relbias_bwd(q, k, v, lens, nt, ts, pos_w, ts_w, do, kw)


hstu_mha_dense_relbias_cuda.launches = LaunchCounter()
hstu_mha_relbias_bwd_cuda.launches = LaunchCounter()
