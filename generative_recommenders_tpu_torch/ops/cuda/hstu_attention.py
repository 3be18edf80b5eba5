"""HSTU attention kernels for Hopper, with their plain PyTorch versions.

Port of `generative_recommenders_tpu/ops/pallas/hstu_attention.py`:

* ``hstu_mha_dense_cuda``: kernel K1 (`csrc/hstu_mha_fwd.cu`), replacing
  `_fwd_kernel_rkv` / `_fwd_kernel` behind `hstu_mha_dense_pallas`, and on
  CUDA tensors differentiable through the backward kernels below (the
  custom VJP `_hstu_mha_pallas_core` becomes `_HstuMhaDense`);
* ``hstu_mha_bwd_cuda``: kernel K2 (`csrc/hstu_mha_bwd_fused.cu`),
  replacing `_bwd_fused_kernel_rkv`, the default backward; or, with
  ``split``, kernels K3 then K4 (`csrc/hstu_mha_bwd_dq.cu`,
  `csrc/hstu_mha_bwd_dkv.cu`), replacing `_bwd_dq_kernel` and
  `_bwd_dkv_kernel`: the split backward, which the autograd function takes
  when ``torch.are_deterministic_algorithms_enabled()`` (K2 sums dq with
  atomics in a different order on every run; K3 + K4 give the same bits);
* ``delta_hstu_mha_cuda``: kernel K5 (`csrc/delta_hstu_mha_fwd.cu`),
  replacing `_delta_fwd_kernel_rkv` behind `delta_hstu_mha_pallas`: the key
  range cut across blocks in 64-column chunks (`_delta_plan`), whose partial
  sums the last block to arrive adds in chunk order (the same bits on every
  run).

All keep the JAX signatures and the [B, N, H, D] layout. A wrapper given
CPU tensors computes its plain version; given CUDA tensors it launches its
kernels on the current stream or raises, and counts each launch, where it
happens, in its ``launches`` counter (the backward has one per kernel).
The TPU wrappers' transposes, their padding of N to tile multiples, their
block-size tables and the backward's `_pack_rows`
residual packing are VMEM and lane-padding artefacts and are not ported:
the kernels read strided [B, N, H, D] views and mask the ragged edge
themselves. All kernels compute in float32, the serving and training
paths' type.

HSTU attention replaces softmax with a pointwise gate:

    attn = silu(alpha * q @ k^T) / max_seq_len * valid_mask
    out  = attn @ v
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from generative_recommenders_tpu_torch.ops.attention_mask import (
    apply_padding_guard,
    make_delta_attn_mask,
    make_valid_attn_mask,
)
from generative_recommenders_tpu_torch.ops.cuda.build import LaunchCounter, load

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_BWD_ARGTYPES = [_P] * 9 + [_I] * 5 + [_L] * 12 + [_F, _F] + [_I] * 4 + [_P]
# C signatures of the entry points (csrc/*.cu)
_ARGTYPES = {
    "hstu_mha_fwd": [_P] * 6 + [_I] * 5 + [_L] * 9 + [_F, _F] + [_I] * 4 + [_P],
    "delta_hstu_mha_fwd": [_P] * 8 + [_I] * 6 + [_L] * 9 + [_F, _F] + [_I] * 5 + [_P],
    "hstu_mha_bwd_fused": _BWD_ARGTYPES,
    "hstu_mha_bwd_dq": _BWD_ARGTYPES,
    "hstu_mha_bwd_dkv": _BWD_ARGTYPES,
}
Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
_MAX_V = 128
_MAX_D = 256
# K5's tiling (csrc/delta_hstu_mha_fwd.cu): key columns and query rows per block
_DELTA_CHUNK = 64
_DELTA_ROWS = 8
_MAX_GRID_YZ = 65535
# K5's arrival counters, one zeroed int32 buffer per (device, stream): the
# kernel leaves every counter at 0 again
_delta_counters: Dict[Tuple[int, int], torch.Tensor] = {}
_delta_counters_lock = threading.Lock()  # the serving harness predicts on several threads


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


def hstu_mha_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    do: torch.Tensor,  # [B, N, H, V]: the gradient of the output
    **kw,
) -> Grads:
    """The backward kernels' function in plain PyTorch: (dq, dk, dv) of
    `hstu_mha_dense_plain` (same keywords) at the output gradient ``do``,
    by autograd. Rows and columns >= length get exact zeros."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = hstu_mha_dense_plain(*leaves, lengths, **kw)
        dq, dk, dv = torch.autograd.grad(out, leaves, do)
    return dq, dk, dv


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
    if not (0 < D <= _MAX_D and 0 < v.shape[3] <= _MAX_V):
        raise ValueError(
            f"the kernels take D <= {_MAX_D} and V <= {_MAX_V}; got D={D}, V={v.shape[3]}"
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


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _mask_args(kw: dict, N: int) -> tuple:
    """alpha, 1 / norm, causal, max_attn_len, contextual_seq_len,
    min_full_attn_seq_len: the kernels' trailing scalar arguments."""
    return (
        kw["alpha"], 1.0 / (kw["max_seq_len"] or N), int(kw["causal"]),
        kw["max_attn_len"], kw["contextual_seq_len"], kw["min_full_attn_seq_len"],
    )


def _dense_fwd(q, k, v, lens, nt, kw: dict) -> torch.Tensor:
    """Launches K1 on checked CUDA tensors (lens, nt: int32 or nt None)."""
    B, N, H, D = q.shape
    V = v.shape[3]
    out = torch.empty((B, N, H, V), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    _launch(
        "hstu_mha_fwd",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lens.data_ptr(), None if nt is None else nt.data_ptr(),
        B, N, H, D, V, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *_mask_args(kw, N), _stream(q.device),
    )
    hstu_mha_dense_cuda.launches.add()
    return out


class _HstuMhaDense(torch.autograd.Function):
    """K1 forward; backward by K2, or by K3 then K4 under
    ``torch.use_deterministic_algorithms(True)``. Saves q, k and v as they
    are (views of the uvqk projection on the STU path)."""

    @staticmethod
    def forward(ctx, q, k, v, lens, nt, kw):
        ctx.save_for_backward(q, k, v, lens, nt)
        ctx.kw = kw
        return _dense_fwd(q, k, v, lens, nt, kw)

    @staticmethod
    def backward(ctx, do):
        q, k, v, lens, nt = ctx.saved_tensors
        dq, dk, dv = hstu_mha_bwd_cuda(
            q, k, v, lens, do, split=torch.are_deterministic_algorithms_enabled(),
            num_targets=nt, **ctx.kw,
        )
        return dq, dk, dv, None, None, None


def _dense_kw(alpha, max_seq_len, causal, num_targets, max_attn_len,
              contextual_seq_len, min_full_attn_seq_len) -> dict:
    return dict(
        alpha=alpha, max_seq_len=max_seq_len, causal=causal,
        num_targets=num_targets, max_attn_len=max_attn_len,
        contextual_seq_len=contextual_seq_len,
        min_full_attn_seq_len=min_full_attn_seq_len,
    )


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
    dead, their outputs 0). Returns [B, N, H, V], differentiable in q, k and
    v. The optional [B, N, N] ``bias`` of the TPU kernel is not ported yet
    and raises."""
    if bias is not None:
        raise NotImplementedError("the additive [B, N, N] bias is not ported yet")
    kw = _dense_kw(alpha, max_seq_len, causal, num_targets, max_attn_len,
                   contextual_seq_len, min_full_attn_seq_len)
    if q.device.type == "cpu":
        return hstu_mha_dense_plain(q, k, v, lengths, **kw)
    device = _check_qkv(q, k, v)
    B, N = q.shape[:2]
    if k.shape[1] != N:
        raise ValueError(f"k has {k.shape[1]} rows, q has {N}")
    lens = _int_vector("lengths", lengths, B, device)
    nt = None if num_targets is None else _int_vector("num_targets", num_targets, B, device)
    kw.pop("num_targets")
    return _HstuMhaDense.apply(q, k, v, lens, nt, kw)


def _last_dim_contiguous(do: torch.Tensor) -> torch.Tensor:
    # the gradient of a reshape may come strided; the kernels read any
    # stride but the last
    return do if do.stride(-1) == 1 else do.contiguous()


def _bwd_kernel(name: str, q, k, v, lens, nt, do, kw: dict) -> Grads:
    """Launches one backward kernel on checked CUDA tensors (lens, nt:
    int32 or nt None; do contiguous in its last dim) and counts it. Returns
    (dq, dk, dv), None for the outputs the kernel does not write."""
    B, N, H, D = q.shape
    V = v.shape[3]
    new = lambda shape, zero=False: (torch.zeros if zero else torch.empty)(  # noqa: E731
        shape, dtype=torch.float32, device=q.device
    )
    # K2 adds its dq shares into a zeroed buffer with atomics
    dq = None if name == "hstu_mha_bwd_dkv" else new((B, N, H, D), zero=name == "hstu_mha_bwd_fused")
    dk, dv = (None, None) if name == "hstu_mha_bwd_dq" else (new((B, N, H, D)), new((B, N, H, V)))
    if B * N * H == 0:
        return dq, dk, dv
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _launch(
        name,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        ptr(dq), ptr(dk), ptr(dv), lens.data_ptr(), ptr(nt),
        B, N, H, D, V, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        *_mask_args(kw, N), _stream(q.device),
    )
    hstu_mha_bwd_cuda.launches[name].add()
    return dq, dk, dv


def hstu_mha_bwd_cuda(
    q: torch.Tensor,  # [B, N, H, D]
    k: torch.Tensor,  # [B, N, H, D]
    v: torch.Tensor,  # [B, N, H, V]
    lengths: torch.Tensor,  # int[B]
    do: torch.Tensor,  # [B, N, H, V]: the gradient of the output
    *,
    split: bool = False,
    alpha: float = 1.0,
    max_seq_len: Optional[int] = None,
    causal: bool = True,
    num_targets: Optional[torch.Tensor] = None,
    max_attn_len: int = 0,
    contextual_seq_len: int = 0,
    min_full_attn_seq_len: int = 0,
) -> Grads:
    """(dq, dk, dv) of `hstu_mha_dense_cuda` at ``do``: by kernel K2, whose
    dq is summed with atomics, so its last bits vary from run to run; or,
    with ``split``, by K3 (dq) then K4 (dk, dv), which give the same bits
    every run. ``launches`` holds one counter per kernel, keyed by its C
    entry point."""
    kw = _dense_kw(alpha, max_seq_len, causal, num_targets, max_attn_len,
                   contextual_seq_len, min_full_attn_seq_len)
    if q.device.type == "cpu":
        return hstu_mha_bwd_plain(q, k, v, lengths, do, **kw)
    device = _check_qkv(q, k, v)
    B, N, H, _ = q.shape
    if k.shape[1] != N or do.shape != (B, N, H, v.shape[3]):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, do {tuple(do.shape)}"
        )
    do = _last_dim_contiguous(do)
    _check("do", do, 4, device)
    lens = _int_vector("lengths", lengths, B, device)
    nt = None if num_targets is None else _int_vector("num_targets", num_targets, B, device)
    if not split:
        return _bwd_kernel("hstu_mha_bwd_fused", q, k, v, lens, nt, do, kw)
    dq = _bwd_kernel("hstu_mha_bwd_dq", q, k, v, lens, nt, do, kw)[0]
    _, dk, dv = _bwd_kernel("hstu_mha_bwd_dkv", q, k, v, lens, nt, do, kw)
    return dq, dk, dv


def _vec16(t: torch.Tensor) -> bool:
    """Whether a kernel may read ``t``'s rows with 16-byte loads: the
    pointer, every stride but the last and the width are multiples of 4
    float32 (the last stride is 1, `_check`)."""
    return (
        t.data_ptr() % 16 == 0
        and t.shape[-1] % 4 == 0
        and all(s % 4 == 0 for s in t.stride()[:-1])
    )


def _delta_plan(B: int, M: int, N: int, H: int, V: int) -> dict:
    """K5's launch: the key range in chunks of 64 columns and the M query
    rows in tiles of 8, one block per (chunk, head x row tile, batch row);
    the [chunks, B, M, H, V] scratch of the chunks' partial sums (none with
    one chunk: the block writes the output) and one arrival counter per
    (batch row, head, row tile). Raises where the grid exceeds CUDA's."""
    chunks = -(-N // _DELTA_CHUNK)
    row_tiles = -(-M // _DELTA_ROWS)
    grid = (chunks, H * row_tiles, B)
    if grid[1] > _MAX_GRID_YZ or grid[2] > _MAX_GRID_YZ:
        raise ValueError(
            f"K5's grid {grid} exceeds {_MAX_GRID_YZ} blocks in y or z "
            f"(B={B}, M={M}, H={H}): split the batch"
        )
    return dict(
        chunks=chunks, row_tiles=row_tiles, grid=grid,
        scratch_shape=(chunks, B, M, H, V) if chunks > 1 else None,
        counters=B * H * row_tiles,
    )


def _delta_counter_buffer(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed counters for launches on the device's current
    stream. Launches on one stream run in turn and each leaves the counters
    at 0, so they share the buffer; a buffer outgrown is replaced by a
    larger zeroed one (the old one lives until its last launch has run: the
    allocator reuses memory in stream order)."""
    index = torch.cuda.current_device() if device.index is None else device.index
    key = (index, _stream(device))
    with _delta_counters_lock:
        buf = _delta_counters.get(key)
        if buf is None or buf.numel() < n:
            buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
            _delta_counters[key] = buf
    return buf


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
    plan = _delta_plan(B, M, N, H, V)
    scratch = counters = None
    if plan["scratch_shape"] is not None:
        scratch = torch.empty(plan["scratch_shape"], dtype=torch.float32, device=device)
        counters = _delta_counter_buffer(device, plan["counters"])
    _launch(
        "delta_hstu_mha_fwd",
        delta_q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        None if counters is None else counters.data_ptr(),
        lens.data_ptr(), None if nt is None else nt.data_ptr(),
        B, M, N, H, D, V, *delta_q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        alpha, 1.0 / (norm_len or N),
        max_attn_len, contextual_seq_len, min_full_attn_seq_len,
        int(_vec16(k)), int(_vec16(v)), _stream(device),
    )
    delta_hstu_mha_cuda.launches.add()
    return out


hstu_mha_dense_cuda.launches = LaunchCounter()
hstu_mha_bwd_cuda.launches = {
    name: LaunchCounter() for name in ("hstu_mha_bwd_fused", "hstu_mha_bwd_dq", "hstu_mha_bwd_dkv")
}
delta_hstu_mha_cuda.launches = LaunchCounter()
