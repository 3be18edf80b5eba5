"""HSTU attention kernels for Hopper, with their plain PyTorch versions.

Port of `generative_recommenders_tpu/ops/pallas/hstu_attention.py`:

* ``hstu_mha_dense_cuda``: kernel K1 (`csrc/hstu_mha_fwd.cu`), replacing
  `_fwd_kernel_rkv` / `_fwd_kernel` behind `hstu_mha_dense_pallas`
  (3xTF32 products on the tensor cores, launched by `_fwd_plan`), and on
  CUDA tensors differentiable through the backward kernels below (the
  custom VJP `_hstu_mha_pallas_core` becomes `_HstuMhaDense`);
* ``hstu_mha_bwd_cuda``: kernel K2 (`csrc/hstu_mha_bwd_fused.cu`),
  replacing `_bwd_fused_kernel_rkv`, the default backward; or, with
  ``split``, kernels K3 then K4 (`csrc/hstu_mha_bwd_dq.cu`,
  `csrc/hstu_mha_bwd_dkv.cu`), replacing `_bwd_dq_kernel` and
  `_bwd_dkv_kernel`: the split backward, which the autograd function takes
  when ``torch.are_deterministic_algorithms_enabled()`` (K2 sums dq with
  atomics in a different order on every run; K3 + K4 give the same bits).
  All three run their products on the tensor cores (3xTF32): K2 and K4
  share one body, launched by `_bwd_plan`; K3 has its own, launched by
  `_dq_plan`;
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
themselves.

bfloat16: K1 and K2 also take bfloat16 q, k, v (and dO), the types the JAX
package's ``compute_dtype="bfloat16"`` gives the first block of the
bias-free HSTU research model (``enable_relative_attention_bias=False``),
whose attention reaches `hstu_mha_dense_pallas` on bfloat16 under
``attn_kernel="pallas"`` (and ``"auto"`` at N >= 512); the relative-bias
pair K6 / K7 takes bfloat16 too (`ops/cuda/hstu_attention_relbias.py`).
The entry points ``hstu_mha_fwd_bf16`` and ``hstu_mha_bwd_fused_bf16``
(K1-bf16, K2-bf16) keep the Pallas kernels' rounding points: alpha q
rounded to bfloat16 (where alpha != 1), S, dP and dS in float32 from exact
products, P rounded to bfloat16 before P V and P^T dO, dO entering the
backward as bfloat16(dO / norm), dS rounded before dS^T (alpha q) and dS K,
dq taking one alpha at its float32 flush; out, dq, dk and dv in bfloat16.
Their plain versions (`_dense_fwd_plain_bf16`, `_dense_bwd_plain_bf16`)
round at the same points, and a bfloat16 CPU tensor goes through them;
autograd through a bfloat16 forward would round dP instead. They count
their launches in ``launches_bf16`` beside ``launches``. The split backward
K3 + K4 takes float32 only: under deterministic algorithms a bfloat16
backward raises (or warns and takes K2-bf16, with ``warn_only``). K5 takes
float32 only.

HSTU attention replaces softmax with a pointwise gate:

    attn = silu(alpha * q @ k^T) / max_seq_len * valid_mask
    out  = attn @ v
"""

from __future__ import annotations

import ctypes
import threading
import warnings
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
# C signatures of the entry points (csrc/*.cu); the backward kernels share
# one, which ends with the `vec_*` flags of q, k, v and dO
_ARGTYPES = {
    **{
        name: [_P] * 6 + [_I] * 5 + [_L] * 9 + [_F, _F] + [_I] * 4 + [_P]
        for name in ("hstu_mha_fwd", "hstu_mha_fwd_bf16")
    },
    "delta_hstu_mha_fwd": [_P] * 8 + [_I] * 6 + [_L] * 9 + [_F, _F] + [_I] * 5 + [_P],
    **{
        name: [_P] * 9 + [_I] * 5 + [_L] * 12 + [_F, _F] + [_I] * 4 + [_I] * 4 + [_P]  # mask ints, flags
        for name in ("hstu_mha_bwd_fused", "hstu_mha_bwd_dq", "hstu_mha_bwd_dkv")
    },
    # one more pointer: dq's float32 sums beside the bfloat16 dq
    "hstu_mha_bwd_fused_bf16": [_P] * 10 + [_I] * 5 + [_L] * 12 + [_F, _F] + [_I] * 4 + [_I] * 4 + [_P],
}
# entry points that live in another kernel's library: entry -> library (the
# bfloat16 K1 and K2 are second entry points of K1's and K2's libraries)
_LIBRARY: Dict[str, str] = {
    "hstu_mha_fwd_bf16": "hstu_mha_fwd",
    "hstu_mha_bwd_fused_bf16": "hstu_mha_bwd_fused",
}
Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
_DENSE_TYPES = (torch.float32, torch.bfloat16)  # K1's and K2's; K3, K4 and K5 take float32
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
    mask: Optional[torch.Tensor] = None,  # bool [B or 1, N, N]; None: causal
    bias: Optional[torch.Tensor] = None,  # [B or 1, N, N], added before silu
    dropout_pr: float = 0.0,
    dropout_gen: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Dense HSTU multi-head attention over an explicit mask, in float32
    (port of `generative_recommenders_tpu/ops/xla/hstu_attention.py:
    hstu_mha_dense`); returns [B, N, H, V]. With ``dropout_pr`` > 0 each
    masked weight is kept with probability 1 - ``dropout_pr`` (drawn from
    ``dropout_gen``) and scaled by 1 / (1 - dropout_pr), after the mask, as the JAX
    function does; no kernel computes that."""
    N = q.shape[1]
    scores = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * alpha
    if bias is not None:
        scores = scores + bias[:, None, :, :].float()
    p = F.silu(scores) / max_seq_len
    if mask is None:
        mask = torch.ones((N, N), dtype=torch.bool, device=q.device).tril()[None]
    p = p * mask[:, None, :, :].to(p.dtype)
    if dropout_pr > 0.0:
        if dropout_gen is None:
            raise ValueError("attention dropout needs a torch.Generator")
        keep = torch.rand(p.shape, generator=dropout_gen, device=p.device) < 1.0 - dropout_pr
        p = torch.where(keep, p / (1.0 - dropout_pr), 0.0)
    out = torch.einsum("bhnm,bmhv->bnhv", p, v.float())
    return out.to(v.dtype)


def _plain_mask(N: int, lengths: torch.Tensor, kw: dict) -> torch.Tensor:
    """The spec mask AND row/col < length, bool [B, N, N] (``kw``: the
    kernels' mask keywords)."""
    return apply_padding_guard(
        make_valid_attn_mask(
            N, lengths, causal=kw["causal"], num_targets=kw["num_targets"],
            max_attn_len=kw["max_attn_len"], contextual_seq_len=kw["contextual_seq_len"],
            min_full_attn_seq_len=kw["min_full_attn_seq_len"],
        ),
        lengths,
    )


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, as float32."""
    return x.to(torch.bfloat16).float()


def _bf16_scalar(x: float) -> float:
    """A Python float as it meets a bfloat16 array in JAX: a weakly typed
    scalar, rounded to bfloat16 first."""
    return _bf16(torch.tensor(x)).item()


def _scaled_q(q: torch.Tensor, alpha: float) -> torch.Tensor:
    """alpha q rounded to bfloat16, as float32: the Pallas kernels' bfloat16
    product (q as it is where alpha is 1)."""
    return q.float() if alpha == 1.0 else _bf16(q.float() * _bf16_scalar(alpha))


def _dense_fwd_plain_bf16(q, k, v, lengths, kw) -> torch.Tensor:
    """K1-bf16's function: S = (alpha q) k^T in float32 from bfloat16
    inputs, P = silu(S) * mask rounded to bfloat16, O = (P V) / norm in
    float32, returned as bfloat16."""
    N = q.shape[1]
    mask = _plain_mask(N, lengths, kw)
    s = torch.einsum("bnhd,bmhd->bhnm", _scaled_q(q, kw["alpha"]), k.float())
    p = _bf16(torch.where(mask[:, None], F.silu(s), 0.0))
    out = torch.einsum("bhnm,bmhv->bnhv", p, v.float()) * (1.0 / (kw["max_seq_len"] or N))
    return out.to(torch.bfloat16)


def _dense_bwd_plain_bf16(q, k, v, lengths, do, kw) -> Grads:
    """K2-bf16's function, written out: dO / norm rounded to bfloat16 (1 /
    norm itself in bfloat16, the Pallas kernel's weakly typed scalar), dV =
    bf16(P)^T dO, dP = dO V^T and dS = dP * dsilu in float32, dK = bf16(dS)^T
    (alpha q), dQ = alpha bf16(dS) K; all three returned as bfloat16."""
    N = q.shape[1]
    mask = _plain_mask(N, lengths, kw)[:, None]
    qs = _scaled_q(q, kw["alpha"])
    dob = _bf16(do.float() * _bf16_scalar(1.0 / (kw["max_seq_len"] or N)))
    s = torch.einsum("bnhd,bmhd->bhnm", qs, k.float())
    sig = torch.sigmoid(s)
    p = torch.where(mask, s * sig, 0.0)
    dv = torch.einsum("bhnm,bnhv->bmhv", _bf16(p), dob)
    dp = torch.einsum("bnhv,bmhv->bhnm", dob, v.float())
    ds16 = _bf16(torch.where(mask, dp * sig * (1.0 + s * (1.0 - sig)), 0.0))
    dk = torch.einsum("bhnm,bnhd->bmhd", ds16, qs)
    dq = torch.einsum("bhnm,bmhd->bnhd", ds16, k.float()) * kw["alpha"]
    return dq.to(torch.bfloat16), dk.to(torch.bfloat16), dv.to(torch.bfloat16)


class _DensePlainBf16(torch.autograd.Function):
    """The bfloat16 plain version, forward and backward at the kernels'
    rounding points; gradients for q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, kw):
        ctx.save_for_backward(q, k, v, lengths)
        ctx.kw = kw
        return _dense_fwd_plain_bf16(q, k, v, lengths, kw)

    @staticmethod
    def backward(ctx, do):
        q, k, v, lengths = ctx.saved_tensors
        return (*_dense_bwd_plain_bf16(q, k, v, lengths, do, ctx.kw), None, None)


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
    then `hstu_mha_dense`. Rows >= length come out 0. Differentiable in q, k
    and v: in float32 by autograd, whose gradient is the plain backward; in
    bfloat16 through `_DensePlainBf16`, at the kernels' rounding points."""
    kw = _dense_kw(alpha, max_seq_len, causal, num_targets, max_attn_len,
                   contextual_seq_len, min_full_attn_seq_len)
    if q.dtype == torch.bfloat16:
        return _DensePlainBf16.apply(q, k, v, lengths, kw)
    N = q.shape[1]
    return hstu_mha_dense(q, k, v, alpha=alpha, max_seq_len=max_seq_len or N, mask=_plain_mask(N, lengths, kw))


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
    by autograd (in bfloat16 through `_DensePlainBf16`'s written-out
    backward). Rows and columns >= length get exact zeros."""
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
def _check(
    name: str, t: torch.Tensor, ndim: int, device: torch.device,
    dtypes: Tuple[torch.dtype, ...] = (torch.float32,),
) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        allowed = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(f"{name} must be {allowed} (the kernels' types), got {t.dtype}")
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


def _check_qkv(q, k, v, dtypes: Tuple[torch.dtype, ...] = (torch.float32,)) -> torch.device:
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CPU or CUDA tensors, got {device}")
    _check("q", q, 4, device, dtypes)
    for name, t in (("k", k), ("v", v)):  # q's type
        _check(name, t, 4, device, (q.dtype,))
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
    """Calls the C entry point ``name``, in the library of the kernel of
    that name or of the one `_LIBRARY` gives; raises on a nonzero
    cudaGetLastError() from the launch."""
    fn = getattr(load(_LIBRARY.get(name, name)), name)
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


# The tiling of K1's and K6's shared forward body (csrc/hstu_attention_fwd.cuh),
# float32 and bfloat16 alike (a bfloat16 tile is converted to float32 on its
# way into shared memory): padded width -> (warps per block, each with 16
# query rows; heads per block; key columns per tile)
_FWD_TILING = {32: (8, 2, 32), 64: (8, 2, 32), 128: (4, 1, 32), 256: (4, 1, 16)}
_MAX_SHARED_BYTES = 232448
_MAX_GRID_X = 2**31 - 1


def _fwd_plan(D: int, V: int, H: int, Nm: int, NB: int, relbias: bool, B: int = 1, N: int = 1) -> dict:
    """K1's and K6's launch: the width both D and V are padded to (the next
    of 32, 64, 128, or 256 for D > 128; V at most 128), the heads a block
    loops inside (a group of 2 or 1), the head groups (H need not be a
    multiple), the key columns per tile, the block's shared memory (Q of the
    group at a pitch of W + 8; two stages of a K tile at W + 8 and a V tile
    at V's width + 4; K6's two tables and the row's timestamps) and the
    one-dimensional grid of (query tile, head group, batch row) blocks, one
    warp per 16 query rows. Raises on what the kernel does not take."""
    if not (0 < D <= _MAX_D and 0 < V <= _MAX_V):
        raise ValueError(f"the forward kernels take D <= {_MAX_D} and V <= {_MAX_V}; got D={D}, V={V}")
    width = next(w for w in (32, 64, 128, 256) if max(D, V) <= w)
    warps, head_group, key_tile = _FWD_TILING[width]
    rows = 16 * warps
    vw = min(width, _MAX_V)
    tiles = head_group * rows * (width + 8) + 2 * key_tile * (width + 8 + vw + 4)
    tables = (2 * Nm - 1 + NB + 1 + -(-N // key_tile) * key_tile) if relbias else 0
    shared_bytes = 4 * (tiles + tables)
    if shared_bytes > _MAX_SHARED_BYTES:
        raise ValueError(
            f"the relative-bias forward kernel needs {shared_bytes} bytes of shared memory "
            f"({4 * tiles} of tiles at width {width}, {4 * tables} of tables and timestamps for "
            f"Nm={Nm}, NB={NB}, N={N}); a block has {_MAX_SHARED_BYTES}"
        )
    head_groups = -(-H // head_group)
    blocks = -(-N // rows) * head_groups * B
    if blocks > _MAX_GRID_X:
        raise ValueError(f"the forward kernel's grid of {blocks} blocks exceeds {_MAX_GRID_X}: split the batch")
    return dict(width=width, query_rows=rows, head_group=head_group, head_groups=head_groups,
                key_tile=key_tile, shared_bytes=shared_bytes, grid=(blocks,))


# The tiling of K2's and K4's shared backward body
# (csrc/hstu_attention_bwd_dkv.cuh), K2-bf16's too: padded width -> (query
# rows per step, key columns per block); one head a block, 16 warps
_BWD_TILING = {32: (64, 64), 64: (64, 64), 128: (32, 64), 256: (32, 64)}


def _bwd_plan(D: int, V: int, H: int, B: int, N: int) -> dict:
    """K2's and K4's launch: the width both D and V are padded to (the next
    of 32, 64, 128, or 256 for D > 128; V at most 128), the query rows of a
    step of the walk, the key columns of a block, one head a block, the
    block's shared memory (K and V of the key tile and two stages of Q and dO,
    at pitches of W + 8 and V's width + 8; P and dS at the key columns + 8;
    the step's live flags of 16-row and 8-column groups) and the
    one-dimensional grid of (key tile, head, batch row) blocks. Raises on
    what the kernels do not take."""
    if not (0 < D <= _MAX_D and 0 < V <= _MAX_V):
        raise ValueError(f"the backward kernels take D <= {_MAX_D} and V <= {_MAX_V}; got D={D}, V={V}")
    width = next(w for w in (32, 64, 128, 256) if max(D, V) <= w)
    rows, cols = _BWD_TILING[width]
    vw = min(width, _MAX_V)
    shared_bytes = 4 * ((cols + 2 * rows) * (width + 8 + vw + 8) + 2 * rows * (cols + 8) + rows // 16 + cols // 8)
    blocks = -(-N // cols) * H * B
    if blocks > _MAX_GRID_X:
        raise ValueError(f"the backward kernels' grid of {blocks} blocks exceeds {_MAX_GRID_X}: split the batch")
    return dict(width=width, query_rows=rows, key_cols=cols, head_group=1, shared_bytes=shared_bytes,
                grid=(blocks,))


# The tiling of K3's body (csrc/hstu_attention_bwd_dq.cuh): padded width ->
# (query rows per block, key columns per step); one head a block, 16 warps
_DQ_TILING = {32: (64, 64), 64: (64, 64), 128: (64, 64), 256: (64, 32)}


def _dq_plan(D: int, V: int, H: int, B: int, N: int) -> dict:
    """K3's launch: the width both D and V are padded to (the next of 32, 64,
    128, or 256 for D > 128; V at most 128), the query rows of a block, the
    key columns of a step of the walk, one head a block, the block's shared
    memory (Q and dO of the query tile and two stages of K and V, at pitches
    of W + 8 and V's width + 8; dS at the key columns + 8; the step's live
    flags of 16-row groups) and the one-dimensional grid of (query tile,
    head, batch row) blocks. Raises on what the kernel does not take."""
    if not (0 < D <= _MAX_D and 0 < V <= _MAX_V):
        raise ValueError(f"the backward kernels take D <= {_MAX_D} and V <= {_MAX_V}; got D={D}, V={V}")
    width = next(w for w in (32, 64, 128, 256) if max(D, V) <= w)
    rows, cols = _DQ_TILING[width]
    vw = min(width, _MAX_V)
    shared_bytes = 4 * ((rows + 2 * cols) * (width + 8 + vw + 8) + rows * (cols + 8) + rows // 16)
    blocks = -(-N // rows) * H * B
    if blocks > _MAX_GRID_X:
        raise ValueError(f"the dq backward kernel's grid of {blocks} blocks exceeds {_MAX_GRID_X}: split the batch")
    return dict(width=width, query_rows=rows, key_cols=cols, head_group=1, shared_bytes=shared_bytes,
                grid=(blocks,))


def _dense_fwd(q, k, v, lens, nt, kw: dict) -> torch.Tensor:
    """Launches K1, or K1-bf16 on bfloat16, on checked CUDA tensors (lens,
    nt: int32 or nt None)."""
    B, N, H, D = q.shape
    V = v.shape[3]
    bf16 = q.dtype == torch.bfloat16
    out = torch.empty((B, N, H, V), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    # raises on what the kernel does not take; the bfloat16 instance tiles as
    # the float32 one
    _fwd_plan(D, V, H, 0, 0, False, B, N)
    _launch(
        "hstu_mha_fwd_bf16" if bf16 else "hstu_mha_fwd",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lens.data_ptr(), None if nt is None else nt.data_ptr(),
        B, N, H, D, V, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *_mask_args(kw, N), _stream(q.device),
    )
    (hstu_mha_dense_cuda.launches_bf16 if bf16 else hstu_mha_dense_cuda.launches).add()
    return out


class _HstuMhaDense(torch.autograd.Function):
    """K1 forward; backward by K2, or by K3 then K4 under
    ``torch.use_deterministic_algorithms(True)``; on bfloat16 K1-bf16 and
    K2-bf16, which has no split yet (`hstu_mha_bwd_cuda` refuses it). Saves
    q, k and v as they are (views of the uvqk projection on the STU path)."""

    @staticmethod
    def forward(ctx, q, k, v, lens, nt, kw):
        ctx.save_for_backward(q, k, v, lens, nt)
        ctx.kw = kw
        return _dense_fwd(q, k, v, lens, nt, kw)

    @staticmethod
    def backward(ctx, do):
        q, k, v, lens, nt = ctx.saved_tensors
        dq, dk, dv = hstu_mha_bwd_cuda(q, k, v, lens, do, split=torch.are_deterministic_algorithms_enabled(),
                                       num_targets=nt, **ctx.kw)
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
    dead, their outputs 0). Returns [B, N, H, V] of q's type (float32 or
    bfloat16), differentiable in q, k and v. The optional [B, N, N] ``bias``
    of the TPU kernel is not ported yet and raises."""
    if bias is not None:
        raise NotImplementedError("the additive [B, N, N] bias is not ported yet")
    kw = _dense_kw(alpha, max_seq_len, causal, num_targets, max_attn_len,
                   contextual_seq_len, min_full_attn_seq_len)
    if q.device.type == "cpu":
        return hstu_mha_dense_plain(q, k, v, lengths, **kw)
    device = _check_qkv(q, k, v, _DENSE_TYPES)
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
    int32 or nt None; do contiguous in its last dim, of q's type) and counts
    it. Returns (dq, dk, dv), None for the outputs the kernel does not
    write."""
    B, N, H, D = q.shape
    V = v.shape[3]
    bf16 = name == "hstu_mha_bwd_fused_bf16"
    new = lambda shape, zero=False, dtype=q.dtype: (torch.zeros if zero else torch.empty)(  # noqa: E731
        shape, dtype=dtype, device=q.device
    )
    # K2 adds its dq shares into a zeroed float32 buffer with atomics, which
    # K2-bf16 then writes as bfloat16
    dq32 = new((B, N, H, D), zero=True, dtype=torch.float32) if bf16 else None
    dq = None if name == "hstu_mha_bwd_dkv" else new((B, N, H, D), zero=name == "hstu_mha_bwd_fused")
    dk, dv = (None, None) if name == "hstu_mha_bwd_dq" else (new((B, N, H, D)), new((B, N, H, V)))
    if B * N * H == 0:
        return dq, dk, dv
    # raises on what the kernel does not take; K2-bf16 tiles as K2
    (_dq_plan if name == "hstu_mha_bwd_dq" else _bwd_plan)(D, V, H, B, N)
    # the kernels read q, k, v and dO in 16-byte pieces where each allows it
    # (on the STU path q, k and v are strided views of one projection)
    vec = tuple(int(_vec16(t)) for t in (q, k, v, do))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _launch(
        name,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        *((ptr(dq32),) if bf16 else ()), ptr(dq), ptr(dk), ptr(dv), lens.data_ptr(), ptr(nt),
        B, N, H, D, V, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        *_mask_args(kw, N), *vec, _stream(q.device),
    )
    (hstu_mha_bwd_cuda.launches_bf16 if bf16 else hstu_mha_bwd_cuda.launches[name]).add()
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
    every run. On bfloat16 (q, k, v and ``do``) by K2-bf16: K3 and K4 take
    float32 only, so ``split`` raises a RuntimeError there, or warns and
    takes K2-bf16 under ``torch.use_deterministic_algorithms(True,
    warn_only=True)``. ``launches`` holds one counter per float32 kernel,
    keyed by its C entry point; ``launches_bf16`` counts K2-bf16."""
    kw = _dense_kw(alpha, max_seq_len, causal, num_targets, max_attn_len,
                   contextual_seq_len, min_full_attn_seq_len)
    if q.device.type == "cpu":
        return hstu_mha_bwd_plain(q, k, v, lengths, do, **kw)
    device = _check_qkv(q, k, v, _DENSE_TYPES)
    B, N, H, _ = q.shape
    if k.shape[1] != N or do.shape != (B, N, H, v.shape[3]):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, do {tuple(do.shape)}"
        )
    do = _last_dim_contiguous(do)
    _check("do", do, 4, device, (q.dtype,))
    lens = _int_vector("lengths", lengths, B, device)
    nt = None if num_targets is None else _int_vector("num_targets", num_targets, B, device)
    if q.dtype == torch.bfloat16:
        if split:
            msg = (
                "hstu_mha_bwd_cuda does not have a deterministic implementation on bfloat16: "
                "kernel K2-bf16 sums dq with atomicAdd, and the split backward K3 + K4 is not "
                "built for bfloat16 yet (K3/K4-bf16). Turn it off for this operation with "
                "torch.use_deterministic_algorithms(False), or only warn with warn_only=True."
            )
            if not torch.is_deterministic_algorithms_warn_only_enabled():
                raise RuntimeError(msg)
            warnings.warn(msg)
        return _bwd_kernel("hstu_mha_bwd_fused_bf16", q, k, v, lens, nt, do, kw)
    if not split:
        return _bwd_kernel("hstu_mha_bwd_fused", q, k, v, lens, nt, do, kw)
    dq = _bwd_kernel("hstu_mha_bwd_dq", q, k, v, lens, nt, do, kw)[0]
    _, dk, dv = _bwd_kernel("hstu_mha_bwd_dkv", q, k, v, lens, nt, do, kw)
    return dq, dk, dv


def _vec16(t: torch.Tensor) -> bool:
    """Whether a kernel may read ``t``'s rows in pieces of 4 elements (16
    bytes of float32, 8 of bfloat16): a 16-byte aligned pointer, every
    stride but the last and the width multiples of 4 (the last stride is 1,
    `_check`)."""
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
hstu_mha_dense_cuda.launches_bf16 = LaunchCounter()
hstu_mha_bwd_cuda.launches = {
    name: LaunchCounter() for name in ("hstu_mha_bwd_fused", "hstu_mha_bwd_dq", "hstu_mha_bwd_dkv")
}
hstu_mha_bwd_cuda.launches_bf16 = LaunchCounter()
delta_hstu_mha_cuda.launches = LaunchCounter()
