"""HSTU attention kernels for Hopper, with their plain PyTorch versions.

Port of `generative_recommenders_tpu/ops/pallas/hstu_attention.py`:

* ``hstu_mha_dense_cuda``: kernel K1 (`csrc/hstu_mha_fwd.cu`), replacing
  `_fwd_kernel_rkv` / `_fwd_kernel` behind `hstu_mha_dense_pallas`
  (3xTF32 products on the tensor cores, launched by `_fwd_plan`), and on
  CUDA tensors differentiable through the backward kernels below (the
  custom VJP `_hstu_mha_pallas_core` becomes `_HstuMhaDense`); with
  ``bias``, K1-bias (`hstu_mha_fwd_bias[_bf16]` in the same library), the
  same kernel with an additive [B or 1, N, N] bias read per live element,
  a forward-only path as in the JAX package (its gradient raises);
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
happens, in its ``launches``: a dict of counters keyed by C entry point.
The TPU wrappers' transposes, their padding of N to tile multiples, their
block-size tables and the backward's `_pack_rows`
residual packing are VMEM and lane-padding artefacts and are not ported:
the kernels read strided [B, N, H, D] views and mask the ragged edge
themselves.

bfloat16: K1 to K4 also take bfloat16 q, k, v (and dO), the types the JAX
package's ``compute_dtype="bfloat16"`` gives the first block of the
bias-free HSTU research model (``enable_relative_attention_bias=False``),
whose attention reaches `hstu_mha_dense_pallas` on bfloat16 under
``attn_kernel="pallas"`` (and ``"auto"`` at N >= 512); the relative-bias
pair K6 / K7 takes bfloat16 too (`ops/cuda/hstu_attention_relbias.py`).
The entry points ``hstu_mha_fwd_bf16``, ``hstu_mha_bwd_fused_bf16``,
``hstu_mha_bwd_dq_bf16`` and ``hstu_mha_bwd_dkv_bf16`` (K1-bf16 to K4-bf16)
keep the Pallas kernels' rounding points: alpha q rounded to bfloat16
(where alpha != 1), S, dP and dS in float32 from exact products, P rounded
to bfloat16 before P V and P^T dO, dO entering the backward as
bfloat16(dO / norm), dS rounded before dS^T (alpha q) and dS K, dq taking
one alpha at its float32 flush; out, dq, dk and dv in bfloat16. The split
K3-bf16 + K4-bf16 rounds where the fused K2-bf16 does, as `_bwd_dq_kernel`
and `_bwd_dkv_kernel` round where `_bwd_fused_kernel_rkv` does, so one
plain version serves both (`_dense_fwd_plain_bf16`, `_dense_bwd_plain_bf16`);
a bfloat16 CPU tensor goes through them; autograd through a bfloat16
forward would round dP instead. K1-bf16 (and K1-bias-bf16, K6-bf16),
K2-bf16 (and K4-bf16) and K3-bf16 run bodies of their own on the bfloat16
tensor cores (`csrc/hstu_attention_fwd_bf16.cuh`,
`csrc/hstu_attention_bwd_dkv_bf16.cuh`, `csrc/hstu_attention_bwd_dq_bf16.cuh`),
planned by `_fwd_plan`, `_bwd_plan` and `_dq_plan` on the element type: the forward cuts
a walk over the keys longer than a chunk (`_walk_chunk`) across blocks and
adds the chunks' float32 sums, kept in a scratch the wrapper allocates, in
chunk order (`_dense_fwd_chunks_bf16` models that order); the backward first
forms bfloat16(alpha q) and bfloat16(dO / norm) once per call into buffers
the wrapper allocates (`_prescaled` is that pass's plain twin). K5 takes
bfloat16 too (K5-bf16, ``delta_hstu_mha_fwd_bf16``, the second entry point
of K5's library), at
the rounding points of `_delta_fwd_kernel_rkv`: alpha q rounded to
bfloat16, P rounded to bfloat16 before P V, the output rounded once.

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
# C signatures of the entry points (csrc/*.cu); the backward kernels share
# one, which ends with the `vec_*` flags of q, k, v and dO; every one but
# K5's ends with the route of its plan (`_ROUTES`) and the stream
_ARGTYPES = {
    # after the mask ints the per-pair route's scratch, its slabs a group and
    # its splits (`_fwd_pairs_args`)
    "hstu_mha_fwd": [_P] * 6 + [_I] * 5 + [_L] * 9 + [_F, _F] + [_I] * 4 + [_P, _I, _I] + [_I, _P],
    # the bfloat16 body's scratch after out (the chunks' sums, or the per-pair
    # route's), its slabs a group and splits after the mask ints and its chunk
    # before the route
    "hstu_mha_fwd_bf16": [_P] * 7 + [_I] * 5 + [_L] * 9 + [_F, _F] + [_I] * 4 + [_I, _I] + [_I] + [_I, _P],
    # the bias pointer, its two strides and its type flag
    "hstu_mha_fwd_bias": [_P] * 7 + [_I] * 5 + [_L] * 11 + [_F, _F] + [_I] * 4 + [_P, _I, _I] + [_I] + [_I, _P],
    "hstu_mha_fwd_bias_bf16": [_P] * 8 + [_I] * 5 + [_L] * 11 + [_F, _F] + [_I] * 4 + [_I, _I] + [_I] + [_I]
    + [_I, _P],
    **{
        name: [_P] * 8 + [_I] * 6 + [_L] * 9 + [_F, _F] + [_I] * 5 + [_P]
        for name in ("delta_hstu_mha_fwd", "delta_hstu_mha_fwd_bf16")
    },
    # the mask ints, then the per-pair route's scratch, its slabs a group
    # and its splits (`_pairs_args`), then the flags
    **{
        name: [_P] * 9 + [_I] * 5 + [_L] * 12 + [_F, _F] + [_I] * 4 + [_P, _I, _I] + [_I] * 4 + [_I, _P]
        for name in ("hstu_mha_bwd_fused", "hstu_mha_bwd_dq", "hstu_mha_bwd_dkv")
    },
    # two more pointers after dO: the bfloat16 bodies' alpha q and dO / norm
    **{
        name: [_P] * 11 + [_I] * 5 + [_L] * 12 + [_F, _F] + [_I] * 4 + [_P, _I, _I] + [_I] * 4 + [_I, _P]
        for name in ("hstu_mha_bwd_dq_bf16", "hstu_mha_bwd_dkv_bf16")
    },
    # and one more: dq's float32 sums beside the bfloat16 dq
    "hstu_mha_bwd_fused_bf16": [_P] * 12 + [_I] * 5 + [_L] * 12 + [_F, _F] + [_I] * 4 + [_P, _I, _I] + [_I] * 4
    + [_I, _P],
}
# entry points that live in another kernel's library: entry -> library (the
# bfloat16 K1 to K5 and K1-bias are second entry points of K1's to K5's
# libraries)
_LIBRARY: Dict[str, str] = {
    "hstu_mha_fwd_bf16": "hstu_mha_fwd",
    "hstu_mha_fwd_bias": "hstu_mha_fwd",
    "hstu_mha_fwd_bias_bf16": "hstu_mha_fwd",
    "hstu_mha_bwd_fused_bf16": "hstu_mha_bwd_fused",
    "hstu_mha_bwd_dq_bf16": "hstu_mha_bwd_dq",
    "hstu_mha_bwd_dkv_bf16": "hstu_mha_bwd_dkv",
    "delta_hstu_mha_fwd_bf16": "delta_hstu_mha_fwd",
}
Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
_DENSE_TYPES = (torch.float32, torch.bfloat16)  # K1's to K5's (and K1-bias's bias)
# the widest heads the narrow bodies take (D up to 256 and V up to 128);
# wider ones take the wide bodies (csrc/hstu_attention_wide.cuh)
_NARROW_D, _NARROW_V = 256, 128
# K5's tiling (csrc/delta_hstu_mha_fwd.cu): key columns and query rows per
# block, V's columns per block
_DELTA_CHUNK = 64
_DELTA_ROWS = 8
_DELTA_V = 128
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


def _prescaled(x: torch.Tensor, scale: float) -> torch.Tensor:
    """bfloat16(x bfloat16(scale)), as bfloat16: alpha q and dO / norm as the
    Pallas kernels form them on bfloat16, and as the bfloat16 backward body's
    pre-scaling pass (`prescale_kernel`) writes them."""
    return (x.float() * _bf16_scalar(scale)).to(torch.bfloat16)


def _scaled_q(q: torch.Tensor, alpha: float) -> torch.Tensor:
    """alpha q rounded to bfloat16, as float32: the Pallas kernels' bfloat16
    product (q as it is where alpha is 1)."""
    return q.float() if alpha == 1.0 else _prescaled(q, alpha).float()


def _dense_fwd_plain_bf16(q, k, v, lengths, kw, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1-bf16's function: S = (alpha q) k^T in float32 from bfloat16
    inputs (plus the [B or 1, N, N] ``bias`` in float32: K1-bias's), P =
    silu(S) * mask rounded to bfloat16, O = (P V) / norm in float32,
    returned as bfloat16."""
    N = q.shape[1]
    mask = _plain_mask(N, lengths, kw)
    s = torch.einsum("bnhd,bmhd->bhnm", _scaled_q(q, kw["alpha"]), k.float())
    if bias is not None:
        s = s + bias.float()[:, None]
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
    dob = _prescaled(do, 1.0 / (kw["max_seq_len"] or N)).float()
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
    bias: Optional[torch.Tensor] = None,  # [B or 1, N, N], float32 or bfloat16
    causal: bool = True,
    num_targets: Optional[torch.Tensor] = None,
    max_attn_len: int = 0,
    contextual_seq_len: int = 0,
    min_full_attn_seq_len: int = 0,
) -> torch.Tensor:
    """K1's function in plain PyTorch (K1-bias's with ``bias``, added to S
    before silu in float32): the spec mask AND row/col < length, then
    `hstu_mha_dense`. Rows >= length come out 0. Differentiable in q, k and
    v: in float32 by autograd, whose gradient is the plain backward; in
    bfloat16 through `_DensePlainBf16`, at the kernels' rounding points (with
    a bias, which no backward kernel takes, by autograd)."""
    kw = _dense_kw(alpha, max_seq_len, causal, num_targets, max_attn_len,
                   contextual_seq_len, min_full_attn_seq_len)
    if q.dtype == torch.bfloat16:
        if bias is not None:
            return _dense_fwd_plain_bf16(q, k, v, lengths, kw, bias)
        return _DensePlainBf16.apply(q, k, v, lengths, kw)
    N = q.shape[1]
    return hstu_mha_dense(q, k, v, alpha=alpha, max_seq_len=max_seq_len or N, mask=_plain_mask(N, lengths, kw),
                          bias=bias)


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
    mask. Returns [B, M, H, V]. On bfloat16 (K5-bf16's function) at the
    rounding points of `_delta_fwd_kernel_rkv`: S = bfloat16(alpha q) k^T in
    float32, P = silu(S) * mask rounded to bfloat16, (P V) / norm in float32,
    returned as bfloat16."""
    B, M = delta_q.shape[:2]
    N = k.shape[1]
    bf16 = delta_q.dtype == torch.bfloat16
    q = _scaled_q(delta_q, alpha) if bf16 else delta_q.float()
    qk = torch.einsum("bmhd,bnhd->bhmn", q, k.float())
    if not bf16:
        qk = qk * alpha
    row_idx = seq_lengths.long()[:, None] - M + torch.arange(M, device=k.device)[None, :]
    delta_mask = make_delta_attn_mask(
        N, seq_lengths, row_idx.clamp(0, N - 1), causal=True,
        num_targets=num_targets, max_attn_len=max_attn_len,
        contextual_seq_len=contextual_seq_len,
        min_full_attn_seq_len=min_full_attn_seq_len,
    )[:, None, :, :]
    if bf16:
        p = _bf16(torch.where(delta_mask, F.silu(qk), 0.0))
        out = torch.einsum("bhmn,bnhv->bmhv", p, v.float()) * (1.0 / (norm_len or N))
        return out.to(torch.bfloat16)
    p = F.silu(qk) / (norm_len or N)
    p = p * delta_mask.to(p.dtype)
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
    _check_widths(D, v.shape[3])
    return device


def _check_widths(D: int, V: int) -> None:
    """The kernels take any head width but 0."""
    if D < 1 or V < 1:
        raise ValueError(f"the kernels take head widths of at least 1; got D={D}, V={V}")


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


def _launch_planned(plan: dict, name: str, *args) -> None:
    """`_launch`, whose error names the sizes of a wide backward's ``plan``
    (a cluster the card cannot hold is refused so, never run otherwise)."""
    try:
        _launch(name, *args)
    except RuntimeError as e:
        if "cluster" not in plan:
            raise
        raise RuntimeError(
            f"{e} (the wide backward at D={plan['d_chunks']} and V={plan['v_chunks']} chunks of {_WIDE_CHUNK}: "
            f"clusters of {plan['cluster']} blocks of {plan['chunks_per_block']} chunks, {plan['shared_bytes']} "
            f"bytes of shared memory a block, a grid of {plan['grid'][0]} blocks)"
        ) from None


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _mask_args(kw: dict, N: int) -> tuple:
    """alpha, 1 / norm, causal, max_attn_len, contextual_seq_len,
    min_full_attn_seq_len: the kernels' trailing scalar arguments."""
    return (
        kw["alpha"], 1.0 / (kw["max_seq_len"] or N), int(kw["causal"]),
        kw["max_attn_len"], kw["contextual_seq_len"], kw["min_full_attn_seq_len"],
    )


# The tiling of K1's and K6's shared forward body (csrc/hstu_attention_fwd.cuh):
# padded width -> (warps per block, each with 16 query rows; heads per
# block; key columns per tile)
_FWD_TILING = {32: (8, 2, 32), 64: (8, 2, 32), 128: (4, 1, 32), 256: (4, 1, 16)}
# The same for their bfloat16 body (csrc/hstu_attention_fwd_bf16.cuh), whose
# tiles are bfloat16 at a pitch of their width + 8
_FWD_TILING_BF16 = {32: (4, 2, 32), 64: (4, 1, 64), 128: (4, 1, 64), 256: (4, 1, 32)}
# the bfloat16 body's chunk: the key columns of a walk one block takes; a
# longer walk is cut across blocks and the chunks' float32 sums are added in
# chunk order
_FWD_CHUNK_BF16 = 512
# the most chunks a walk is cut in: a longer sequence takes longer chunks,
# which bounds the scratch ([chunks, B, N, H, V] float32)
_MAX_CHUNKS = 4
_MAX_SHARED_BYTES = 232448
_MAX_GRID_X = 2**31 - 1
# The body a launch takes, which the plans choose and the C entry points take
# as they are told (`hstu::Route`, csrc/hstu_attention.cuh): the narrow body
# (its tables staged in shared memory), the narrow body with the relative
# bias's tables read from device memory, the wide bodies on thread block
# clusters, the per-pair wide bodies (the widths no cluster takes), the
# tile forward (float32 K1 and K1-bias where `_fwd_tile` takes the widths)
_ROUTES = {"narrow": 0, "read": 1, "wide": 2, "wide_chunks": 3, "wide_tile": 4}
# The wide bodies (csrc/hstu_attention_wide.cuh): D and V in chunks (or
# tiles) of 128 columns, at a pitch of 136
_WIDE_CHUNK = 128
# The wide bodies on clusters (`hstu_wide::fwd_kernel`, `bwd_kernel`): one
# cluster of 8-warp blocks per 64-row tile, 32 key (or streamed) rows a step,
# the exchange buffers and the P (or A) tile at a pitch of 40; 16 blocks at
# most (a non-portable cluster past 8); the per-element work split across
# the blocks from a size on, repeated in each below.
# The backward: a block owns one chunk of D or V, or two where one a block
# would need more than a portable cluster's 8 blocks; split from 5 blocks.
_WIDE_BWD_ROWS, _WIDE_BWD_STEP, _WIDE_BWD_XP = 64, 32, 40
_PORTABLE_CLUSTER, _MAX_CLUSTER, _MAX_OWN, _SPLIT_FROM = 8, 16, 2, 5
# The forward: a block per chunk of V or per two chunks of D, each block's
# columns of D and of V their share rounded up to 32, in tiles of up to 128;
# 3 tiles a block at most (two of either); the per-element work split from 4
# blocks
_WIDE_FWD_ROUND, _WIDE_FWD_MAX_TILES, _WIDE_FWD_SPLIT_FROM = 32, 3, 4
# the buckets a float32 time gap reaches (`hstu_wide::kTsSlots`)
_WIDE_TS_SLOTS = 296
# The per-pair wide bodies (route ``wide_chunks``, `hstu_wide::sdp_kernel`,
# `grad_kernel`, `tables_kernel`): 64 x 64 tile pairs; the S / dP pass (the
# forward's S pass) 64 columns of D or V a step, its tiles at a pitch of 72,
# in a ring of 3 stages, split across blocks where the pairs of a group give
# fewer than 264 blocks (two an SM of the H100's 132) and each run keeps at
# least 4 steps; the gradient pass (the
# forward's P V pass) a block per 64-row output tile and 128-column chunk,
# the float32 A tile (P or dS) at a pitch of 72 and the chunk at 136, in 2
# stages; the table sums a block per key tile, the pair's dS at a pitch of
# 65, its 128 diagonal sums and 8 warps' copies of the reachable buckets.
# The [64][64] float32 tiles a pair keeps in the scratch: the forward's P, the
# backward's P and dS (`hstu_wide::kFwdMats`, `kBwdMats`).
_PAIR_TILE, _PAIR_STEP, _PAIR_PITCH, _SDP_STAGES, _GRAD_STAGES, _SPLIT_TARGET = 64, 64, 72, 3, 2, 264
_FWD_MATS, _BWD_MATS = 1, 2
# A split run's least steps: a split adds the sums pass (a launch and the
# parts' reads, about 5 us at B 1), which runs of one step did not repay
# (D 128 / V 4352, 2 steps: 0.0418 ms split 2 ways, 0.0381 unsplit) and
# runs of 7 repaid 3x (D 4352 / V 64: 0.0554 against 0.1620; NVIDIA H100,
# `variants.py --wide-chunks-fwd-variants`); at about 2 us a step a split
# saves steps (1 - 1 / splits) of them, 4 steps or more from runs of 4
_SPLIT_MIN_STEPS = 4
# The cap on a group's scratch for P (and dS) and the pairs' flags: 256 MiB, the
# size of the widest-heads ranker layer's q and k together (B 8, N 268, H 4,
# D 3968: 272 MB), so that the scratch never outgrows what the layer's own
# tensors take, and 0.3% of the H100's 80 GB; a group under it whose P and
# dS fit the 50 MB L2 stays there between the passes. The slabs past it run
# in further groups, in turn, on the same scratch; a slab larger than the
# cap is a group of its own. Where the S / dP pass is split, the partial S
# and dP add fewer than 527 pairs' worth beside it (17.3 MB).
_PAIR_SCRATCH_CAP = 256 * 2**20
# The tile forward (route ``wide_tile``, `hstu_wide::tile_fwd_kernel`): a
# block of 8 warps per 64-row query tile, 32 key rows a step; D and V
# rounded up to 32 (Dp, Vp); D up to 256 with V up to 256, D up to 128 with
# V up to 384 (the registers a lane holds of Q and O)
_TILE_ROWS, _TILE_THREADS, _TILE_STEP, _TILE_MAX_D, _TILE_MAX_V = 64, 256, 32, 256, 384


def _chunks(w: int) -> int:
    return -(-w // _WIDE_CHUNK)


def _narrow(D: int, V: int) -> bool:
    """Whether K1's to K4's own tilings take the widths."""
    return D <= _NARROW_D and V <= _NARROW_V


def _check_grid(blocks: int, what: str) -> None:
    if blocks > _MAX_GRID_X:
        raise ValueError(f"{what}'s grid of {blocks} blocks exceeds {_MAX_GRID_X}: split the batch")


def _walk_chunk(N: int, tile: int) -> int:
    """The key columns of a chunk of a walk over N: whole tiles, at least
    `_FWD_CHUNK_BF16` and enough that no walk takes more than `_MAX_CHUNKS`
    chunks."""
    return max(_FWD_CHUNK_BF16 // tile, -(-(-(-N // tile)) // _MAX_CHUNKS)) * tile


def _wide_fwd_cluster(D: int, V: int) -> Optional[Tuple[int, int, int, int, int]]:
    """The wide forward's cluster at widths D and V (`hstu_wide::fwd_cluster_of`):
    (blocks, D columns a block, V columns a block, D tiles, V tiles): a block
    per chunk of V or per two chunks of D, 16 at most; None past 3 tiles a
    block of 16 blocks."""
    cs = min(_MAX_CLUSTER, max(-(-_chunks(D) // 2), _chunks(V)))
    dw, vw = (-(-(-(-w // cs)) // _WIDE_FWD_ROUND) * _WIDE_FWD_ROUND for w in (D, V))
    md, mv = _chunks(dw), _chunks(vw)
    if md > _MAX_OWN or mv > _MAX_OWN or md + mv > _WIDE_FWD_MAX_TILES:
        return None
    return cs, dw, vw, md, mv


def _tile_width(w: int) -> int:
    return -(-w // 32) * 32


def _tile_bytes(D: int, V: int) -> int:
    """The tile forward's block's shared memory (`hstu_wide::tile_smem_bytes`):
    two stages of K [32][Dp + 8] and of V [32][Vp + 4] float32, the exchange
    of the 8 warps' parts of S [8][32][16] float32; at D past 128 Q [64][Dp
    + 8] float32 (else in registers)."""
    dp = _tile_width(D)
    return (4 * 2 * _TILE_STEP * (dp + 8 + _tile_width(V) + 4) + 4 * _TILE_THREADS * _TILE_STEP // 2
            + (4 * _TILE_ROWS * (dp + 8) if dp > _WIDE_CHUNK else 0))


def _fwd_tile(D: int, V: int, relbias: bool, dtype: torch.dtype) -> bool:
    """Whether the tile forward (route ``wide_tile``) takes the widths
    (`hstu_wide::tile_takes`): float32 K1 and K1-bias at V of 129 to 256
    with D up to 256, and V up to 384 with D up to 128."""
    return (dtype == torch.float32 and not relbias and _NARROW_V < V <= _TILE_MAX_V and D <= _TILE_MAX_D
            and (D <= _WIDE_CHUNK or V <= 2 * _WIDE_CHUNK))


def _wide_fwd_bytes(dw: int, vw: int, md: int, mv: int, elem: int, split: bool) -> int:
    """A wide forward block's shared memory: Q [md][64][pd] and two stages of
    K [2][md][32][pd] and of V [2][mv][32][pv] of the element type (``elem``
    bytes; pd and pv the block's columns + 8, 136 where they take two
    tiles), two float32 exchange buffers [2][64][40] (or, split, the receive
    buffer in their space), ``split`` the P tile [64][40] of the element
    type (else in the exchange buffers), eight warps' live flags."""
    rows, step, xp = _WIDE_BWD_ROWS, _WIDE_BWD_STEP, _WIDE_BWD_XP
    pd, pv = (min(w, _WIDE_CHUNK) + 8 for w in (dw, vw))
    return (elem * (md * rows * pd + 2 * md * step * pd + 2 * mv * step * pv + (rows * xp if split else 0))
            + 4 * (2 * rows * xp + 8))


def _fwd_plan(D: int, V: int, H: int, Nm: int, NB: int, relbias: bool, B: int = 1, N: int = 1,
              dtype: torch.dtype = torch.float32) -> dict:
    """K1's and K6's launch on q's type ``dtype``, its ``route`` the body the
    C entry point takes (`_ROUTES`). Up to D 256 and V 128 (`_narrow`, route
    ``narrow``): the width both are padded to (the next of 32, 64, 128, or 256
    for D > 128), the heads a block loops inside (a group of 2 or 1), the
    head groups (H need not be a multiple), the key columns per tile, the
    block's shared memory (Q of the group at a pitch of W + 8; two stages of
    a K tile at W + 8 and a V tile at V's width + 4; K6's two tables and the
    row's timestamps, staged where they fit, else read from device memory:
    route ``read``) and the one-dimensional grid of (query tile, head group,
    batch row) blocks, one warp per 16 query rows. On bfloat16 the bfloat16
    body's (`_FWD_TILING_BF16`; its tiles bfloat16, V's at its width + 8),
    with walks cut in chunks of ``key_chunk`` key columns (`_walk_chunk`): a
    block per (query tile, chunk, head group, batch row), the ``chunks`` of
    the longest walk, the float32 ``scratch_shape`` [chunks, B, N, H, V] of
    the chunks' sums (None with one chunk) and the ``sums_grid`` of the pass
    that adds them.
    Wider heads: float32 without the relative bias where the tile forward
    takes the widths (`_fwd_tile`: V of 129 to 256 at D up to 256, to 384 at
    D up to 128; measured faster there than both other wide bodies at every
    shape of `variants.py --wide-fwd-routes`, NVIDIA H100), route
    ``wide_tile``: one block of 8 warps per (64-row query tile, head, batch
    row), 32 key rows a step, D and V rounded up to 32 (``d_cols``,
    ``v_cols``), ``shared_bytes`` `_tile_bytes`. Else, either type: route
    ``wide``, the wide forward on thread block clusters (`_wide_fwd_cluster`):
    one cluster of ``cluster`` blocks per (64-row query tile, head, batch
    row), 32 key rows a step; block r owns D's columns [r d_cols, (r + 1)
    d_cols) in ``d_tiles`` tiles and V's [r v_cols, (r + 1) v_cols) in
    ``v_tiles``, the per-element work split across the blocks
    (``split_work``, from 4 blocks) or repeated in each; ``shared_bytes`` the
    block's on q's type. Past 3 tiles a block of 16 blocks, route
    ``wide_chunks``: the per-pair forward (`_pairs_plan` with ``forward``),
    S formed once per 64 x 64 tile pair, then O = P V a block per (query
    tile, V chunk, slab) on ``grid``. The wide
    bodies read the bias, dense or relative, into registers: K1-bias plans as
    K1. Raises on a width of 0 and on a grid beyond CUDA's."""
    _check_widths(D, V)
    if not _narrow(D, V):
        cluster = _wide_fwd_cluster(D, V)
        tiles = -(-N // _WIDE_BWD_ROWS)
        if _fwd_tile(D, V, relbias, dtype):
            blocks = tiles * H * B
            _check_grid(blocks, "the tile forward kernel")
            return dict(route="wide_tile", width=_WIDE_CHUNK, query_rows=_TILE_ROWS, key_tile=_TILE_STEP,
                        d_chunks=_chunks(D), v_chunks=_chunks(V), head_group=1, head_groups=H,
                        d_cols=_tile_width(D), v_cols=_tile_width(V), shared_bytes=_tile_bytes(D, V), grid=(blocks,))
        if cluster is None:
            return _pairs_plan("the wide forward kernel", D, V, H, B, N, _chunks(V), False, dtype, forward=True)
        cs, dw, vw, md, mv = cluster
        blocks = tiles * H * B * cs
        split = cs >= _WIDE_FWD_SPLIT_FROM
        _check_grid(blocks, f"the wide forward kernel (clusters of {cs} blocks)")
        return dict(route="wide", width=_WIDE_CHUNK, query_rows=_WIDE_BWD_ROWS, key_tile=_WIDE_BWD_STEP,
                    d_chunks=_chunks(D), v_chunks=_chunks(V), head_group=1, head_groups=H, cluster=cs, d_cols=dw,
                    v_cols=vw, d_tiles=md, v_tiles=mv, split_work=split,
                    shared_bytes=_wide_fwd_bytes(dw, vw, md, mv, dtype.itemsize, split), grid=(blocks,))
    width = next(w for w in (32, 64, 128, 256) if max(D, V) <= w)
    bf16 = dtype == torch.bfloat16
    warps, head_group, key_tile = (_FWD_TILING_BF16 if bf16 else _FWD_TILING)[width]
    rows = 16 * warps
    vw = min(width, _NARROW_V)
    tile_bytes = (2 * (head_group * rows * (width + 8) + 2 * key_tile * (width + 8 + vw + 8)) if bf16
                  else 4 * (head_group * rows * (width + 8) + 2 * key_tile * (width + 8 + vw + 4)))
    tables = (2 * Nm - 1 + NB + 1 + -(-N // key_tile) * key_tile) if relbias else 0
    read = tile_bytes + 4 * tables > _MAX_SHARED_BYTES  # a long table: read, not staged
    shared_bytes = tile_bytes + (0 if read else 4 * tables)
    head_groups = -(-H // head_group)
    blocks = -(-N // rows) * head_groups * B
    plan = dict(route="read" if read else "narrow", width=width, query_rows=rows, head_group=head_group,
                head_groups=head_groups, key_tile=key_tile, shared_bytes=shared_bytes)
    if bf16:
        chunk = _walk_chunk(N, key_tile)
        chunks = -(-N // chunk)
        blocks *= chunks
        plan.update(key_chunk=chunk, chunks=chunks,
                    scratch_shape=(chunks, B, N, H, V) if chunks > 1 else None,
                    sums_grid=(B * N,) if chunks > 1 else None)
        _check_grid(B * N, "the bfloat16 forward's sums")
    _check_grid(blocks, "the forward kernel")
    return dict(plan, grid=(blocks,))


# The tiling of K2's and K4's shared backward body
# (csrc/hstu_attention_bwd_dkv.cuh): padded width -> (query rows per step,
# key columns per block); one head a block, 16 warps
_BWD_TILING = {32: (64, 64), 64: (64, 64), 128: (32, 64), 256: (32, 64)}
# The same for their bfloat16 body (csrc/hstu_attention_bwd_dkv_bf16.cuh):
# (query rows per step, key columns per block, warps)
_BWD_TILING_BF16 = {32: (64, 64, 8), 64: (128, 64, 16), 128: (32, 64, 8), 256: (32, 64, 8)}


def _wide_cluster(D: int, V: int) -> Optional[Tuple[int, int, int]]:
    """The wide backward's cluster at widths D and V (`hstu_wide::cluster_of`):
    (chunks a block owns, D-blocks, V-blocks), or None past 16 blocks of two
    chunks (the per-pair bodies take those widths)."""
    n_dc, n_vc = _chunks(D), _chunks(V)
    for m in range(1, _MAX_OWN + 1):
        nd, nv = -(-n_dc // m), -(-n_vc // m)
        if nd + nv <= _PORTABLE_CLUSTER or (m == _MAX_OWN and nd + nv <= _MAX_CLUSTER):
            return m, nd, nv
    return None


def _wide_bwd_bytes(m: int, elem: int, tables: bool) -> int:
    """A wide backward block's shared memory: R [m][64][136] and two stages
    of X [2][m][32][136] of the element type (``elem`` bytes), two float32
    exchange buffers [2][64][40] (or, split, the receive buffer of 16
    fragments of 256 in their space), the A tile [64][40] of the element
    type, eight warps' live flags; with the table sums the float32 dS^T
    [64][40], the step's 95 diagonal sums (and one) and eight warps' copies
    of dts_w's 296 reachable buckets."""
    rows, step, xp = _WIDE_BWD_ROWS, _WIDE_BWD_STEP, _WIDE_BWD_XP
    pitch = _WIDE_CHUNK + 8
    tiles = elem * (m * rows * pitch + 2 * m * step * pitch + rows * xp) + 4 * (2 * rows * xp + 8)
    return tiles + (4 * (rows * xp + rows + step + 8 * _WIDE_TS_SLOTS) if tables else 0)


def _pairs_plan(what: str, D: int, V: int, H: int, B: int, N: int, outputs: int, tables: bool,
                dtype: torch.dtype, forward: bool = False) -> dict:
    """The per-pair wide bodies (route ``wide_chunks``): the (batch row,
    head) slabs in ``groups`` of ``group_slabs`` whose P, dS (the forward: P
    alone) and pair flags stay under `_PAIR_SCRATCH_CAP` (a slab past it
    alone), each group in turn on one float32 scratch of ``scratch_shape``:
    the S / dP pass (the forward's S pass) a block per (64 x 64 pair, split,
    slab) on ``sdp_grid``, its 64-column steps of D then V (the forward: of D)
    in ``splits`` runs (of 4 steps or more, but the last) where the group's
    pairs give fewer than 264 blocks, the runs' sums on ``sums_grid`` (else
    None); the gradient pass (the forward's
    P V pass) a block per (64-row tile, 128-column chunk, slab),
    ``output_chunks`` a tile, on ``grid`` (``shared_bytes``); ``tables``: the
    table sums a block per (key tile, slab) on ``tables_grid``; the
    backward's ``table_rows`` (K7-det's), one per key tile, head and batch
    row. Grids of the largest group; the bfloat16 backward after the
    pre-scaling pass. Raises on a grid beyond CUDA's."""
    tile, step, pitch = _PAIR_TILE, _PAIR_STEP, _PAIR_PITCH
    mats = _FWD_MATS if forward else _BWD_MATS
    qt = -(-N // tile)
    slab_bytes = 4 * (mats * qt * qt * tile * tile + qt * qt)
    group = max(1, min(B * H, _PAIR_SCRATCH_CAP // slab_bytes))
    pairs = group * qt * qt
    steps = -(-D // step) + (0 if forward else -(-V // step))
    want = min(-(-_SPLIT_TARGET // pairs), steps // _SPLIT_MIN_STEPS)
    splits = 1 if want <= 1 else -(-steps // -(-steps // want))
    floats = (mats * pairs * tile * tile + -(-pairs // 4) * 4
              + (splits * pairs * mats * tile * tile if splits > 1 else 0))
    elem = dtype.itemsize
    plan = dict(route="wide_chunks", width=_WIDE_CHUNK, d_chunks=_chunks(D), v_chunks=_chunks(V), head_group=1,
                tile=tile, groups=-(-(B * H) // group), group_slabs=group, splits=splits, scratch_shape=(floats,),
                sdp_grid=(pairs * splits,), sdp_shared_bytes=_SDP_STAGES * 2 * tile * pitch * elem,
                sums_grid=(pairs,) if splits > 1 else None, output_chunks=outputs,
                shared_bytes=_GRAD_STAGES * (4 * tile * pitch + elem * tile * (_WIDE_CHUNK + 8)),
                grid=(group * qt * outputs,))
    for name in ("sdp_grid", "grid"):
        _check_grid(plan[name][0], f"the per-pair {what.removeprefix('the ')}")
    if forward:
        return plan
    plan["table_rows"] = qt * H * B
    if tables:
        plan.update(tables_grid=(group * qt,),
                    tables_shared_bytes=4 * (tile * (tile + 1) + 2 * tile + 8 * _WIDE_TS_SLOTS))
    if dtype == torch.bfloat16:
        _check_grid(B * N, "the pre-scaling pass")
        plan.update(prescale_grid=(B * N,), q_scaled_shape=(B, N, H, D), do_scaled_shape=(B, N, H, V))
    return plan


def _wide_bwd_plan(what: str, D: int, V: int, H: int, B: int, N: int, tables: bool,
                   dtype: torch.dtype) -> dict:
    """One pass of the wide backward: a cluster of ``cluster`` blocks per
    (64-row tile, head, batch row), ``d_blocks`` owning D's chunks then
    ``v_blocks`` V's, ``chunks_per_block`` each, the per-element work split
    across them (``split_work``, from 5 blocks) or repeated in each; on
    bfloat16 after the pre-scaling pass (``prescale_grid``) into
    ``q_scaled_shape`` (where alpha != 1) and ``do_scaled_shape``. Past 16
    blocks of two chunks (route ``wide_chunks``): the per-pair backward
    (`_pairs_plan`), S and dP formed once per tile pair, then the gradient
    pass over dQ's chunks (the dq pass), dK's and dV's (the dkv pass), or all
    three with ``tables`` (K7 and K7-det, with the table sums). Raises on a
    grid beyond CUDA's."""
    cluster = _wide_cluster(D, V)
    if cluster is None:
        outputs = _chunks(D) if what == "the wide dq kernel" else _chunks(D) * (2 if tables else 1) + _chunks(V)
        return _pairs_plan(what, D, V, H, B, N, outputs, tables, dtype)
    m, nd, nv = cluster
    cs = nd + nv
    blocks = -(-N // _WIDE_BWD_ROWS) * H * B * cs
    _check_grid(blocks, f"{what} (clusters of {cs} blocks)")
    plan = dict(route="wide", width=_WIDE_CHUNK, d_chunks=_chunks(D), v_chunks=_chunks(V), head_group=1,
                cluster=cs, chunks_per_block=m, d_blocks=nd, v_blocks=nv, split_work=cs >= _SPLIT_FROM,
                shared_bytes=_wide_bwd_bytes(m, dtype.itemsize, tables), grid=(blocks,))
    if dtype == torch.bfloat16:
        _check_grid(B * N, "the pre-scaling pass")
        plan.update(prescale_grid=(B * N,), q_scaled_shape=(B, N, H, D), do_scaled_shape=(B, N, H, V))
    return plan


def _wide_dkv_plan(D: int, V: int, H: int, B: int, N: int, relbias: bool = False,
                   dtype: torch.dtype = torch.float32) -> dict:
    """The wide dkv pass (K4; K2 and K7 with dQ; K7-det's second pass): a
    cluster per (64-column key tile, head, batch row), `_wide_bwd_plan`;
    ``table_rows``: K7-det's rows of `partial`, one per block (per key tile,
    head and batch row on the per-pair route)."""
    plan = _wide_bwd_plan("the wide dkv kernel", D, V, H, B, N, relbias, dtype)
    return plan if "table_rows" in plan else dict(plan, table_rows=plan["grid"][0])


def _wide_dq_plan(D: int, V: int, H: int, B: int, N: int, dtype: torch.dtype = torch.float32) -> dict:
    """The wide dq pass (K3; K7-det's first pass): a cluster per (64-row
    query tile, head, batch row), `_wide_bwd_plan`."""
    return _wide_bwd_plan("the wide dq kernel", D, V, H, B, N, False, dtype)


def _bwd_plan(D: int, V: int, H: int, B: int, N: int, dtype: torch.dtype = torch.float32) -> dict:
    """K2's and K4's launch on q's type ``dtype``, its ``route`` the body the
    C entry points take. Up to D 256 and V 128 (route ``narrow``): the width
    both are padded to (the next of 32, 64, 128, or 256 for D > 128), the
    query rows of a step of the walk, the key columns of a block, one head a
    block, the block's shared memory (K and V of the key tile and two stages
    of Q and dO, at pitches of W + 8 and V's width + 8; P and dS at the key
    columns + 8; the step's live flags of 16-row and 8-column groups) and the
    one-dimensional grid of (key tile, head, batch row) blocks. On bfloat16
    the bfloat16 body's (`_BWD_TILING_BF16`, its tiles bfloat16, 8 or 16
    warps a block), after the pre-scaling pass (a block per batch row and row,
    ``prescale_grid``) into the bfloat16 buffers ``q_scaled_shape`` (where
    alpha != 1) and ``do_scaled_shape``. Wider heads (route ``wide``, either
    type): the wide dkv pass (K2 with its dQ; ``dq`` the wide dq pass of
    the split backward beside it), route ``wide`` on clusters or
    ``wide_chunks`` past them (K2 there: one gradient pass over dQ's, dK's
    and dV's chunks, ``fused_grid``). Raises on a width of 0 and on a grid
    beyond CUDA's."""
    _check_widths(D, V)
    if not _narrow(D, V):
        plan = dict(_wide_dkv_plan(D, V, H, B, N, dtype=dtype), dq=_wide_dq_plan(D, V, H, B, N, dtype))
        if plan["route"] == "wide_chunks":
            plan["fused_grid"] = (plan["grid"][0] + plan["dq"]["grid"][0],)
            _check_grid(plan["fused_grid"][0], "the per-pair wide fused kernel")
        return plan
    width = next(w for w in (32, 64, 128, 256) if max(D, V) <= w)
    if dtype == torch.bfloat16:
        rows, cols, warps = _BWD_TILING_BF16[width]
        vw = min(width, _NARROW_V)
        shared_bytes = 2 * ((cols + 2 * rows) * (width + 8 + vw + 8) + 2 * rows * (cols + 8)) + 4 * (rows // 16 + cols // 8)
        blocks = -(-N // cols) * H * B
        _check_grid(blocks, "the backward kernels")
        _check_grid(B * N, "the pre-scaling pass")
        return dict(route="narrow", width=width, query_rows=rows, key_cols=cols, head_group=1, warps=warps,
                    shared_bytes=shared_bytes, grid=(blocks,), prescale_grid=(B * N,), q_scaled_shape=(B, N, H, D),
                    do_scaled_shape=(B, N, H, V))
    rows, cols = _BWD_TILING[width]
    vw = min(width, _NARROW_V)
    shared_bytes = 4 * ((cols + 2 * rows) * (width + 8 + vw + 8) + 2 * rows * (cols + 8) + rows // 16 + cols // 8)
    blocks = -(-N // cols) * H * B
    _check_grid(blocks, "the backward kernels")
    return dict(route="narrow", width=width, query_rows=rows, key_cols=cols, head_group=1,
                shared_bytes=shared_bytes, grid=(blocks,))


# The tiling of K3's body (csrc/hstu_attention_bwd_dq.cuh): padded width ->
# (query rows per block, key columns per step); one head a block, 16 warps
_DQ_TILING = {32: (64, 64), 64: (64, 64), 128: (64, 64), 256: (64, 32)}
# The same for its bfloat16 body (csrc/hstu_attention_bwd_dq_bf16.cuh):
# (query rows per block, key columns per step, warps)
_DQ_TILING_BF16 = {32: (64, 64, 4), 64: (64, 64, 4), 128: (64, 32, 4), 256: (64, 32, 4)}


def _dq_plan(D: int, V: int, H: int, B: int, N: int, dtype: torch.dtype = torch.float32) -> dict:
    """K3's launch on q's type ``dtype``, its ``route`` the body the C entry
    point takes. Up to D 256 and V 128 (route ``narrow``): the width both are
    padded to (the next of 32, 64, 128, or 256 for D > 128), the query rows
    of a block, the key columns of a step of the walk, one head a block, the
    block's shared memory (Q and dO of the query tile and two stages of K and
    V, at pitches of W + 8 and V's width + 8; dS at the key columns + 8; the
    step's live flags of 16-row groups) and the one-dimensional grid of
    (query tile, head, batch row) blocks. On bfloat16 the bfloat16 body's
    (`_DQ_TILING_BF16`: its tiles bfloat16, one warp per 16 query rows, dS
    kept in registers), after the pre-scaling pass (a block per batch row
    and row, ``prescale_grid``) into the bfloat16 buffers ``q_scaled_shape``
    (where alpha != 1) and ``do_scaled_shape``. Wider heads (route ``wide``,
    either type): the wide dq pass, on clusters or per chunk. Raises on a
    width of 0 and on a grid beyond CUDA's."""
    _check_widths(D, V)
    if not _narrow(D, V):
        return _wide_dq_plan(D, V, H, B, N, dtype)
    width = next(w for w in (32, 64, 128, 256) if max(D, V) <= w)
    vw = min(width, _NARROW_V)
    if dtype == torch.bfloat16:
        rows, cols, warps = _DQ_TILING_BF16[width]
        blocks = -(-N // rows) * H * B
        _check_grid(blocks, "the dq backward kernel")
        _check_grid(B * N, "the pre-scaling pass")
        return dict(route="narrow", width=width, query_rows=rows, key_cols=cols, head_group=1, warps=warps,
                    shared_bytes=2 * (rows + 2 * cols) * (width + 8 + vw + 8), grid=(blocks,),
                    prescale_grid=(B * N,), q_scaled_shape=(B, N, H, D), do_scaled_shape=(B, N, H, V))
    rows, cols = _DQ_TILING[width]
    shared_bytes = 4 * ((rows + 2 * cols) * (width + 8 + vw + 8) + rows * (cols + 8) + rows // 16)
    blocks = -(-N // rows) * H * B
    _check_grid(blocks, "the dq backward kernel")
    return dict(route="narrow", width=width, query_rows=rows, key_cols=cols, head_group=1,
                shared_bytes=shared_bytes, grid=(blocks,))


def _dense_fwd(q, k, v, lens, nt, kw: dict, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launches K1, or K1-bf16 on bfloat16, on checked CUDA tensors (lens,
    nt: int32 or nt None); with a checked ``bias`` ([B or 1, N, N],
    contiguous in its last dim), K1-bias."""
    B, N, H, D = q.shape
    V = v.shape[3]
    bf16 = q.dtype == torch.bfloat16
    out = torch.empty((B, N, H, V), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    # raises on what the kernel does not take; the biased instances tile as
    # the others (the bias is read into registers)
    plan = _fwd_plan(D, V, H, 0, 0, False, B, N, q.dtype)
    route = plan["route"]
    name = "hstu_mha_fwd" + ("" if bias is None else "_bias") + ("_bf16" if bf16 else "")
    # the scratch of the plan (the bfloat16 entry points' after out, their
    # chunk before the route), the per-pair route's after the mask ints
    scratch = _fwd_scratch(plan, q.device)
    extra_ptr, extra_int = (((_ptr(scratch),), (plan.get("key_chunk", 0),)) if bf16 else ((), ()))
    # the bias's pointer, its batch stride (0: one bias for every row), its
    # row stride and its type
    bias_ptr, bias_strides, bias_type = (), (), ()
    if bias is not None:
        bias_ptr = (bias.data_ptr(),)
        bias_strides = (0 if bias.shape[0] == 1 else bias.stride(0), bias.stride(1))
        bias_type = (int(bias.dtype == torch.bfloat16),)
    _launch(
        name,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *extra_ptr,
        lens.data_ptr(), None if nt is None else nt.data_ptr(), *bias_ptr,
        B, N, H, D, V, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *bias_strides,
        *_mask_args(kw, N), *_fwd_pairs_args(plan, scratch, bf16), *bias_type, *extra_int, _ROUTES[route],
        _stream(q.device),
    )
    hstu_mha_dense_cuda.launches[name].add(route)
    return out


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _fwd_scratch(plan: dict, device: torch.device) -> Optional[torch.Tensor]:
    """The forward's float32 scratch, allocated here (the C code allocates
    nothing): the bfloat16 body's for the chunks' sums, or the per-pair
    route's (``wide_chunks``, either type); None where the plan takes none."""
    shape = plan.get("scratch_shape")
    return None if shape is None else torch.empty(shape, dtype=torch.float32, device=device)


def _fwd_pairs_args(plan: dict, scratch: Optional[torch.Tensor], bf16: bool) -> tuple:
    """The forward entry points' arguments after the mask ints (K6's after Nm
    and NB): the per-pair route's scratch (the float32 entry points' only:
    the bfloat16 ones take theirs after out), its slabs a group and its
    splits; elsewhere None and 0, 0."""
    pairs = (plan["group_slabs"], plan["splits"]) if plan["route"] == "wide_chunks" else (0, 0)
    return pairs if bf16 else (_ptr(scratch), *pairs)


def _dense_fwd_chunks_bf16(q, k, v, lengths, kw, plan: dict) -> torch.Tensor:
    """K1-bf16's function summed in the bfloat16 body's order, in plain
    PyTorch (a model of the kernel, for the tests; ``plan``: `_fwd_plan` on
    bfloat16): each query tile of ``query_rows`` rows walks the keys below
    its walk's end (the length; for causal attention the tile's last row
    once the tile is past the contextual rows) in chunks of ``key_chunk``
    columns; a walk of one chunk gives bfloat16(sum / norm), a longer one the
    float32 sums of its chunks added in chunk order, then bfloat16(sum /
    norm). Within a chunk the sum's order is the tensor cores', which no plain
    version repeats."""
    B, N = q.shape[:2]
    mask = _plain_mask(N, lengths, kw)
    s = torch.einsum("bnhd,bmhd->bhnm", _scaled_q(q, kw["alpha"]), k.float())
    p = _bf16(torch.where(mask[:, None], F.silu(s), 0.0))
    inv_norm = 1.0 / (kw["max_seq_len"] or N)
    rows, chunk = plan["query_rows"], plan["key_chunk"]
    out = torch.zeros(B, N, q.shape[2], v.shape[3])
    for b in range(B):
        length = min(int(lengths[b]), N)
        for q0 in range(0, length, rows):
            end = min(length, q0 + rows) if kw["causal"] and q0 >= kw["contextual_seq_len"] else length
            total = None
            for c0 in range(0, end, chunk):
                part = torch.einsum("hnm,mhv->nhv", p[b, :, q0:q0 + rows, c0:min(end, c0 + chunk)],
                                    v[b, c0:min(end, c0 + chunk)].float())
                total = part if total is None else total + part
            out[b, q0:q0 + rows] = total * inv_norm
    return out.to(torch.bfloat16)


class _HstuMhaDense(torch.autograd.Function):
    """K1 forward; backward by K2, or by K3 then K4 under
    ``torch.use_deterministic_algorithms(True)``; on bfloat16 K1-bf16 and
    K2-bf16, or K3-bf16 then K4-bf16. Saves q, k and v as they are (views of
    the uvqk projection on the STU path)."""

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


class _ForwardOnly(torch.autograd.Function):
    """The attention with an additive bias, computed by ``run`` (K1-bias on
    the card, the plain version on the CPU): forward-only, as the JAX
    package's `hstu_mha_dense_pallas(bias=...)` is (its custom VJP covers
    the bias-free call alone), so the backward raises."""

    @staticmethod
    def forward(ctx, q, k, v, bias, run):
        return run()

    @staticmethod
    def backward(ctx, do):
        raise NotImplementedError(
            "hstu_mha_dense_cuda with an additive bias is forward-only (parity and inference experiments, "
            "as hstu_mha_dense_pallas(bias=...) in the JAX package): no backward kernel takes the bias"
        )


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
    bfloat16), differentiable in q, k and v. With ``bias`` ([B or 1, N, N],
    float32 or bfloat16, added to alpha q k^T before silu) it runs K1-bias,
    forward-only: its gradient raises NotImplementedError, on the CPU too."""
    kw = _dense_kw(alpha, max_seq_len, causal, num_targets, max_attn_len,
                   contextual_seq_len, min_full_attn_seq_len)
    if q.device.type == "cpu":
        if bias is not None:
            return _ForwardOnly.apply(q, k, v, bias, lambda: hstu_mha_dense_plain(q, k, v, lengths, bias=bias, **kw))
        return hstu_mha_dense_plain(q, k, v, lengths, **kw)
    device = _check_qkv(q, k, v, _DENSE_TYPES)
    B, N = q.shape[:2]
    if k.shape[1] != N:
        raise ValueError(f"k has {k.shape[1]} rows, q has {N}")
    lens = _int_vector("lengths", lengths, B, device)
    nt = None if num_targets is None else _int_vector("num_targets", num_targets, B, device)
    kw.pop("num_targets")
    if bias is not None:
        bias = _last_dim_contiguous(bias)
        _check("bias", bias, 3, device, _DENSE_TYPES)
        if bias.shape[0] not in (1, B) or bias.shape[1:] != (N, N):
            raise ValueError(f"bias must have shape ({B} or 1, {N}, {N}), got {tuple(bias.shape)}")
        return _ForwardOnly.apply(q, k, v, bias, lambda: _dense_fwd(q, k, v, lens, nt, kw, bias))
    return _HstuMhaDense.apply(q, k, v, lens, nt, kw)


def _pairs_args(plan: dict, device: torch.device) -> Tuple[Optional[torch.Tensor], tuple]:
    """The per-pair route's scratch (``wide_chunks``: a float32 tensor of the
    plan's shape on ``device``, allocated here; the C code allocates
    nothing) and the C entry points' arguments for it: its pointer, the
    slabs a group and the splits; elsewhere None and (None, 0, 0)."""
    if plan["route"] != "wide_chunks":
        return None, (None, 0, 0)
    scratch = torch.empty(plan["scratch_shape"], dtype=torch.float32, device=device)
    return scratch, (scratch.data_ptr(), plan["group_slabs"], plan["splits"])


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
    bf16 = name.endswith("_bf16")
    kernel = name.removesuffix("_bf16")  # K2, K3 or K4
    new = lambda shape, zero=False, dtype=q.dtype: (torch.zeros if zero else torch.empty)(  # noqa: E731
        shape, dtype=dtype, device=q.device
    )
    # K2 adds its dq shares into a zeroed float32 buffer with atomics, which
    # K2-bf16 then writes as bfloat16
    fused = kernel == "hstu_mha_bwd_fused"
    split_dq = kernel == "hstu_mha_bwd_dq"
    dq32 = new((B, N, H, D), zero=True, dtype=torch.float32) if fused and bf16 else None
    dq = None if kernel == "hstu_mha_bwd_dkv" else new((B, N, H, D), zero=fused and not bf16)
    dk, dv = (None, None) if split_dq else (new((B, N, H, D)), new((B, N, H, V)))
    if B * N * H == 0:
        return dq, dk, dv
    # raises on what the kernel does not take
    plan = (_dq_plan if split_dq else _bwd_plan)(D, V, H, B, N, q.dtype)
    route = plan["route"]
    # the bfloat16 bodies (K2-bf16 and K4-bf16's, K3-bf16's, the wide
    # backward's): a pre-scaling pass writes bfloat16(alpha q) (where alpha
    # != 1) and bfloat16(dO / norm) into buffers of their own (pointers after
    # dO), and the body reads its rows in 16-byte pieces of 8 elements
    scaled = ()
    if bf16:
        qs = new(plan["q_scaled_shape"]) if kw["alpha"] != 1.0 and "q_scaled_shape" in plan else None
        scaled = (qs, new(plan["do_scaled_shape"]) if "do_scaled_shape" in plan else None)
    # the kernels read q, k, v and dO in 16-byte pieces where each allows it
    # (on the STU path q, k and v are strided views of one projection)
    vec = tuple(int(_vec16(t, 8 if bf16 else 4)) for t in (q, k, v, do))
    scratch, pairs = _pairs_args(plan, q.device)  # noqa: F841 (alive through the launch)
    _launch_planned(
        plan, name,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), *(_ptr(t) for t in scaled),
        *((_ptr(dq32),) if dq32 is not None else ()), _ptr(dq), _ptr(dk), _ptr(dv), lens.data_ptr(), _ptr(nt),
        B, N, H, D, V, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        *_mask_args(kw, N), *pairs, *vec, _ROUTES[route], _stream(q.device),
    )
    hstu_mha_bwd_cuda.launches[name].add(route)
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
    every run. On bfloat16 (q, k, v and ``do``) by their bfloat16 entry
    points, K2-bf16 or K3-bf16 then K4-bf16. ``launches`` holds one counter
    per kernel, keyed by its C entry point."""
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
    suffix = "_bf16" if q.dtype == torch.bfloat16 else ""
    if not split:
        return _bwd_kernel("hstu_mha_bwd_fused" + suffix, q, k, v, lens, nt, do, kw)
    dq = _bwd_kernel("hstu_mha_bwd_dq" + suffix, q, k, v, lens, nt, do, kw)[0]
    _, dk, dv = _bwd_kernel("hstu_mha_bwd_dkv" + suffix, q, k, v, lens, nt, do, kw)
    return dq, dk, dv


def _vec16(t: torch.Tensor, elems: int = 4) -> bool:
    """Whether a kernel may read ``t``'s rows in pieces of ``elems`` elements
    (4: 16 bytes of float32, 8 of bfloat16; 8: 16 bytes of bfloat16): a
    16-byte aligned pointer, every stride but the last and the width
    multiples of ``elems`` (the last stride is 1, `_check`)."""
    return (
        t.data_ptr() % 16 == 0
        and t.shape[-1] % elems == 0
        and all(s % elems == 0 for s in t.stride()[:-1])
    )


def _delta_plan(B: int, M: int, N: int, H: int, V: int, D: int = 1, dtype: torch.dtype = torch.float32) -> dict:
    """K5's launch: the key range in chunks of 64 columns, the M query rows
    in tiles of 8 and V in chunks of 128 columns, one block per (chunk, head
    x row tile x V chunk, batch row); the [chunks, B, M, H, V] scratch of the
    chunks' partial sums (none with one chunk: the block writes the output)
    and one arrival counter per (batch row, head, row tile, V chunk); q
    staged in shared memory up to D 256, read in chunks of 256 from device
    memory above (``wide``, an instance of the same kernel that the entry
    point picks by D). On bfloat16 (K5-bf16's kernel) a lane reads 8
    elements of a K row at once (``k_piece``: D padded to 64, 128 or 256)
    and owns 8 V columns (``v_piece``), where float32 takes 4 of each (D
    padded to 32 up to 256). Raises on a width of 0 and where the grid
    exceeds CUDA's."""
    _check_widths(D, V)
    chunks = -(-N // _DELTA_CHUNK)
    row_tiles = -(-M // _DELTA_ROWS)
    v_chunks = -(-V // _DELTA_V)
    grid = (chunks, H * row_tiles * v_chunks, B)
    if grid[1] > _MAX_GRID_YZ or grid[2] > _MAX_GRID_YZ:
        raise ValueError(
            f"K5's grid {grid} exceeds {_MAX_GRID_YZ} blocks in y or z "
            f"(B={B}, M={M}, H={H}, V={V}): split the batch"
        )
    piece = 8 if dtype == torch.bfloat16 else 4
    return dict(
        chunks=chunks, row_tiles=row_tiles, v_chunks=v_chunks, grid=grid,
        scratch_shape=(chunks, B, M, H, V) if chunks > 1 else None,
        counters=B * H * row_tiles * v_chunks, wide=D > _NARROW_D, k_piece=piece, v_piece=piece,
        # q's rows of the block as float32 (D padded to 8 lanes' pieces: 32
        # or 64 up to 256; the wide instance keeps one row of 256) and the V
        # chunk's sums of its 4 warps, in static shared memory
        shared_bytes=4 * (_DELTA_ROWS * next(w for w in (32, 64, 128, 256) if D <= w and w >= 8 * piece) if D <= _NARROW_D
                          else _NARROW_D) + 4 * 4 * _DELTA_ROWS * _DELTA_V + 4,
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
    equal the normaliser of the prefill forward. Returns [B, M, H, V] of v's
    type: float32, or bfloat16 (K5-bf16, `delta_hstu_mha_fwd_bf16`) where q,
    k and v are bfloat16."""
    kw = dict(
        alpha=alpha, num_targets=num_targets, max_attn_len=max_attn_len,
        contextual_seq_len=contextual_seq_len,
        min_full_attn_seq_len=min_full_attn_seq_len, norm_len=norm_len,
    )
    if delta_q.device.type == "cpu":
        return delta_hstu_mha_plain(delta_q, k, v, seq_lengths, **kw)
    device = _check_qkv(delta_q, k, v, _DENSE_TYPES)
    B = delta_q.shape[0]
    lens = _int_vector("seq_lengths", seq_lengths, B, device)
    nt = None if num_targets is None else _int_vector("num_targets", num_targets, B, device)
    return _delta_fwd(delta_q, k, v, lens, nt, kw)


def _delta_fwd(q, k, v, lens, nt, kw: dict) -> torch.Tensor:
    """Launches K5 (K5-bf16 on bfloat16) on checked CUDA tensors (lens, nt:
    int32 or nt None; ``kw``: `delta_hstu_mha_cuda`'s keywords but
    num_targets) and counts it under its entry point."""
    B, M, H, D = q.shape
    N, V = k.shape[1], v.shape[3]
    device = q.device
    out = torch.empty((B, M, H, V), dtype=v.dtype, device=device)
    if out.numel() == 0 or N == 0:
        return out.zero_()
    plan = _delta_plan(B, M, N, H, V, D, q.dtype)
    scratch = counters = None
    if plan["scratch_shape"] is not None:
        scratch = torch.empty(plan["scratch_shape"], dtype=torch.float32, device=device)
        counters = _delta_counter_buffer(device, plan["counters"])
    name = "delta_hstu_mha_fwd_bf16" if q.dtype == torch.bfloat16 else "delta_hstu_mha_fwd"
    _launch(
        name,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        None if counters is None else counters.data_ptr(),
        lens.data_ptr(), None if nt is None else nt.data_ptr(),
        B, M, N, H, D, V, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        kw["alpha"], 1.0 / (kw["norm_len"] or N),
        kw["max_attn_len"], kw["contextual_seq_len"], kw["min_full_attn_seq_len"],
        int(_vec16(k, plan["k_piece"])), int(_vec16(v, plan["v_piece"])), _stream(device),
    )
    delta_hstu_mha_cuda.launches[name].add()
    return out


hstu_mha_dense_cuda.launches = {
    name + sfx: LaunchCounter() for name in ("hstu_mha_fwd", "hstu_mha_fwd_bias") for sfx in ("", "_bf16")
}
hstu_mha_bwd_cuda.launches = {
    name + sfx: LaunchCounter()
    for name in ("hstu_mha_bwd_fused", "hstu_mha_bwd_dq", "hstu_mha_bwd_dkv")
    for sfx in ("", "_bf16")
}
delta_hstu_mha_cuda.launches = {name: LaunchCounter() for name in ("delta_hstu_mha_fwd", "delta_hstu_mha_fwd_bf16")}
