"""HSTU attention with the relative position and time bias rebuilt inside
the kernel, forward and backward, with its plain PyTorch version.

Port of `generative_recommenders_tpu/ops/pallas/hstu_attention_relbias.py`:

* ``hstu_mha_dense_relbias_cuda``: kernel K6 (`csrc/hstu_mha_relbias_fwd.cu`),
  replacing `_fwd_kernel_relbias` behind `hstu_mha_dense_pallas_relbias`
  (3xTF32 products on the tensor cores, a group of heads inside one block,
  launched by `hstu_attention._fwd_plan`); on
  CUDA tensors differentiable in q, k, v, ``pos_w`` and ``ts_w`` through
* ``hstu_mha_relbias_bwd_cuda``: kernel K7 (`csrc/hstu_mha_relbias_bwd.cu`),
  replacing `_bwd_kernel_relbias` (the custom VJP `_relbias_call` becomes
  `_HstuMhaRelbias`): 3xTF32 products on the tensor cores, a group of heads
  inside one block (`_relbias_bwd_plan`), head widths up to 64; or, with
  ``deterministic``, K7-det (the same library): the same function summed in
  one fixed order (`_relbias_det_plan`).

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

bfloat16: both kernels also take bfloat16 q, k, v (and dO), the type the
JAX package's ``compute_dtype="bfloat16"`` gives the first HSTU block, with
the Pallas kernels' rounding points: S, dP and dS in float32 from exact
products, P rounded to bfloat16 before P V (forward) and P^T dO (backward),
dO entering the backward as bfloat16(dO * bfloat16(1 / norm)), dS rounded
to bfloat16 before dS^T Q and dS K, the table gradients from the float32 dS
summed over the heads; out, dq, dk and dv in bfloat16, the table gradients
in float32. Their plain versions follow the same rounding points
(`_relbias_fwd_plain_bf16`, `_relbias_bwd_plain_bf16`); autograd through a
bfloat16 forward would round dP instead. The bfloat16 kernels count their
launches in ``launches_bf16``, beside the float32 kernels' ``launches``,
and take ``alpha = 1`` only (the TPU kernel rounds alpha q to bfloat16 in
the kernel; the research model's alpha is 1).

K7 sums dq, ``dpos_w`` and ``dts_w`` with atomics, in an order that changes
from run to run. The Pallas kernel keeps those sums in VMEM over a
sequential grid, so every run of the JAX package gives the same bits; K7-det
does too, by passes instead of atomics: dq by K3's body with the bias (one
block per query tile, dq in registers), dk, dv and each block's table sums
by K7's body without dq (the sums to the block's own row of a float32
[blocks, (2 Nm - 1) + (NB + 1)] buffer), and the rows added entry by entry
in block order. Under ``torch.use_deterministic_algorithms(True)`` the
autograd function takes K7-det, in float32 and bfloat16 alike; it counts
its launches in ``launches_det`` and ``launches_det_bf16``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from generative_recommenders_tpu_torch.ops.cuda import hstu_attention as ha
from generative_recommenders_tpu_torch.ops.cuda.build import LaunchCounter

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signatures of the entry points (csrc/hstu_mha_relbias_*.cu)
ha._ARGTYPES.update({
    "hstu_mha_relbias_fwd": [_P] * 9 + [_I] * 5 + [_L] * 9 + [_F, _F] + [_I] * 6 + [_P],
    "hstu_mha_relbias_fwd_bf16": [_P] * 9 + [_I] * 5 + [_L] * 9 + [_F, _F] + [_I] * 6 + [_P],
    "hstu_mha_relbias_bwd": [_P] * 14 + [_I] * 5 + [_L] * 12 + [_F, _F] + [_I] * 10 + [_P],
    # one more pointer: dq's float32 sums beside the bfloat16 dq
    "hstu_mha_relbias_bwd_bf16": [_P] * 15 + [_I] * 5 + [_L] * 12 + [_F, _F] + [_I] * 10 + [_P],
    # one more pointer: the blocks' table sums
    **{
        name: [_P] * 15 + [_I] * 5 + [_L] * 12 + [_F, _F] + [_I] * 10 + [_P]
        for name in ("hstu_mha_relbias_bwd_det", "hstu_mha_relbias_bwd_det_bf16")
    },
})
# the bfloat16 kernels and K7-det are second entry points of K6's and K7's
# libraries
ha._LIBRARY.update({
    "hstu_mha_relbias_fwd_bf16": "hstu_mha_relbias_fwd",
    **{name: "hstu_mha_relbias_bwd" for name in
       ("hstu_mha_relbias_bwd_bf16", "hstu_mha_relbias_bwd_det", "hstu_mha_relbias_bwd_det_bf16")},
})
# K7's tiling (csrc/hstu_mha_relbias_bwd.cu): 64 x 64 tile pairs, every tile
# at a pitch of its width + 8; a Hopper block's shared memory
_BWD_TILE, _BWD_PITCH, _BWD_WARPS = 64, 72, 16
_MAX_BWD_WIDTH = 64
_MAX_BWD_BUCKETS = 65535
_MAX_SHARED_BYTES = ha._MAX_SHARED_BYTES
_INV_LOG_BASE = 1.0 / 0.301  # bucket(x) = floor(ln(x) / 0.301)
RelbiasGrads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


# -------------------------------------------------------------- plain version
def relative_bias_indices(
    timestamps: torch.Tensor,  # [B, N], integer or float
    table_len: int,  # Nm: pos_w holds 2 * Nm - 1 entries
    num_buckets: int,
    row_idx: Optional[torch.Tensor] = None,  # int[B, M]: the rows wanted; None = all N
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rel, bucket): the bias rows' indices into ``pos_w`` and ``ts_w``,
    [1 or B, M, N] and [B, M, N] (M = N without ``row_idx``). The one home of
    the bias rule the kernels rebuild: rel = clip(j - i + Nm - 1), bucket =
    clip(floor(ln(max(|ts[min(i + 1, N - 1)] - ts[j]|, 1)) / 0.301))."""
    N = timestamps.shape[1]
    cols = torch.arange(N, device=timestamps.device)
    rows = cols[None, :] if row_idx is None else row_idx.long()
    rel = (cols[None, None, :] - rows[:, :, None] + table_len - 1).clamp(0, 2 * table_len - 2)
    ts = timestamps.to(torch.float32)
    # row i reads ts[i + 1]
    ts_next = torch.gather(ts, 1, (rows + 1).clamp_max(N - 1).expand(ts.shape[0], -1))
    dt = ts_next[:, :, None] - ts[:, None, :]
    bucket = torch.floor(torch.log(dt.abs().clamp_min(1.0)) * _INV_LOG_BASE)
    return rel, bucket.clamp(0, num_buckets).long()


def relative_bias_plain(
    timestamps: torch.Tensor,  # [B, N], integer or float
    pos_w: torch.Tensor,  # float32 [2 * Nm - 1]
    ts_w: torch.Tensor,  # float32 [num_buckets + 1]
    num_buckets: int,
    row_idx: Optional[torch.Tensor] = None,  # int[B, M]: the rows wanted; None = all N
) -> torch.Tensor:
    """The bias, materialised: [B, N, N], or [B, M, N] at ``row_idx`` (port
    of `models/hstu.py:RelativeBucketedTimeAndPositionBasedBias` with the
    kernel's bucket form)."""
    rel, bucket = relative_bias_indices(timestamps, (pos_w.shape[0] + 1) // 2, num_buckets, row_idx)
    return pos_w[rel] + ts_w[bucket]


_plain_mask, _bf16 = ha._plain_mask, ha._bf16


def _check_bf16_alpha(alpha: float) -> None:
    if alpha != 1.0:
        raise ValueError(
            f"the bfloat16 relative-bias attention takes alpha = 1 (got {alpha}): the TPU kernel "
            "rounds alpha * q to bfloat16, which the port does not"
        )


def _relbias_fwd_plain_bf16(q, k, v, lengths, timestamps, pos_w, ts_w, num_buckets, kw) -> torch.Tensor:
    """K6's bfloat16 function: S = q k^T + bias in float32 from bfloat16
    inputs, P = silu(S) * mask rounded to bfloat16, O = (P V) / norm in
    float32, returned as bfloat16."""
    _check_bf16_alpha(kw["alpha"])
    N = q.shape[1]
    mask = _plain_mask(N, lengths, kw)
    bias = relative_bias_plain(timestamps, pos_w, ts_w, num_buckets)
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) + bias[:, None]
    p = _bf16(torch.where(mask[:, None], F.silu(s), 0.0))
    out = torch.einsum("bhnm,bmhv->bnhv", p, v.float()) * (1.0 / (kw["max_seq_len"] or N))
    return out.to(torch.bfloat16)


def _relbias_bwd_plain_bf16(q, k, v, lengths, timestamps, pos_w, ts_w, do, num_buckets, kw) -> RelbiasGrads:
    """K7's bfloat16 function, written out: dO / norm rounded to bfloat16
    (with 1 / norm itself in bfloat16, the Pallas kernel's weakly typed
    scalar), dV = bf16(P)^T dO, dP = dO V^T and dS = dP * dsilu in float32,
    dK = bf16(dS)^T Q, dQ = bf16(dS) K, the table gradients from the float32
    dS summed over the heads."""
    _check_bf16_alpha(kw["alpha"])
    N = q.shape[1]
    mask = _plain_mask(N, lengths, kw)[:, None]
    inv_norm = ha._bf16_scalar(1.0 / (kw["max_seq_len"] or N))
    dob = _bf16(do.float() * inv_norm)
    with torch.enable_grad():
        tables = [t.detach().float().requires_grad_(True) for t in (pos_w, ts_w)]
        bias = relative_bias_plain(timestamps, *tables, num_buckets)
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) + bias.detach()[:, None]
    sig = torch.sigmoid(s)
    p = torch.where(mask, s * sig, 0.0)
    dv = torch.einsum("bhnm,bnhv->bmhv", _bf16(p), dob)
    dp = torch.einsum("bnhv,bmhv->bhnm", dob, v.float())
    ds = torch.where(mask, dp * sig * (1.0 + s * (1.0 - sig)), 0.0)
    ds16 = _bf16(ds)
    dk = torch.einsum("bhnm,bnhd->bmhd", ds16, q.float())
    dq = torch.einsum("bhnm,bmhd->bnhd", ds16, k.float())
    dpos, dts = torch.autograd.grad(bias, tables, ds.sum(1))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dpos, dts


class _RelbiasPlainBf16(torch.autograd.Function):
    """The bfloat16 plain version, forward and backward at the kernels'
    rounding points; gradients for q, k, v, ``pos_w`` and ``ts_w``."""

    @staticmethod
    def forward(ctx, q, k, v, pos_w, ts_w, lengths, timestamps, num_buckets, kw):
        ctx.save_for_backward(q, k, v, pos_w, ts_w, lengths, timestamps)
        ctx.num_buckets, ctx.kw = num_buckets, kw
        return _relbias_fwd_plain_bf16(q, k, v, lengths, timestamps, pos_w, ts_w, num_buckets, kw)

    @staticmethod
    def backward(ctx, do):
        q, k, v, pos_w, ts_w, lengths, timestamps = ctx.saved_tensors
        grads = _relbias_bwd_plain_bf16(
            q, k, v, lengths, timestamps, pos_w, ts_w, do, ctx.num_buckets, ctx.kw
        )
        return (*grads, None, None, None, None)


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
    Differentiable in q, k, v, ``pos_w`` and ``ts_w``: in float32 by
    autograd, whose gradient is the plain backward; in bfloat16 through
    `_RelbiasPlainBf16`, at the kernels' rounding points."""
    N = q.shape[1]
    kw = dict(alpha=alpha, max_seq_len=max_seq_len, causal=causal, num_targets=num_targets,
              max_attn_len=max_attn_len, contextual_seq_len=contextual_seq_len,
              min_full_attn_seq_len=min_full_attn_seq_len)
    if q.dtype == torch.bfloat16:
        return _RelbiasPlainBf16.apply(q, k, v, pos_w, ts_w, lengths, timestamps, num_buckets, kw)
    mask = _plain_mask(N, lengths, kw)
    bias = relative_bias_plain(timestamps, pos_w, ts_w, num_buckets)
    scores = torch.einsum("bnhd,bmhd->bhnm", q, k) * alpha + bias[:, None]
    p = F.silu(scores) / (max_seq_len or N)
    p = p * mask[:, None, :, :].to(p.dtype)
    return torch.einsum("bhnm,bmhv->bnhv", p, v)


def hstu_mha_relbias_bwd_plain(q, k, v, lengths, timestamps, pos_w, ts_w, do, **kw) -> RelbiasGrads:
    """K7's function in plain PyTorch: (dq, dk, dv, dpos_w, dts_w) of
    `hstu_mha_dense_relbias_plain` (same keywords) at the output gradient
    ``do``, by autograd (in bfloat16 through `_RelbiasPlainBf16`'s written-out
    backward)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v, pos_w, ts_w)]
        out = hstu_mha_dense_relbias_plain(*leaves[:3], lengths, timestamps, *leaves[3:], **kw)
        return torch.autograd.grad(out, leaves, do)


# -------------------------------------------------------------------- kernels
def _checked(q, k, v, lengths, timestamps, pos_w, ts_w, num_buckets: int, num_targets):
    """Checks the CUDA inputs of both kernels; returns the timestamps as
    contiguous float32 and lengths and num_targets as int32 (or None). q, k
    and v are float32 or bfloat16, the tables float32."""
    if q.dtype == torch.bfloat16:
        device = ha._check_qkv(q, k, v, (torch.bfloat16,))
    else:
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
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        _check_bf16_alpha(kw["alpha"])
    out = torch.empty((B, N, H, V), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    # raises on what the kernel does not take
    ha._fwd_plan(D, V, H, (pos_w.shape[0] + 1) // 2, ts_w.shape[0] - 1, True, B, N)
    ha._launch(
        "hstu_mha_relbias_fwd_bf16" if bf16 else "hstu_mha_relbias_fwd",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lens.data_ptr(), None if nt is None else nt.data_ptr(),
        ts.data_ptr(), pos_w.data_ptr(), ts_w.data_ptr(),
        B, N, H, D, V, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *ha._mask_args(kw, N), (pos_w.shape[0] + 1) // 2, ts_w.shape[0] - 1,
        ha._stream(q.device),
    )
    counters = hstu_mha_dense_relbias_cuda
    (counters.launches_bf16 if bf16 else counters.launches).add()
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


def _relbias_det_plan(D: int, V: int, H: int, B: int, N: int, Nm: int, NB: int) -> dict:
    """K7-det's launches: the dq pass on K3's body (`hstu_attention._dq_plan`:
    one block per (64-row query tile, head, batch row)) with both tables and
    the batch row's timestamps added to its shared memory; then K7's body
    without dq on K7's grid (`_relbias_bwd_plan`: (key tile, head group,
    batch row)), each block writing its table sums to its own row of the
    float32 ``partial`` buffer [blocks, (2 Nm - 1) + (NB + 1)]; then the rows
    added in block order, one CUDA block per 32 entries. Raises where K7
    does, or where the dq pass's tables do not fit."""
    bwd = _relbias_bwd_plan(D, V, H, Nm, NB)
    dq = ha._dq_plan(D, V, H, B, N)
    dq_shared = dq["shared_bytes"] + 4 * (2 * Nm - 1 + NB + 1 + N)
    if dq_shared > _MAX_SHARED_BYTES:
        raise ValueError(
            f"K7-det's dq pass needs {dq_shared} bytes of shared memory (tables and timestamps for "
            f"Nm={Nm}, NB={NB}, N={N}); a block has {_MAX_SHARED_BYTES}"
        )
    grid = (-(-N // _BWD_TILE), bwd["head_groups"], B)
    blocks = grid[0] * grid[1] * grid[2]
    entries = 2 * Nm - 1 + NB + 1
    return dict(width=bwd["width"], head_group=bwd["head_group"], dq_grid=dq["grid"],
                dq_shared_bytes=dq_shared, grid=grid, shared_bytes=bwd["shared_bytes"],
                partial_shape=(blocks, entries), sum_grid=(-(-entries // 32),))


def _relbias_bwd(q, k, v, lens, nt, ts, pos_w, ts_w, do, kw: dict, deterministic: bool = False) -> RelbiasGrads:
    """Launches K7, or K7-det with ``deterministic``, on checked CUDA tensors
    (as `_relbias_fwd`; do contiguous in its last dim, of q's type) and
    counts it. K7 sums dq (in float32) and both table gradients into zeroed
    buffers, and its bfloat16 kernel writes dq's sums as bfloat16 at its end;
    K7-det writes every output whole, in a fixed order."""
    B, N, H, D = q.shape
    V = v.shape[3]
    Nm, NB = (pos_w.shape[0] + 1) // 2, ts_w.shape[0] - 1
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        _check_bf16_alpha(kw["alpha"])
    # raises on what the kernels do not take
    plan = (_relbias_det_plan(D, V, H, B, N, Nm, NB) if deterministic else _relbias_bwd_plan(D, V, H, Nm, NB))
    new = lambda fn, *shape, dtype=torch.float32: fn(shape, dtype=dtype, device=q.device)  # noqa: E731
    dk, dv = new(torch.empty, B, N, H, D, dtype=q.dtype), new(torch.empty, B, N, H, V, dtype=q.dtype)
    if deterministic:
        dq = new(torch.empty, B, N, H, D, dtype=q.dtype)
        dpos, dts = new(torch.empty, pos_w.shape[0]), new(torch.empty, ts_w.shape[0])
        if B * N * H == 0:
            return dq, dk, dv, dpos.zero_(), dts.zero_()
        partial = new(torch.empty, *plan["partial_shape"])
        name = "hstu_mha_relbias_bwd_det_bf16" if bf16 else "hstu_mha_relbias_bwd_det"
        dq_ptrs, tail = (dq.data_ptr(),), (partial.data_ptr(),)
    else:
        dq32 = new(torch.zeros, B, N, H, D)
        dq = new(torch.empty, B, N, H, D, dtype=q.dtype) if bf16 else dq32
        dpos, dts = new(torch.zeros, pos_w.shape[0]), new(torch.zeros, ts_w.shape[0])
        if B * N * H == 0:
            return dq, dk, dv, dpos, dts
        name = "hstu_mha_relbias_bwd_bf16" if bf16 else "hstu_mha_relbias_bwd"
        dq_ptrs, tail = ((dq32.data_ptr(), dq.data_ptr()) if bf16 else (dq.data_ptr(),)), ()
    ha._launch(
        name,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        *dq_ptrs, dk.data_ptr(), dv.data_ptr(),
        lens.data_ptr(), None if nt is None else nt.data_ptr(),
        ts.data_ptr(), pos_w.data_ptr(), ts_w.data_ptr(), dpos.data_ptr(), dts.data_ptr(), *tail,
        B, N, H, D, V, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        *ha._mask_args(kw, N), Nm, NB,
        *(int(ha._vec16(t)) for t in (q, k, v, do)), ha._stream(q.device),
    )
    c = hstu_mha_relbias_bwd_cuda
    {
        (False, False): c.launches, (True, False): c.launches_bf16,
        (False, True): c.launches_det, (True, True): c.launches_det_bf16,
    }[bf16, deterministic].add()
    return dq, dk, dv, dpos, dts


class _HstuMhaRelbias(torch.autograd.Function):
    """K6 forward, K7 backward, or K7-det under
    ``torch.use_deterministic_algorithms(True)``: gradients for q, k, v,
    ``pos_w`` and ``ts_w``, none for the timestamps and the lengths. Saves q,
    k and v as they are (views of the uvqk projection on the STU path)."""

    @staticmethod
    def forward(ctx, q, k, v, pos_w, ts_w, ts, lens, nt, kw):
        ctx.save_for_backward(q, k, v, pos_w, ts_w, ts, lens, nt)
        ctx.kw = kw
        return _relbias_fwd(q, k, v, lens, nt, ts, pos_w, ts_w, kw)

    @staticmethod
    def backward(ctx, do):
        q, k, v, pos_w, ts_w, ts, lens, nt = ctx.saved_tensors
        grads = hstu_mha_relbias_bwd_cuda(
            q, k, v, lens, ts, pos_w, ts_w, do, num_targets=nt,
            num_buckets=ts_w.shape[0] - 1,
            deterministic=torch.are_deterministic_algorithms_enabled(), **ctx.kw,
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
    deterministic: bool = False,
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
    ``do``, by kernel K7, whose dq and table gradients are summed with
    atomics, so their last bits vary from run to run (dk and dv are the same
    bits every run); or, with ``deterministic``, by K7-det, every output the
    same bits every run. Heads wider than 64, or tables that do not fit a
    block's shared memory beside the tiles, raise. CPU tensors go through
    the plain backward."""
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
    ha._check("do", do, 4, q.device, (q.dtype,))
    kw.pop("num_targets")
    return _relbias_bwd(q, k, v, lens, nt, ts, pos_w, ts_w, do, kw, deterministic)


hstu_mha_dense_relbias_cuda.launches = LaunchCounter()
hstu_mha_dense_relbias_cuda.launches_bf16 = LaunchCounter()
hstu_mha_relbias_bwd_cuda.launches = LaunchCounter()
hstu_mha_relbias_bwd_cuda.launches_bf16 = LaunchCounter()
hstu_mha_relbias_bwd_cuda.launches_det = LaunchCounter()
hstu_mha_relbias_bwd_cuda.launches_det_bf16 = LaunchCounter()
