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
  inside one block (`_relbias_bwd_plan`), head widths up to 128 in one pass
  over the tile pairs (wider heads take the wide bodies,
  csrc/hstu_attention_wide.cuh); or, with
  ``deterministic``, K7-det (the same library): the same function summed in
  one fixed order (`_relbias_det_plan`). On bfloat16 both run a body of
  their own on the bfloat16 tensor cores
  (`csrc/hstu_attention_relbias_bwd_bf16.cuh`), after a pre-scaling pass.

    bias[b, i, j] = pos_w[clip(j - i + Nm - 1, 0, 2 Nm - 2)]
                  + ts_w[clip(floor(ln(max(|ts[b, min(i + 1, N - 1)]
                                          - ts[b, j]|, 1)) / 0.301), 0, NB)]
    out = silu(alpha * q k^T + bias) / max_seq_len * valid_mask @ v

The kernels never build the [B, N, N] bias: both tables sit in shared memory
and each element looks its two entries up; a table too long for shared
memory (a long maximum length) is read through the L1 cache instead, a tile
pair's bias from a window of consecutive entries. The plain version builds
it.
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
the Pallas kernels' rounding points: alpha q rounded to bfloat16 (where
alpha != 1), S, dP and dS in float32 from exact products, P rounded to
bfloat16 before P V (forward) and P^T dO (backward), dO entering the
backward as bfloat16(dO * bfloat16(1 / norm)), dS rounded to bfloat16
before dS^T (alpha q) and dS K, dq taking one alpha at its float32 flush,
the table gradients from the float32 dS summed over the heads; out, dq, dk
and dv in bfloat16, the table gradients in float32. Their plain versions
follow the same rounding points (`_relbias_fwd_plain_bf16`,
`_relbias_bwd_plain_bf16`); autograd through a bfloat16 forward would round
dP instead. K6-bf16 runs K1-bf16's body on the bfloat16 tensor cores
(`csrc/hstu_attention_fwd_bf16.cuh`, its long walks cut in chunks whose sums
a scratch holds, `hstu_attention._fwd_plan` on bfloat16); K7-bf16 and
K7-det-bf16 a bfloat16 body of their own
(`csrc/hstu_attention_relbias_bwd_bf16.cuh`: bfloat16(alpha q) and
bfloat16(dO / norm) formed once per call into buffers the wrapper
allocates, ``mma.sync.m16n8k16`` on bfloat16 tiles, 4 heads of width 32 a
block, 2 of width 128). The bfloat16 kernels count their launches in
``launches_bf16``, beside the float32 kernels' ``launches``.

K7 sums dq, ``dpos_w`` and ``dts_w`` with atomics, in an order that changes
from run to run. The Pallas kernel keeps those sums in VMEM over a
sequential grid, so every run of the JAX package gives the same bits; K7-det
does too, with stores instead of atomics: K7's body computes everything in
one pass over the tile pairs, storing each tile pair's dQ to a slot of its
own (a float32 [B, pairs, 64, H, D] buffer, `_det_slot`) and each block's
table sums to its own row of a float32 [blocks, (2 Nm - 1) + (NB + 1)]
buffer; a second launch sums each dq element's slots over the key tiles in
ascending order and the table rows entry by entry in block order. Under
``torch.use_deterministic_algorithms(True)`` the autograd function takes
K7-det, in float32 and bfloat16 alike; it counts its launches in
``launches_det`` and ``launches_det_bf16``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from generative_recommenders_tpu_torch.ops.cuda import hstu_attention as ha
from generative_recommenders_tpu_torch.ops.cuda.build import LaunchCounter

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signatures of the entry points (csrc/hstu_mha_relbias_*.cu), each ending
# with its plan's route and the stream
ha._ARGTYPES.update({
    # after Nm and NB the per-pair route's scratch, its slabs a group and its
    # splits (`ha._fwd_pairs_args`)
    "hstu_mha_relbias_fwd": [_P] * 9 + [_I] * 5 + [_L] * 9 + [_F, _F] + [_I] * 6 + [_P, _I, _I] + [_I, _P],
    # the bfloat16 body's scratch after out, the per-pair route's slabs a
    # group and splits after Nm and NB, its chunk before the route
    "hstu_mha_relbias_fwd_bf16": [_P] * 10 + [_I] * 5 + [_L] * 9 + [_F, _F] + [_I] * 6 + [_I, _I] + [_I] + [_I, _P],
    # the mask ints, Nm and NB, then the per-pair route's scratch, its slabs
    # a group and its splits (`ha._pairs_args`), then the flags
    "hstu_mha_relbias_bwd": [_P] * 14 + [_I] * 5 + [_L] * 12 + [_F, _F] + [_I] * 6 + [_P, _I, _I] + [_I] * 4
    + [_I, _P],
    # three more pointers: the bfloat16 body's alpha q and dO / norm after dO,
    # dq's float32 sums beside the bfloat16 dq
    "hstu_mha_relbias_bwd_bf16": [_P] * 17 + [_I] * 5 + [_L] * 12 + [_F, _F] + [_I] * 6 + [_P, _I, _I] + [_I] * 4
    + [_I, _P],
    # two more pointers: the blocks' table sums, the tile pairs' dQ (and on
    # bfloat16 alpha q and dO / norm after dO)
    "hstu_mha_relbias_bwd_det": [_P] * 16 + [_I] * 5 + [_L] * 12 + [_F, _F] + [_I] * 6 + [_P, _I, _I] + [_I] * 4
    + [_I, _P],
    "hstu_mha_relbias_bwd_det_bf16": [_P] * 18 + [_I] * 5 + [_L] * 12 + [_F, _F] + [_I] * 6 + [_P, _I, _I]
    + [_I] * 4 + [_I, _P],
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
_NARROW_BWD_WIDTH = 128  # wider heads take the wide bodies (csrc/hstu_attention_wide.cuh)
# K7's float32 body by padded width (`Tiling` of csrc/hstu_mha_relbias_bwd.cu):
# the heads a block loops inside, the query rows of a step, the (Q, dO)
# stages
_TILING_F32 = {32: (4, 64, 2), 64: (2, 64, 2), 128: (1, 32, 2)}
# the heads a block of K7's bfloat16 body loops inside, by padded width
# (`TilingBf16` of csrc/hstu_attention_relbias_bwd_bf16.cuh)
_HEAD_GROUP_BF16 = {32: 4, 64: 2, 128: 2}
# the buckets a float32 time gap reaches: 0 .. 294 and NB (an infinite gap),
# the slots of dts_w's copies where the tables are read (`hstu_wide::kTsSlots`)
_TS_SLOTS = 296
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


_plain_mask, _bf16, _scaled_q = ha._plain_mask, ha._bf16, ha._scaled_q


def _relbias_fwd_plain_bf16(q, k, v, lengths, timestamps, pos_w, ts_w, num_buckets, kw) -> torch.Tensor:
    """K6's bfloat16 function: S = (alpha q) k^T + bias in float32 from
    bfloat16 inputs (alpha q rounded to bfloat16), P = silu(S) * mask
    rounded to bfloat16, O = (P V) / norm in float32, returned as
    bfloat16."""
    N = q.shape[1]
    mask = _plain_mask(N, lengths, kw)
    bias = relative_bias_plain(timestamps, pos_w, ts_w, num_buckets)
    s = torch.einsum("bnhd,bmhd->bhnm", _scaled_q(q, kw["alpha"]), k.float()) + bias[:, None]
    p = _bf16(torch.where(mask[:, None], F.silu(s), 0.0))
    out = torch.einsum("bhnm,bmhv->bnhv", p, v.float()) * (1.0 / (kw["max_seq_len"] or N))
    return out.to(torch.bfloat16)


def _relbias_bwd_plain_bf16(q, k, v, lengths, timestamps, pos_w, ts_w, do, num_buckets, kw) -> RelbiasGrads:
    """K7's bfloat16 function, written out: alpha q and dO / norm rounded to
    bfloat16 (alpha and 1 / norm themselves in bfloat16, the Pallas kernel's
    weakly typed scalars), dV = bf16(P)^T dO, dP = dO V^T and dS = dP *
    dsilu in float32, dK = bf16(dS)^T (alpha q), dQ = alpha bf16(dS) K, the
    table gradients from the float32 dS summed over the heads."""
    N = q.shape[1]
    mask = _plain_mask(N, lengths, kw)[:, None]
    inv_norm = ha._bf16_scalar(1.0 / (kw["max_seq_len"] or N))
    dob = _bf16(do.float() * inv_norm)
    with torch.enable_grad():
        tables = [t.detach().float().requires_grad_(True) for t in (pos_w, ts_w)]
        bias = relative_bias_plain(timestamps, *tables, num_buckets)
    qs = _scaled_q(q, kw["alpha"])
    s = torch.einsum("bnhd,bmhd->bhnm", qs, k.float()) + bias.detach()[:, None]
    sig = torch.sigmoid(s)
    p = torch.where(mask, s * sig, 0.0)
    dv = torch.einsum("bhnm,bnhv->bmhv", _bf16(p), dob)
    dp = torch.einsum("bnhv,bmhv->bhnm", dob, v.float())
    ds = torch.where(mask, dp * sig * (1.0 + s * (1.0 - sig)), 0.0)
    ds16 = _bf16(ds)
    dk = torch.einsum("bhnm,bnhd->bmhd", ds16, qs)
    dq = torch.einsum("bhnm,bmhd->bnhd", ds16, k.float()) * kw["alpha"]
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
    out = torch.empty((B, N, H, V), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    # raises on what the kernel does not take
    plan = ha._fwd_plan(D, V, H, (pos_w.shape[0] + 1) // 2, ts_w.shape[0] - 1, True, B, N, q.dtype)
    route = plan["route"]
    # the scratch of the plan (the bfloat16 entry point's after out, its
    # chunk before the route), the per-pair route's after Nm and NB
    scratch = ha._fwd_scratch(plan, q.device)
    extra_ptr, extra_int = (((ha._ptr(scratch),), (plan.get("key_chunk", 0),)) if bf16 else ((), ()))
    ha._launch(
        "hstu_mha_relbias_fwd_bf16" if bf16 else "hstu_mha_relbias_fwd",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *extra_ptr,
        lens.data_ptr(), None if nt is None else nt.data_ptr(),
        ts.data_ptr(), pos_w.data_ptr(), ts_w.data_ptr(),
        B, N, H, D, V, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *ha._mask_args(kw, N), (pos_w.shape[0] + 1) // 2, ts_w.shape[0] - 1,
        *ha._fwd_pairs_args(plan, scratch, bf16), *extra_int, ha._ROUTES[route], ha._stream(q.device),
    )
    counters = hstu_mha_dense_relbias_cuda
    (counters.launches_bf16 if bf16 else counters.launches).add(route)
    return out


def _relbias_bwd_plan(D: int, V: int, H: int, Nm: int, NB: int, dtype: torch.dtype = torch.float32,
                      B: int = 1, N: int = 1) -> dict:
    """K7's launch on q's type ``dtype``, its ``route`` the body the C entry
    point takes. D and V up to 128 (route ``narrow``): the head width both
    are padded to (32, 64 or 128), the heads a block loops inside (4, 2 or
    1 on float32, 4, 2 or 2 on bfloat16: their K, V, dK and dV tiles fill
    its shared memory and registers),
    the head groups (H need not be a multiple) and the block's shared
    memory: K and V of the group, two (Q, dO) stages (of 32 query rows at
    width 128 on float32, `_TILING_F32`), P, dS and dS summed over the heads
    (a head alone: its dS), both tables, ``dpos_w``'s sums and one copy of
    ``dts_w``'s sums per warp; where the tables do not fit beside the tiles (a long position
    table, many buckets), the tables are read from device memory and the
    warps' copies keep the reachable buckets (route ``read``). On bfloat16
    the bfloat16 body's: its tiles, P and dS bfloat16 (the head sum of dS
    float32), `_HEAD_GROUP_BF16` heads a block, so that longer tables are
    staged (at width 32 and 128 buckets up to Nm 7,836 against float32's
    2,844); after the pre-scaling pass (a block per batch
    row and row of the [B, N] batch, ``prescale_grid``) into the bfloat16
    buffers ``q_scaled_shape`` (where alpha != 1) and ``do_scaled_shape``.
    Wider heads (route ``wide``, either type): the wide backward's dkv pass
    with dQ and the table sums (`ha._wide_dkv_plan`: a cluster per key tile,
    head and batch row); on bfloat16 after the pre-scaling pass. Past 16
    blocks of two chunks (route ``wide_chunks``): the per-pair backward
    (`ha._pairs_plan`: S and dP formed once per tile pair with the bias, P
    and dS kept in the wrapper's scratch, then one gradient pass over dQ's,
    dK's and dV's chunks and the table sums, added with atomics). Raises on a
    width of 0 and on a grid beyond CUDA's."""
    ha._check_widths(D, V)
    if max(D, V) > _NARROW_BWD_WIDTH:
        return dict(ha._wide_dkv_plan(D, V, H, B, N, relbias=True, dtype=dtype), head_groups=H)
    width = next(w for w in (32, 64, 128) if max(D, V) <= w)
    bf16 = dtype == torch.bfloat16
    if bf16:  # bytes: bfloat16 K, V of the group, two (Q, dO) stages, P and dS; dS summed over the heads
        head_group = _HEAD_GROUP_BF16[width]
        tile_bytes = 2 * ((2 * head_group + 4) * _BWD_TILE * (width + 8) + 2 * _BWD_TILE * _BWD_PITCH) \
            + 4 * _BWD_TILE * _BWD_PITCH
    else:  # floats: K, V of the group, the (Q, dO) stages; P, dS, dS summed over the heads (one head: dS)
        head_group, rows, stages = _TILING_F32[width]
        tile_bytes = 4 * (2 * head_group * _BWD_TILE * (width + 8) + 2 * stages * rows * (width + 8)
                          + (3 if head_group > 1 else 2) * rows * _BWD_PITCH)
    tables = 2 * (2 * Nm - 1) + (1 + _BWD_WARPS) * (NB + 1)
    plan = dict(route="narrow", width=width, head_group=head_group, head_groups=-(-H // head_group),
                shared_bytes=tile_bytes + 4 * tables)
    if plan["shared_bytes"] > _MAX_SHARED_BYTES:  # read, not staged
        plan.update(route="read", shared_bytes=tile_bytes + 4 * _BWD_WARPS * min(NB + 1, _TS_SLOTS))
    if bf16:
        ha._check_grid(B * N, "the pre-scaling pass")
        plan.update(prescale_grid=(B * N,), q_scaled_shape=(B, N, H, D), do_scaled_shape=(B, N, H, V))
    return plan


def _relbias_grid(N: int, head_groups: int, B: int) -> Tuple[int, int, int]:
    """K7's grid of (key tile, head group, batch row) blocks; raises beyond
    CUDA's 65535 in y or z."""
    grid = (-(-N // _BWD_TILE), head_groups, B)
    if grid[1] > ha._MAX_GRID_YZ or grid[2] > ha._MAX_GRID_YZ:
        raise ValueError(f"K7's grid {grid} exceeds {ha._MAX_GRID_YZ} blocks in y or z: split the batch")
    return grid


def _det_slot(qt: int, kt: int, tiles: int, lower_only: bool) -> int:
    """K7-det's slot of the tile pair (query tile ``qt``, key tile ``kt``)
    among a batch row's (`det_slot` in csrc/hstu_mha_relbias_bwd.cu): the
    walk of a causal mask without contextual rows (``lower_only``) visits
    the pairs with kt <= qt, any other walk every pair; a query tile's slots
    are consecutive in kt."""
    return qt * (qt + 1) // 2 + kt if lower_only else qt * tiles + kt


def _relbias_det_plan(D: int, V: int, H: int, B: int, N: int, Nm: int, NB: int, causal: bool = True,
                      contextual_seq_len: int = 0, dtype: torch.dtype = torch.float32) -> dict:
    """K7-det's launches. D and V up to 128: K7's body on K7's grid
    (`_relbias_bwd_plan`: (key tile, head group, batch row)), on its route,
    each block storing the dQ of every tile pair its walk visits to the
    pair's slot of the float32 ``dq_partial`` buffer [B, pairs, 64, H, D]
    (``pairs`` slots per batch row, `_det_slot`; the walk of a causal mask
    without contextual rows takes the key tile's own query tile and those
    after it, ``lower_only``) and its table sums to its own row of the
    float32 ``partial`` buffer [blocks, (2 Nm - 1) + (NB + 1)]; then one
    launch of ``sum_grid`` blocks of 1024 threads: ``sum_chunks`` blocks per
    query tile and batch row sum its dq's slots over the key tiles in
    ascending order (4096 floats a block, 1024 where H D is not a multiple of
    4), the rest the table rows in block order, 32 entries a block. Wider
    heads: the wide backward's dq pass with the bias, its dkv pass, whose
    blocks each write one row, and the same sum launch on the tables alone;
    past the clusters (route ``wide_chunks``) the per-pair backward
    (`ha._pairs_plan`: one S / dP pass, one gradient pass with dQ written
    whole, the table sums a block per key tile, head and batch row, each
    writing its row in the walk's order), then the same sum launch. On bfloat16 K7's bfloat16 body (`_relbias_bwd_plan`
    on ``dtype``: its head groups, its route, its pre-scaled buffers). Raises
    on a width of 0 and on a grid beyond CUDA's."""
    bwd = _relbias_bwd_plan(D, V, H, Nm, NB, dtype, B, N)
    entries = 2 * Nm - 1 + NB + 1
    table_blocks = -(-entries // 32)
    if bwd["route"] == "wide_chunks":  # one S / dP pass, one gradient pass with dQ, the table rows
        return dict(bwd, partial_shape=(bwd["table_rows"], entries), dq_partial_shape=None, sum_grid=(table_blocks,))
    if bwd["route"] == "wide":
        dq = ha._wide_dq_plan(D, V, H, B, N, dtype)
        return dict(bwd, dq_grid=dq["grid"], dq_shared_bytes=dq["shared_bytes"],
                    partial_shape=(bwd["table_rows"], entries), dq_partial_shape=None, sum_grid=(table_blocks,))
    grid = _relbias_grid(N, bwd["head_groups"], B)
    tiles = -(-N // _BWD_TILE)
    lower_only = causal and contextual_seq_len == 0
    pairs = _det_slot(tiles, 0, tiles, lower_only)  # the slot after the last pair's
    per_block = 4096 if H * D % 4 == 0 else 1024
    chunks = -(-(_BWD_TILE * H * D) // per_block)
    scaled = {k: bwd[k] for k in ("prescale_grid", "q_scaled_shape", "do_scaled_shape") if k in bwd}
    return dict(route=bwd["route"], width=bwd["width"], head_group=bwd["head_group"], grid=grid,
                shared_bytes=bwd["shared_bytes"], partial_shape=(grid[0] * grid[1] * grid[2], entries),
                tiles=tiles, lower_only=lower_only, pairs=pairs, dq_partial_shape=(B, pairs, _BWD_TILE, H, D),
                sum_chunks=chunks, sum_grid=(B * tiles * chunks + table_blocks,), **scaled)


def _relbias_bwd(q, k, v, lens, nt, ts, pos_w, ts_w, do, kw: dict, deterministic: bool = False) -> RelbiasGrads:
    """Launches K7, or K7-det with ``deterministic``, on checked CUDA tensors
    (as `_relbias_fwd`; do contiguous in its last dim, of q's type) and
    counts it. K7 sums dq (in float32) and both table gradients into zeroed
    buffers, and its bfloat16 kernel writes dq's sums as bfloat16 at its end;
    K7-det writes every output whole, in a fixed order, through the scratch
    buffers of its plan."""
    B, N, H, D = q.shape
    V = v.shape[3]
    Nm, NB = (pos_w.shape[0] + 1) // 2, ts_w.shape[0] - 1
    bf16 = q.dtype == torch.bfloat16
    # raises on what the kernels do not take
    if deterministic:
        plan = _relbias_det_plan(D, V, H, B, N, Nm, NB, kw["causal"], kw["contextual_seq_len"], q.dtype)
    else:
        plan = _relbias_bwd_plan(D, V, H, Nm, NB, q.dtype, B, N)
        if plan["route"] not in ("wide", "wide_chunks"):
            _relbias_grid(N, plan["head_groups"], B)
    new = lambda fn, *shape, dtype=torch.float32: fn(shape, dtype=dtype, device=q.device)  # noqa: E731
    dk, dv = new(torch.empty, B, N, H, D, dtype=q.dtype), new(torch.empty, B, N, H, V, dtype=q.dtype)
    if deterministic:
        dq = new(torch.empty, B, N, H, D, dtype=q.dtype)
        dpos, dts = new(torch.empty, pos_w.shape[0]), new(torch.empty, ts_w.shape[0])
        if B * N * H == 0:
            return dq, dk, dv, dpos.zero_(), dts.zero_()
        partial = new(torch.empty, *plan["partial_shape"])
        dq_partial = None if plan["dq_partial_shape"] is None else new(torch.empty, *plan["dq_partial_shape"])
        name = "hstu_mha_relbias_bwd_det_bf16" if bf16 else "hstu_mha_relbias_bwd_det"
        dq_ptrs = (dq.data_ptr(),)
        tail = (partial.data_ptr(), None if dq_partial is None else dq_partial.data_ptr())
    else:
        dq32 = new(torch.zeros, B, N, H, D)
        dq = new(torch.empty, B, N, H, D, dtype=q.dtype) if bf16 else dq32
        dpos, dts = new(torch.zeros, pos_w.shape[0]), new(torch.zeros, ts_w.shape[0])
        if B * N * H == 0:
            return dq, dk, dv, dpos, dts
        name = "hstu_mha_relbias_bwd_bf16" if bf16 else "hstu_mha_relbias_bwd"
        dq_ptrs, tail = ((dq32.data_ptr(), dq.data_ptr()) if bf16 else (dq.data_ptr(),)), ()
    # the bfloat16 bodies (every route): a pre-scaling pass writes
    # bfloat16(alpha q) (where alpha != 1) and bfloat16(dO / norm) into
    # buffers of their own (pointers after dO), and the body reads its rows
    # in 16-byte pieces of 8 elements
    scaled = ()
    if bf16:
        qs = dos = None
        if "do_scaled_shape" in plan:
            qs = new(torch.empty, *plan["q_scaled_shape"], dtype=q.dtype) if kw["alpha"] != 1.0 else None
            dos = new(torch.empty, *plan["do_scaled_shape"], dtype=q.dtype)
        scaled = (ha._ptr(qs), ha._ptr(dos))
    scratch, pairs = ha._pairs_args(plan, q.device)  # noqa: F841 (alive through the launch)
    ha._launch_planned(
        plan, name,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), *scaled,
        *dq_ptrs, dk.data_ptr(), dv.data_ptr(),
        lens.data_ptr(), None if nt is None else nt.data_ptr(),
        ts.data_ptr(), pos_w.data_ptr(), ts_w.data_ptr(), dpos.data_ptr(), dts.data_ptr(), *tail,
        B, N, H, D, V, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        *ha._mask_args(kw, N), Nm, NB, *pairs,
        *(int(ha._vec16(t, 8 if bf16 else 4)) for t in (q, k, v, do)), ha._ROUTES[plan["route"]],
        ha._stream(q.device),
    )
    c = hstu_mha_relbias_bwd_cuda
    {
        (False, False): c.launches, (True, False): c.launches_bf16,
        (False, True): c.launches_det, (True, True): c.launches_det_bf16,
    }[bf16, deterministic].add(plan["route"])
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
    same bits every run. Any head width and table length (heads wider than
    128 take the wide bodies, tables that do not fit a block's shared memory
    are read from device memory). CPU tensors go through the plain
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
    ha._check("do", do, 4, q.device, (q.dtype,))
    kw.pop("num_targets")
    return _relbias_bwd(q, k, v, lens, nt, ts, pos_w, ts_w, do, kw, deterministic)


hstu_mha_dense_relbias_cuda.launches = LaunchCounter()
hstu_mha_dense_relbias_cuda.launches_bf16 = LaunchCounter()
hstu_mha_relbias_bwd_cuda.launches = LaunchCounter()
hstu_mha_relbias_bwd_cuda.launches_bf16 = LaunchCounter()
hstu_mha_relbias_bwd_cuda.launches_det = LaunchCounter()
hstu_mha_relbias_bwd_cuda.launches_det_bf16 = LaunchCounter()
