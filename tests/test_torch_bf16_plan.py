"""The bfloat16 bodies of K1 (K1-bias, K6) and of K2 (K4) as far as the CPU
can hold them: their launch plans, a plain model of the forward's key
chunks summed in the kernel's order, and the backward's pre-scaling pass.

* `_fwd_plan` and `_bwd_plan` on bfloat16 at bench.py's shape (B 8, N 2048,
  H 4, D 64), at ml-3b's block 0 (B 96, N 511, H 8, D 32) and at N 4096:
  the width, the tiling of `csrc/hstu_attention_fwd_bf16.cuh` and
  `csrc/hstu_attention_bwd_dkv_bf16.cuh`, the chunks and their scratch,
  the shared bytes within a Hopper block's and the grid within CUDA's; the
  float32 plans as they were.
* `_dense_fwd_chunks_bf16` (each query tile's walk in chunks of the plan's
  key columns, the chunks' float32 sums added in chunk order, then rounded
  once) against `hstu_mha_dense_pallas` in interpret mode on bfloat16,
  within 2^-6 of the output's largest entry (bfloat16's: a sum taken in
  another order now and then rounds to the neighbouring bfloat16), with
  chunks of 64 columns so that a walk of 144 keys takes three.
* `_prescaled`, the pre-scaling pass's plain twin, against the JAX rounding
  of alpha q and dO / norm on bfloat16 (a weakly typed Python float times a
  bfloat16 array), bit for bit.
* The launches with `_launch` stubbed: the forward's scratch and chunk, the
  backward's two pre-scaled buffers.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from generative_recommenders_tpu.ops.pallas.hstu_attention import hstu_mha_dense_pallas
from generative_recommenders_tpu_torch.ops.cuda import hstu_attention as ha

SHARED = 232448  # a Hopper block's shared memory
GRID = 2**31 - 1
BF16_TOL = 2.0**-6
# (B, N, H, D): bench.py's attention pair, ml-3b's block 0, the N where the
# JAX package's bfloat16 backward takes the split kernels
SHAPES = {"bench.py": (8, 2048, 4, 64), "ml-3b block 0": (96, 511, 8, 32), "N 4096": (8, 4096, 4, 64)}


@pytest.mark.parametrize("relbias", [False, True], ids=["K1-bf16", "K6-bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_forward_plan(shape, relbias):
    """The bfloat16 forward's tiling (4 warps of 16 query rows; 2 heads a
    block and 32-column key tiles at width 32, 1 head and 64 columns at
    64), its tiles' shared
    bytes in bfloat16 (K6: the tables and the row's timestamps staged in
    float32 beside them), walks cut in chunks of 512 key columns (1024 at N
    4096: at most 4 chunks), a block per (query tile, chunk, head group,
    batch row) and the [chunks, B, N, H, V] float32 scratch where a walk may
    take more than one chunk."""
    B, N, H, D = SHAPES[shape]
    Nm, NB = (N, 128) if relbias else (0, 0)
    plan = ha._fwd_plan(D, D, H, Nm, NB, relbias, B, N, torch.bfloat16)
    warps, group, key_tile = ha._FWD_TILING_BF16[D]
    assert (warps, group, key_tile) == ((4, 2, 32) if D == 32 else (4, 1, 64)) and plan["width"] == D
    assert plan["query_rows"] == 64 and plan["head_group"] == group and plan["key_tile"] == key_tile
    assert plan["route"] == "narrow"
    tables = (2 * Nm - 1 + NB + 1 + -(-N // key_tile) * key_tile) if relbias else 0
    assert plan["shared_bytes"] == 2 * (group * 64 * (D + 8) + 2 * key_tile * (2 * D + 16)) + 4 * tables
    assert plan["shared_bytes"] <= SHARED
    chunk = 1024 if N == 4096 else 512
    chunks = -(-N // chunk)
    assert plan["key_chunk"] == chunk and plan["chunks"] == chunks <= 4
    assert plan["scratch_shape"] == ((chunks, B, N, H, D) if chunks > 1 else None)
    assert plan["grid"] == (-(-N // 64) * chunks * -(-H // group) * B,) and plan["grid"][0] <= GRID
    assert plan["sums_grid"] == ((B * N,) if chunks > 1 else None)


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_backward_plan(shape):
    """The bfloat16 backward's tiling (64 key columns a block; 64 query rows
    a step and 8 warps at width 32, 128 and 16 at 64), its tiles in
    bfloat16, a block per (key tile, head, batch row), and the pre-scaling
    pass's buffers and grid."""
    B, N, H, D = SHAPES[shape]
    plan = ha._bwd_plan(D, D, H, B, N, torch.bfloat16)
    rows, cols, warps = ha._BWD_TILING_BF16[D]
    assert (rows, cols, warps) == ((64, 64, 8) if D == 32 else (128, 64, 16)) and plan["warps"] == warps
    assert plan["query_rows"] == rows and plan["key_cols"] == cols and plan["width"] == D
    assert plan["route"] == "narrow"
    assert plan["shared_bytes"] == 2 * ((64 + 2 * rows) * (2 * D + 16) + 2 * rows * 72) + 4 * (rows // 16 + 8)
    assert plan["shared_bytes"] <= SHARED
    assert plan["grid"] == (-(-N // 64) * H * B,) and plan["prescale_grid"] == (B * N,)
    assert plan["q_scaled_shape"] == (B, N, H, D) and plan["do_scaled_shape"] == (B, N, H, D)


# the float32 plans at those shapes, as the float32 bodies tile them
F32_FWD = {32: (128, 2, 32, 4 * (2 * 128 * 40 + 2 * 32 * (40 + 36))),
           64: (128, 2, 32, 4 * (2 * 128 * 72 + 2 * 32 * (72 + 68)))}
F32_BWD = {32: 98352, 64: 147504}


@pytest.mark.parametrize("shape", SHAPES)
def test_float32_plans_stay(shape):
    """The float32 plans are those of the float32 bodies, with no key of the
    bfloat16 ones; the element type defaults to float32."""
    B, N, H, D = SHAPES[shape]
    rows, group, key_tile, shared = F32_FWD[D]
    fwd = ha._fwd_plan(D, D, H, 0, 0, False, B, N)
    assert fwd == ha._fwd_plan(D, D, H, 0, 0, False, B, N, torch.float32) == dict(
        route="narrow", width=D, query_rows=rows, head_group=group, head_groups=-(-H // group), key_tile=key_tile,
        shared_bytes=shared, grid=(-(-N // rows) * -(-H // group) * B,))
    bwd = ha._bwd_plan(D, D, H, B, N)
    assert bwd == ha._bwd_plan(D, D, H, B, N, torch.float32) == dict(
        route="narrow", width=D, query_rows=64, key_cols=64, head_group=1, shared_bytes=F32_BWD[D],
        grid=(-(-N // 64) * H * B,))


@pytest.mark.parametrize("D,V", [(25, 25), (40, 16), (16, 100), (128, 128), (200, 96), (256, 128)])
def test_bf16_plans_at_every_narrow_width(D, V):
    """Every narrow width fits a block on bfloat16, K6's tables staged at
    ml-3b's length; walks of one chunk at N 511 need no scratch."""
    B, N, H = 96, 511, 8
    for relbias in (False, True):
        plan = ha._fwd_plan(D, V, H, N if relbias else 0, 128 if relbias else 0, relbias, B, N, torch.bfloat16)
        assert plan["route"] == "narrow" and plan["shared_bytes"] <= SHARED and plan["scratch_shape"] is None
        assert plan["key_chunk"] % plan["key_tile"] == 0
    assert ha._bwd_plan(D, V, H, B, N, torch.bfloat16)["shared_bytes"] <= SHARED


def test_bf16_plans_read_tables_that_do_not_fit_and_keep_the_wide_body():
    """K6-bf16 reads a table that does not fit beside its bfloat16 tiles
    (route ``read``, the tiles' bytes alone), and heads wider than D 256 or
    V 128 take the wide bodies on bfloat16 as on float32 (the backward's
    clusters the same, on bfloat16 tiles after the pre-scaling pass)."""
    plan = ha._fwd_plan(64, 64, 2, 30000, 128, True, 2, 256, torch.bfloat16)
    dense = ha._fwd_plan(64, 64, 2, 0, 0, False, 2, 256, torch.bfloat16)
    assert plan == dict(dense, route="read")
    w16, w32 = ha._fwd_plan(320, 64, 2, 0, 0, False, 2, 256, torch.bfloat16), ha._fwd_plan(320, 64, 2, 0, 0, False, 2, 256)
    assert w16["route"] == w32["route"] == "wide" and w16["grid"] == w32["grid"] and w16["cluster"] == w32["cluster"]
    assert w16["shared_bytes"] < w32["shared_bytes"]  # bfloat16 tiles
    b16, f32 = ha._bwd_plan(64, 136, 2, 2, 256, torch.bfloat16), ha._bwd_plan(64, 136, 2, 2, 256)
    assert b16["route"] == f32["route"] == "wide" and b16["grid"] == f32["grid"] and b16["cluster"] == f32["cluster"]
    assert b16["shared_bytes"] < f32["shared_bytes"] and b16["do_scaled_shape"] == (2, 256, 2, 136)
    assert "do_scaled_shape" not in f32


def _bf16_inputs(seed, B, N, H, D, ctx, targets):
    rng = np.random.default_rng(seed)
    bf = lambda a: np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    q, k, v = (bf(rng.standard_normal((B, N, H, D)) * 0.5) for _ in range(3))
    lengths = rng.integers(ctx + 2, N + 1, size=(B,)).astype(np.int32)
    lengths[0], lengths[1], lengths[-1] = N, 129, 0
    nt = None
    if targets:
        nt = np.minimum(rng.integers(0, 4, size=(B,)), np.maximum(lengths - ctx - 1, 0)).astype(np.int32)
    return q, k, v, lengths, nt


@pytest.mark.parametrize("alpha", [1.0, 0.125])
@pytest.mark.parametrize("case", [dict(), dict(num_targets=True, contextual_seq_len=3), dict(causal=False),
                                  dict(max_attn_len=40, min_full_attn_seq_len=10)])
def test_forward_chunks_match_pallas(monkeypatch, case, alpha):
    """The forward's key chunks summed in the kernel's fixed order, against
    `hstu_mha_dense_pallas` on bfloat16 in interpret mode: at N 144 with
    chunks of 64 columns, the last query tile's walk takes three chunks (two
    on a row of 129)."""
    monkeypatch.setattr(ha, "_FWD_CHUNK_BF16", 64)
    case = dict(case)
    targets = case.pop("num_targets", False)
    B, N, H, D = 4, 144, 2, 16
    q, k, v, lengths, nt = _bf16_inputs(23, B, N, H, D, case.get("contextual_seq_len", 0), targets)
    kw = dict(dict(alpha=alpha, max_seq_len=N + 5, causal=True), **case)
    plan = ha._fwd_plan(D, D, H, 0, 0, False, B, N, torch.bfloat16)
    assert plan["key_chunk"] == 64 and plan["chunks"] == 3
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    want = hstu_mha_dense_pallas(bf(q), bf(k), bf(v), jnp.asarray(lengths),
                                 num_targets=None if nt is None else jnp.asarray(nt),
                                 block_q=16, block_k=16, interpret=True, **kw)
    t = lambda a: torch.as_tensor(a).to(torch.bfloat16)  # noqa: E731
    tkw = dict(dict(max_attn_len=0, contextual_seq_len=0, min_full_attn_seq_len=0), **kw,
               num_targets=None if nt is None else torch.as_tensor(nt))
    got = ha._dense_fwd_chunks_bf16(t(q), t(k), t(v), torch.as_tensor(lengths), tkw, plan)
    assert got.dtype == torch.bfloat16
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()
    dead = np.arange(N)[None, :] >= lengths[:, None]
    assert (got[dead] == 0).all()


@pytest.mark.parametrize("scale", [0.125, 0.3, 1 / 8**0.5, 1 / 2048, 1 / 211, 1 / 150])
def test_prescale_twin_matches_jax_bit_for_bit(scale):
    """`_prescaled`, the plain twin of the backward's pre-scaling pass
    (`prescale_kernel`: alpha q and dO / norm formed once per call), against
    the JAX rounding of a bfloat16 array times a weakly typed Python float,
    as `_bwd_fused_kernel_rkv` and `_bwd_dkv_kernel` form `qb * alpha` and
    `do * inv_norm`: the same bits, on values across bfloat16's range."""
    rng = np.random.default_rng(29)
    x = (rng.standard_normal((3, 40, 2, 24)) * np.exp(rng.uniform(-30, 30, (3, 40, 2, 24)))).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray((xj * scale).view(jnp.int16))
    got = ha._prescaled(torch.as_tensor(x).to(torch.bfloat16), scale)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want)


def test_bf16_forward_launch_passes_its_scratch(monkeypatch):
    """`_dense_fwd` on bfloat16 (the launch recorded, not made): the scratch
    of its plan after out (None where no walk takes two chunks) and the
    chunk before the route; K6-bf16 the same."""
    from generative_recommenders_tpu_torch.ops.cuda import hstu_attention_relbias as hr

    calls = []
    monkeypatch.setattr(ha, "_launch", lambda *a: calls.append(a))
    monkeypatch.setattr(ha, "_stream", lambda device: 0)
    kw = dict(alpha=0.125, max_seq_len=None, causal=True, max_attn_len=0, contextual_seq_len=0,
              min_full_attn_seq_len=0)
    for N, cut in ((70, False), (1100, True)):
        q = torch.zeros(2, N, 3, 32, dtype=torch.bfloat16, device="meta")
        lens = torch.tensor([N, 9], dtype=torch.int32)
        ha._dense_fwd(q, q, q, lens, None, kw)
        hr._relbias_fwd(q, q, q, lens, None, torch.zeros(2, N, device="meta"),
                        torch.zeros(2 * N - 1, device="meta"), torch.zeros(129, device="meta"), kw)
        for call in calls[-2:]:
            assert call[0].endswith("_bf16") and len(call) - 1 == len(ha._ARGTYPES[call[0]])
            assert (call[5] is not None) == cut and call[-3] == 512 and call[-2] == ha._ROUTES["narrow"]


@pytest.mark.parametrize("alpha", [1.0, 0.125])
def test_bf16_backward_launch_passes_its_buffers(monkeypatch, alpha):
    """`_bwd_kernel` for K2-bf16 on the bfloat16 body (the launch recorded,
    not made): bfloat16(alpha q)'s buffer after dO where alpha != 1 (None at
    alpha 1), then bfloat16(dO / norm)'s, then dq's float32 sums; the rows
    read in pieces of 8 elements where they allow it (q, k and v views of
    one projection at a pitch of 80 elements, dO contiguous)."""
    calls = []
    monkeypatch.setattr(ha, "_launch", lambda *a: calls.append(a))
    monkeypatch.setattr(ha, "_stream", lambda device: 0)
    B, N, H, D = 2, 70, 3, 32
    proj = torch.zeros(B, N, H * 80, dtype=torch.bfloat16)
    q, k, v = (x.reshape(B, N, H, -1) for x in torch.split(proj, [H * 32, H * 32, H * 16], dim=-1))
    do = torch.zeros(B, N, H, 16, dtype=torch.bfloat16)
    kw = dict(alpha=alpha, max_seq_len=None, causal=True, max_attn_len=0, contextual_seq_len=0,
              min_full_attn_seq_len=0)
    ha._bwd_kernel("hstu_mha_bwd_fused_bf16", q, k, v, torch.tensor([N, 9], dtype=torch.int32), None, do, kw)
    (call,) = calls
    assert len(call) - 1 == len(ha._ARGTYPES["hstu_mha_bwd_fused_bf16"])
    assert (call[5] is None) == (alpha == 1.0) and isinstance(call[6], int) and isinstance(call[7], int)
    assert call[-6:-2] == (1, 1, 1, 1) == tuple(int(ha._vec16(t, 8)) for t in (q, k, v, do))


# ------------------ K7's and K3's bfloat16 bodies (the relative-bias backward, dq)
def _relbias_tile_bytes(width, group, bf16):
    """K7's tiles in a block: K and V of the group and two (Q, dO) stages at
    a pitch of the width + 8; P, dS and dS summed over the heads at 64 x 72
    (the bfloat16 body: all bfloat16 but the head sum)."""
    if bf16:
        return 2 * ((2 * group + 4) * 64 * (width + 8) + 2 * 64 * 72) + 4 * 64 * 72
    return 4 * ((2 * group + 4) * 64 * (width + 8) + 3 * 64 * 72)


@pytest.mark.parametrize("D,V", [(1, 1), (8, 16), (25, 25), (32, 32), (33, 20), (48, 40), (16, 64), (64, 64)])
def test_bf16_relbias_plans_at_every_narrow_width(D, V):
    """K7's and K7-det's bfloat16 plans at every narrow width: 4 heads a
    block at width 32, 2 at 64, the shared bytes of bfloat16 tiles with ml-3b's
    tables staged (route ``narrow``) within a Hopper block's, the
    pre-scaling pass's grid and buffers; K7-det on K7's body: its route,
    bytes and buffers, one row of table sums per (key tile, head group,
    batch row)."""
    from generative_recommenders_tpu_torch.ops.cuda import hstu_attention_relbias as hr

    B, N, H, Nm, NB = 96, 511, 8, 511, 128
    width = 32 if max(D, V) <= 32 else 64
    group = {32: 4, 64: 2}[width]
    assert hr._HEAD_GROUP_BF16 == {32: 4, 64: 2, 128: 2}
    plan = hr._relbias_bwd_plan(D, V, H, Nm, NB, torch.bfloat16, B, N)
    shared = _relbias_tile_bytes(width, group, True) + 4 * (2 * (2 * Nm - 1) + 17 * (NB + 1))
    assert plan == dict(route="narrow", width=width, head_group=group, head_groups=-(-H // group),
                        shared_bytes=shared, prescale_grid=(B * N,), q_scaled_shape=(B, N, H, D),
                        do_scaled_shape=(B, N, H, V))
    assert shared <= SHARED
    det = hr._relbias_det_plan(D, V, H, B, N, Nm, NB, True, 0, torch.bfloat16)
    assert (det["route"], det["shared_bytes"], det["head_group"]) == ("narrow", shared, group)
    assert det["grid"] == (-(-N // 64), -(-H // group), B)
    assert det["partial_shape"] == (-(-N // 64) * -(-H // group) * B, 2 * Nm - 1 + NB + 1)
    assert {k: det[k] for k in ("prescale_grid", "q_scaled_shape", "do_scaled_shape")} == {
        k: plan[k] for k in ("prescale_grid", "q_scaled_shape", "do_scaled_shape")}


def _largest_staged_table(width, group, bf16, NB):
    """The longest position table (Nm) that K7's body stages beside its
    tiles and NB + 1 buckets."""
    free = (SHARED - _relbias_tile_bytes(width, group, bf16)) // 4 - 17 * (NB + 1)
    return (free // 2 + 1) // 2


@pytest.mark.parametrize("width", [32, 64])
@pytest.mark.parametrize("NB", [128, 1000])
def test_bf16_relbias_read_threshold(width, NB):
    """The tables-read route's threshold on bfloat16: bfloat16 tiles leave
    the tables more room than float32 ones, so longer tables are staged
    (route ``narrow``) up to the last Nm that fits and read beyond it (route
    ``read``: the tiles and 16 copies of the reachable buckets); the float32
    plan reads the longest table the bfloat16 one stages. K7-det reads where
    K7 does."""
    from generative_recommenders_tpu_torch.ops.cuda import hstu_attention_relbias as hr

    B, N, H = 2, 256, 8
    group = {32: 4, 64: 2}[width]
    last = _largest_staged_table(width, group, True, NB)
    assert last > _largest_staged_table(width, 128 // width, False, NB)
    for Nm, route in ((last, "narrow"), (last + 1, "read")):
        plan = hr._relbias_bwd_plan(width, width, H, Nm, NB, torch.bfloat16, B, N)
        assert plan["route"] == route and plan["shared_bytes"] <= SHARED
        if route == "read":
            assert plan["shared_bytes"] == _relbias_tile_bytes(width, group, True) + 4 * 16 * min(NB + 1, 296)
        assert hr._relbias_det_plan(width, width, H, B, N, Nm, NB, True, 0, torch.bfloat16)["route"] == route
    assert hr._relbias_bwd_plan(width, width, H, last, NB)["route"] == "read"


def test_bf16_relbias_plan_at_the_long_history_layer():
    """At N = Nm = 4096 (ml-3b's widths) the bfloat16 body stages both
    tables (route ``narrow``) where the float32 body reads them."""
    from generative_recommenders_tpu_torch.ops.cuda import hstu_attention_relbias as hr

    assert hr._relbias_bwd_plan(32, 32, 8, 4096, 128, torch.bfloat16, 2, 4096)["route"] == "narrow"
    assert hr._relbias_bwd_plan(32, 32, 8, 4096, 128)["route"] == "read"


@pytest.mark.parametrize("D,V", [(1, 1), (25, 25), (32, 32), (40, 16), (64, 64), (16, 100), (128, 128),
                                 (200, 96), (256, 128)])
def test_bf16_dq_plan_at_every_narrow_width(D, V):
    """K3-bf16's plan at every narrow width: 4 warps of 16 query rows a
    block, 64-column key steps up to width 64 and 32 above, bfloat16 Q and
    dO resident and two stages of K and V within a Hopper block's shared
    memory, a block per (query tile, head, batch row), and the pre-scaling
    pass's grid and buffers."""
    B, N, H = 96, 511, 8
    plan = ha._dq_plan(D, V, H, B, N, torch.bfloat16)
    width = next(w for w in (32, 64, 128, 256) if max(D, V) <= w)
    cols = 64 if width <= 64 else 32
    assert ha._DQ_TILING_BF16[width] == (64, cols, 4)
    vw = min(width, 128)
    assert plan == dict(route="narrow", width=width, query_rows=64, key_cols=cols, head_group=1, warps=4,
                        shared_bytes=2 * (64 + 2 * cols) * (width + 8 + vw + 8), grid=(-(-N // 64) * H * B,),
                        prescale_grid=(B * N,), q_scaled_shape=(B, N, H, D), do_scaled_shape=(B, N, H, V))
    assert plan["shared_bytes"] <= SHARED


def test_float32_backward_plans_stay():
    """The float32 plans of K3 and K7 are those of the float32 bodies, with
    no key of the bfloat16 ones, and the element type defaults to float32;
    the wide routes are taken at the same widths and grids on both types,
    the bfloat16 one with its pre-scaling pass."""
    from generative_recommenders_tpu_torch.ops.cuda import hstu_attention_relbias as hr

    for D in (25, 32, 64):
        width = 32 if D <= 32 else 64
        group = 128 // width
        plan = hr._relbias_bwd_plan(D, D, 8, 511, 128)
        assert plan == hr._relbias_bwd_plan(D, D, 8, 511, 128, torch.float32, 96, 511) == dict(
            route="narrow", width=width, head_group=group, head_groups=-(-8 // group),
            shared_bytes=_relbias_tile_bytes(width, group, False) + 4 * (2 * 1021 + 17 * 129))
        assert "q_scaled_shape" not in hr._relbias_det_plan(D, D, 8, 96, 511, 511, 128)
    for D, cols in ((32, 64), (64, 64), (128, 64), (256, 32)):
        vw = min(D, 128)
        assert ha._dq_plan(D, vw, 4, 8, 1036) == ha._dq_plan(D, vw, 4, 8, 1036, torch.float32) == dict(
            route="narrow", width=D, query_rows=64, key_cols=cols, head_group=1,
            shared_bytes=4 * ((64 + 2 * cols) * (D + 8 + vw + 8) + 64 * (cols + 8) + 4),
            grid=(-(-1036 // 64) * 4 * 8,))
    for b16, f32 in ((ha._dq_plan(320, 64, 2, 2, 256, torch.bfloat16), ha._dq_plan(320, 64, 2, 2, 256)),
                     (hr._relbias_bwd_plan(136, 136, 2, 100, 128, torch.bfloat16),
                      hr._relbias_bwd_plan(136, 136, 2, 100, 128))):
        assert b16["route"] == f32["route"] == "wide" and b16["grid"] == f32["grid"]
        assert "q_scaled_shape" in b16 and "q_scaled_shape" not in f32


def _recorded(monkeypatch):
    """The launches, recorded and not made."""
    calls = []
    monkeypatch.setattr(ha, "_launch", lambda *a: calls.append(a))
    monkeypatch.setattr(ha, "_stream", lambda device: 0)
    return calls


@pytest.mark.parametrize("alpha", [1.0, 0.3])
@pytest.mark.parametrize("deterministic", [False, True], ids=["K7-bf16", "K7-det-bf16"])
@pytest.mark.parametrize("Nm,D,route", [(70, 32, "narrow"), (8000, 32, "read"), (70, 136, "wide")])
def test_bf16_relbias_launch_passes_its_buffers(monkeypatch, alpha, deterministic, Nm, D, route):
    """`_relbias_bwd` on bfloat16 (the launch recorded, not made): on every
    route (the bfloat16 body's ``narrow`` and ``read``, and ``wide``, whose
    clusters take the pre-scaling pass too) bfloat16(alpha q)'s buffer
    after dO where alpha != 1 (None at alpha 1), then bfloat16(dO / norm)'s,
    the rows read in pieces of 8 elements (q, k and v views of one
    projection at a pitch of 80 elements, dO contiguous); the plan's route;
    one count on K7-bf16's or K7-det-bf16's counter."""
    from generative_recommenders_tpu_torch.ops.cuda import hstu_attention_relbias as hr

    calls = _recorded(monkeypatch)
    B, N, H = 2, 70, 3
    if D == 32:
        proj = torch.zeros(B, N, H * 80, dtype=torch.bfloat16)
        q, k, v = (x.reshape(B, N, H, -1) for x in torch.split(proj, [H * 32, H * 32, H * 16], dim=-1))
    else:
        q, k, v = (torch.zeros(B, N, H, D, dtype=torch.bfloat16) for _ in range(3))
    V = v.shape[3]
    do = torch.zeros(B, N, H, V, dtype=torch.bfloat16)
    lens, ts = torch.tensor([N, 9], dtype=torch.int32), torch.zeros(B, N)
    kw = dict(alpha=alpha, max_seq_len=None, causal=True, max_attn_len=0, contextual_seq_len=0,
              min_full_attn_seq_len=0)
    c = hr.hstu_mha_relbias_bwd_cuda
    counter = c.launches_det_bf16 if deterministic else c.launches_bf16
    before = counter.count
    hr._relbias_bwd(q, k, v, lens, None, ts, torch.zeros(2 * Nm - 1), torch.zeros(129), do, kw, deterministic)
    assert counter.count == before + 1
    (call,) = calls
    name = "hstu_mha_relbias_bwd_det_bf16" if deterministic else "hstu_mha_relbias_bwd_bf16"
    assert call[0] == name and len(call) - 1 == len(ha._ARGTYPES[name])
    plan = (hr._relbias_det_plan(D, V, H, B, N, Nm, 128, True, 0, torch.bfloat16) if deterministic
            else hr._relbias_bwd_plan(D, V, H, Nm, 128, torch.bfloat16, B, N))
    assert plan["route"] == route and call[-2] == ha._ROUTES[route]
    assert (call[5] is None) == (alpha == 1.0) and isinstance(call[6], int) and call[5] != call[6]
    assert plan["q_scaled_shape"] == (B, N, H, D) and plan["do_scaled_shape"] == (B, N, H, V)
    assert call[-6:-2] == (1, 1, 1, 1) == tuple(int(ha._vec16(t, 8)) for t in (q, k, v, do))


@pytest.mark.parametrize("alpha", [1.0, 0.3])
@pytest.mark.parametrize("D,route", [(32, "narrow"), (200, "narrow"), (320, "wide")])
def test_bf16_dq_launch_passes_its_buffers(monkeypatch, alpha, D, route):
    """`_bwd_kernel` for K3-bf16 (the launch recorded, not made): on the
    bfloat16 body (route ``narrow``) and on the wide route alike alpha q's
    buffer after dO where alpha != 1, then dO / norm's, and pieces of 8
    elements; dq bfloat16 and dk, dv None."""
    calls = _recorded(monkeypatch)
    B, N, H, V = 2, 70, 3, 64
    q, k = torch.zeros(B, N, H, D, dtype=torch.bfloat16), torch.zeros(B, N, H, D, dtype=torch.bfloat16)
    v, do = torch.zeros(B, N, H, V, dtype=torch.bfloat16), torch.zeros(B, N, H, V, dtype=torch.bfloat16)
    kw = dict(alpha=alpha, max_seq_len=None, causal=True, max_attn_len=0, contextual_seq_len=0,
              min_full_attn_seq_len=0)
    dq, dk, dv = ha._bwd_kernel("hstu_mha_bwd_dq_bf16", q, k, v, torch.tensor([N, 9], dtype=torch.int32), None, do,
                                kw)
    assert dq.dtype == torch.bfloat16 and dk is None and dv is None
    (call,) = calls
    assert len(call) - 1 == len(ha._ARGTYPES["hstu_mha_bwd_dq_bf16"]) and call[-2] == ha._ROUTES[route]
    assert ha._dq_plan(D, V, H, B, N, torch.bfloat16)["route"] == route
    assert (call[5] is None) == (alpha == 1.0) and isinstance(call[6], int)
    assert call[7] == dq.data_ptr()
    assert call[-6:-2] == tuple(int(ha._vec16(t, 8)) for t in (q, k, v, do))
