"""K7 and K7-det at heads of 65 to 128, and K5-bf16's 16-byte pieces, on the CPU.

* `_relbias_bwd_plan` and `_relbias_det_plan` take the one-pass bodies
  (route ``narrow``; ``read`` where the tables do not fit) at D, V in {72,
  96, 128} and at D 128 / V 64, on float32 and bfloat16, within a Hopper
  block's 232,448 bytes of shared memory: K and V of the head group (one
  head on float32, two on bfloat16), two (Q, dO) stages (of 32 query rows on
  float32 at width 128, of 64 on bfloat16), P
  and dS (on float32 one head's dS is its own head sum), both tables and the
  warps' copies of dts_w. Heads above 128 keep the wide bodies.
* K7-det's dQ slots (`_det_slot`) against a Python walk of the C kernel's
  steps: every visited (query tile, key tile) pair writes its slot once, and
  the ordered sum reads exactly the slots that were written.
* K5-bf16's plan and launch: 8 elements a lane in one 16-byte load (D padded
  to 64, 128 or 256) and the ``vec`` flags of 8-element pieces.
* The plain backward against `hstu_mha_dense_pallas_relbias` in interpret
  mode (`jax.grad` through it) at D = V = 96 and D 128 / V 64: the function
  the card holds the one-pass kernels to.

Tolerances: gradients within 2e-5 of each one's largest entry (float32 sums
in other orders), as `tests/test_torch_shapes.py`'s.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from generative_recommenders_tpu.ops.pallas.hstu_attention_relbias import hstu_mha_dense_pallas_relbias
from generative_recommenders_tpu_torch.ops.cuda import hstu_attention as ha
from generative_recommenders_tpu_torch.ops.cuda import hstu_attention_relbias as hr

SHARED = 232448  # a Hopper block's shared memory
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = 2e-5  # of each gradient's largest entry
ONE_PASS = [(72, 72), (96, 96), (128, 128), (128, 64), (64, 128), (65, 8)]
TYPES = [torch.float32, torch.bfloat16]


def _tiles_128(bf16: bool) -> int:
    """The bytes of K7's tiles at width 128, from the C bodies' layouts: K, V
    of the head group (float32 one head, bfloat16 two) and the (Q, dO)
    stages at a pitch of 136 (float32: two of 32 query rows, bfloat16: two
    of 64), P, dS (and on bfloat16 dS's float32 head sum) at 32 or 64 x
    72."""
    if bf16:
        return 2 * (2 * 2 + 4) * 64 * 136 + 2 * 2 * 64 * 72 + 4 * 64 * 72
    return 4 * (2 * 64 * 136 + 2 * 2 * 32 * 136 + 2 * 32 * 72)


@pytest.mark.parametrize("dtype", TYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("D,V", ONE_PASS)
def test_one_pass_plans_up_to_128(D, V, dtype):
    """Width 128, one head a block on float32 and two on bfloat16, staged
    tables at ml-20m's Nm 211, within a block's shared memory; K7-det on the
    same body and grid, with its dQ slots and table rows."""
    B, N, H, Nm, NB = 128, 211, 2, 211, 128
    bf16 = dtype == torch.bfloat16
    group = 2 if bf16 else 1
    plan = hr._relbias_bwd_plan(D, V, H, Nm, NB, dtype, B, N)
    shared = _tiles_128(bf16) + 4 * (2 * (2 * Nm - 1) + 17 * (NB + 1))
    want = dict(route="narrow", width=128, head_group=group, head_groups=H // group, shared_bytes=shared)
    if bf16:
        want.update(prescale_grid=(B * N,), q_scaled_shape=(B, N, H, D), do_scaled_shape=(B, N, H, V))
    assert plan == want and shared <= SHARED
    det = hr._relbias_det_plan(D, V, H, B, N, Nm, NB, True, 0, dtype)
    assert (det["route"], det["width"], det["head_group"], det["shared_bytes"]) == ("narrow", 128, group, shared)
    assert det["grid"] == (4, H // group, B) and det["partial_shape"] == (4 * H // group * B, 2 * Nm - 1 + NB + 1)
    assert det["dq_partial_shape"] == (B, 10, 64, H, D) and det["pairs"] == 10


def test_float32_tiling_mirrors_the_body():
    """`_TILING_F32` is the C body's `Tiling`: 4, 2 and 1 heads a block, two
    (Q, dO) stages, 64-row steps up to width 64 and 32-row ones at 128 (two
    64-row stages do not fit beside K and V: 264,192 bytes of tiles)."""
    assert hr._TILING_F32 == {32: (4, 64, 2), 64: (2, 64, 2), 128: (1, 32, 2)}
    assert hr._HEAD_GROUP_BF16 == {32: 4, 64: 2, 128: 2}
    assert 4 * ((2 + 4) * 64 * 136 + 3 * 64 * 72) == 264192 > SHARED
    assert hr._NARROW_BWD_WIDTH == 128


def _last_staged(bf16: bool, NB: int) -> int:
    free = (SHARED - _tiles_128(bf16)) // 4 - 17 * (NB + 1)
    return (free // 2 + 1) // 2


@pytest.mark.parametrize("dtype", TYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("NB", [128, 1000])
def test_long_tables_are_read_at_128(dtype, NB):
    """The position table is staged up to the last Nm that fits beside the
    width-128 tiles and read beyond (route ``read``: the tiles and 16 copies
    of dts_w's 296 reachable buckets); K7-det reads where K7 does."""
    bf16 = dtype == torch.bfloat16
    last = _last_staged(bf16, NB)
    for Nm, route in ((last, "narrow"), (last + 1, "read"), (22000, "read")):
        plan = hr._relbias_bwd_plan(128, 128, 2, Nm, NB, dtype, 2, 256)
        assert plan["route"] == route and plan["shared_bytes"] <= SHARED, (Nm, plan)
        if route == "read":
            assert plan["shared_bytes"] == _tiles_128(bf16) + 4 * 16 * min(NB + 1, 296)
        assert hr._relbias_det_plan(128, 128, 2, 2, 256, Nm, NB, True, 0, dtype)["route"] == route


@pytest.mark.parametrize("D,V", [(129, 64), (64, 129), (256, 256), (320, 136)])
def test_wider_heads_keep_the_wide_bodies(D, V):
    for dtype in TYPES:
        assert hr._relbias_bwd_plan(D, V, 2, 211, 128, dtype, 4, 211)["route"] == "wide"
        assert hr._relbias_det_plan(D, V, 2, 4, 211, 211, 128, True, 0, dtype)["route"] == "wide"


def _walk(length: int, tiles: int, lower_only: bool, rows: int) -> dict:
    """The C walk's writes to the dQ slots: each block (key tile kt below the
    length) visits the query rows from its own tile (``lower_only``) or from
    0, ``rows`` a step, and stores each step's rows to its tile pair's slot;
    {(slot, first row within the 64-row tile): times written}."""
    seen = {}
    for kt in range(tiles):
        if kt * 64 >= length:
            continue
        row0 = kt * 64 if lower_only else 0
        while row0 < length:
            key = (hr._det_slot(row0 // 64, kt, tiles, lower_only), row0 % 64)
            seen[key] = seen.get(key, 0) + 1
            row0 += rows
    return seen


@pytest.mark.parametrize("causal,ctx", [(True, 0), (True, 3), (False, 0)], ids=["causal", "contextual", "non-causal"])
@pytest.mark.parametrize("N", [1, 64, 65, 211, 1000])
def test_det_slots_cover_every_visited_pair_once(N, causal, ctx):
    """At width 128 (the plan's 32-row steps, `_TILING_F32`: two to a 64-row
    query tile) every tile pair the walk visits writes each half of its slot
    once, each slot index lies below the
    plan's ``pairs``, and `det_sums_kernel`'s read of query tile qt (key
    tiles 0 .. qt where ``lower_only``, else every key tile below the length)
    finds exactly the written slots, at lengths from 1 to N."""
    det = hr._relbias_det_plan(128, 128, 2, 2, N, N, 128, causal, ctx)
    tiles, lower_only, pairs = det["tiles"], det["lower_only"], det["pairs"]
    rows = hr._TILING_F32[128][1]
    for length in sorted({1, N // 2 + 1, N}):
        seen = _walk(length, tiles, lower_only, rows)
        assert set(seen.values()) == {1}
        written = {slot for slot, _ in seen}
        assert all(0 <= s < pairs for s in written)
        read = set()
        for qt in range(-(-length // 64)):
            kts = qt + 1 if lower_only else -(-length // 64)
            read |= {hr._det_slot(qt, kt, tiles, lower_only) for kt in range(kts)}
        assert read == written


@pytest.mark.parametrize("D,padded", [(8, 64), (25, 64), (64, 64), (96, 128), (128, 128), (200, 256), (512, 256)])
def test_delta_bf16_plan_takes_8_element_pieces(D, padded):
    """K5-bf16's plan: a lane reads 8 elements of a K row in one 16-byte load
    and owns 8 V columns, so q's staged rows are D padded to 64, 128 or 256
    (one row of 256 in the wide instance above 256); float32 keeps 4 and its
    padding to 32, 64, 128 or 256."""
    B, M, N, H, V = 32, 5, 523, 4, 128
    f32 = ha._delta_plan(B, M, N, H, V, D)
    b16 = ha._delta_plan(B, M, N, H, V, D, torch.bfloat16)
    assert (f32["k_piece"], f32["v_piece"], b16["k_piece"], b16["v_piece"]) == (4, 4, 8, 8)
    red = 4 * 4 * 8 * 128 + 4
    rows = 256 if D > 256 else 8 * padded
    assert b16["shared_bytes"] == 4 * rows + red
    f32_pad = next(w for w in (32, 64, 128, 256) if D <= w) if D <= 256 else None
    assert f32["shared_bytes"] == 4 * (256 if D > 256 else 8 * f32_pad) + red
    assert {k: v for k, v in b16.items() if k != "shared_bytes"} == dict(
        {k: v for k, v in f32.items() if k != "shared_bytes"}, k_piece=8, v_piece=8)


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
def test_delta_launch_passes_the_pieces_of_its_type(monkeypatch, bf16):
    """`_delta_fwd` (the launch recorded, not made) tells the kernel whether K
    and V rows are readable in 16-byte pieces of its type's elements: views
    at a pitch of 4 elements (but not 8) are on float32, not on bfloat16."""
    calls = []
    monkeypatch.setattr(ha, "_launch", lambda *a: calls.append(a))
    monkeypatch.setattr(ha, "_stream", lambda device: 0)
    monkeypatch.setattr(ha, "_delta_counter_buffer", lambda device, n: torch.zeros(n, dtype=torch.int32))
    dtype = torch.bfloat16 if bf16 else torch.float32
    B, M, N, H, D = 2, 3, 100, 2, 16
    q = torch.zeros(B, M, H, D, dtype=dtype)
    proj = torch.zeros(B, N, H * (D + 20) + 4, dtype=dtype)  # a row pitch of 76: 4 divides it, 8 does not
    k = proj[..., 4:4 + H * D].reshape(B, N, H, D)
    v = proj[..., 4 + H * D:].reshape(B, N, H, 20)
    kw = dict(alpha=0.5, norm_len=None, max_attn_len=0, contextual_seq_len=0, min_full_attn_seq_len=0)
    ha._delta_fwd(q, k, v, torch.tensor([100, 40], dtype=torch.int32), None, kw)
    (call,) = calls
    vec_k, vec_v = call[-3], call[-2]
    assert (vec_k, vec_v) == ((0, 0) if bf16 else (int(ha._vec16(k, 4)), int(ha._vec16(v, 4))))
    assert (vec_k, vec_v) == (int(ha._vec16(k, 8 if bf16 else 4)), int(ha._vec16(v, 8 if bf16 else 4)))
    calls.clear()
    ha._delta_fwd(q, k.contiguous(), v.contiguous()[..., :16].contiguous(), torch.tensor([100, 40], dtype=torch.int32),
                  None, kw)
    assert calls[0][-3:-1] == (1, 1)


def _close_to_max(got, want, tol, what):
    got = np.asarray(torch.as_tensor(got).detach().float(), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err:.2e} of the largest entry"


@pytest.mark.parametrize("D,V", [(96, 96), (128, 64)])
def test_relbias_plain_matches_pallas_at_one_pass_widths(D, V):
    """K6's and K7's plain versions against `hstu_mha_dense_pallas_relbias`
    in interpret mode and `jax.grad` through it (q, k, v and both tables),
    with a row of full length and a short one, at widths the one-pass bodies
    now take."""
    rng = np.random.default_rng(36)
    B, N, H, Nm = 2, 40, 2, 40
    q, k = ((rng.standard_normal((B, N, H, D)) * 0.3).astype(np.float32) for _ in range(2))
    v = (rng.standard_normal((B, N, H, V)) * 0.3).astype(np.float32)
    do = rng.standard_normal((B, N, H, V)).astype(np.float32)
    lengths = np.array([N, 23], np.int32)
    ts = (1_600_000_000 + np.cumsum(rng.integers(1, 90000, size=(B, N)), axis=1)).astype(np.int64)
    pos_w = (rng.standard_normal(2 * Nm - 1) * 0.05).astype(np.float32)
    ts_w = (rng.standard_normal(129) * 0.05).astype(np.float32)
    kw = dict(alpha=D**-0.5, max_seq_len=N, num_buckets=128)

    def loss(q_, k_, v_, p_, t_):
        out = hstu_mha_dense_pallas_relbias(q_, k_, v_, jnp.asarray(lengths), jnp.asarray(ts), p_, t_,
                                            block_q=128, block_k=128, interpret=True, **kw)
        return jnp.sum(out * jnp.asarray(do)), out

    (_, want_out), want = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *map(jnp.asarray, (q, k, v, pos_w, ts_w)))
    t = torch.as_tensor
    got_out = hr.hstu_mha_dense_relbias_cuda(t(q), t(k), t(v), t(lengths), t(ts), t(pos_w), t(ts_w), **kw)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), **FWD_TOL)
    got = hr.hstu_mha_relbias_bwd_cuda(t(q), t(k), t(v), t(lengths), t(ts), t(pos_w), t(ts_w), t(do), **kw)
    for name, g, w in zip(("dq", "dk", "dv", "dpos_w", "dts_w"), got, want, strict=True):
        _close_to_max(g, w, GRAD_TOL, name)
