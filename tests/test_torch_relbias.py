"""The PyTorch port's relative-bias attention against the JAX package: the
plain version (`hstu_mha_dense_relbias_plain`, and the wrappers on CPU
tensors) against `hstu_mha_dense_pallas_relbias` in interpret mode, forward
and, by `jax.grad` against autograd, backward (dq, dk, dv and both bias
tables' gradients); the wiring of the autograd function that joins K6 and K7
on the card, and its K7-det under deterministic mode; the lengths at which the
CUDA backward's 64 x 64 tile pairs and the forward's 32-column key tiles
end, and head counts that the forward's and backward's head groups do not
fill; and what K6's and K7's wrappers compute in Python (head width, head
group and shared-memory size). Inputs are made with
numpy from a seed, as `tests/test_relbias_attention.py` makes them.

Tolerances as that file's: forward rtol = atol = 2e-5, gradients 2e-4 (both
sides are float32 but sum in different orders; a table entry sums up to
B * H * N^2 / 2 terms).
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from generative_recommenders_tpu.ops.pallas.hstu_attention_relbias import (
    hstu_mha_dense_pallas_relbias,
)
from generative_recommenders_tpu_torch.ops.cuda import hstu_attention_relbias as hr

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
BWD_TOL = dict(rtol=2e-4, atol=2e-4)

# the mask cases of tests/test_relbias_attention.py
CASES = [
    dict(),
    dict(num_targets=True),
    dict(max_attn_len=37),
    dict(num_targets=True, max_attn_len=37, min_full_attn_seq_len=16),
]


def _setup(seed, B, N, H, D, V, table_max_len, nb=128):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, N, H, D)).astype(np.float32) * 0.3
    k = rng.standard_normal((B, N, H, D)).astype(np.float32) * 0.3
    v = rng.standard_normal((B, N, H, V)).astype(np.float32) * 0.3
    lengths = rng.integers(1, N + 1, size=(B,)).astype(np.int32)
    lengths[0] = N
    # sorted per-row timestamps at unix-like magnitudes: the float32 cast
    # rounds them, on both sides alike
    steps = rng.integers(1, 90000, size=(B, N))
    ts = 1_600_000_000 + np.cumsum(steps, axis=1)
    pos_w = (rng.standard_normal(2 * table_max_len - 1) * 0.05).astype(np.float32)
    ts_w = (rng.standard_normal(nb + 1) * 0.05).astype(np.float32)
    return q, k, v, lengths, ts.astype(np.int64), pos_w, ts_w


def _targets(case, lengths, seed):
    if not case.pop("num_targets", False):
        return None
    rng = np.random.default_rng(seed)
    return np.minimum(rng.integers(0, 6, size=lengths.shape), lengths - 1).clip(0).astype(np.int32)


def _pallas(q, k, v, lengths, ts, pos_w, ts_w, nt, case):
    return hstu_mha_dense_pallas_relbias(
        q, k, v, jnp.asarray(lengths), jnp.asarray(ts), pos_w, ts_w,
        num_targets=None if nt is None else jnp.asarray(nt),
        block_q=128, block_k=128, interpret=True, **case,
    )


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", [(3, 211, 2, 8, 8, 211), (2, 384, 2, 8, 8, 500)])
def test_plain_forward_matches_pallas(case, shape):
    case = dict(case)
    B, N, H, D, V, Nm = shape
    q, k, v, lengths, ts, pos_w, ts_w = _setup(0, B, N, H, D, V, Nm)
    nt = _targets(case, lengths, 1)
    want = np.asarray(_pallas(*map(jnp.asarray, (q, k, v)), lengths, ts,
                              jnp.asarray(pos_w), jnp.asarray(ts_w), nt, case))
    t = torch.as_tensor
    args = (t(q), t(k), t(v), t(lengths), t(ts), t(pos_w), t(ts_w))
    kw = dict(num_targets=None if nt is None else t(nt), **case)
    got = hr.hstu_mha_dense_relbias_plain(*args, **kw)
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
    for b in range(B):
        assert (got[b, lengths[b]:] == 0).all(), "rows >= length are not 0"
    # the wrapper computes the plain version on CPU tensors
    torch.testing.assert_close(hr.hstu_mha_dense_relbias_cuda(*args, **kw), got, rtol=0, atol=0)


@pytest.mark.parametrize("case", [dict(), dict(num_targets=True, max_attn_len=37)])
def test_plain_backward_matches_pallas(case):
    """`jax.grad` through the Pallas kernels (K6's and K7's TPU originals,
    interpret mode) against autograd through the plain version, for q, k, v
    and both tables. The output gradient is zero on rows >= length on both
    sides (both give zeros there)."""
    case = dict(case)
    B, N, H, D, V, Nm = 2, 211, 2, 8, 8, 211
    q, k, v, lengths, ts, pos_w, ts_w = _setup(3, B, N, H, D, V, Nm)
    nt = _targets(case, lengths, 4)
    w = np.random.default_rng(5).standard_normal((B, N, H, V)).astype(np.float32)
    for b in range(B):
        w[b, lengths[b]:] = 0.0

    def loss(q_, k_, v_, pw_, tw_):
        return jnp.sum(_pallas(q_, k_, v_, lengths, ts, pw_, tw_, nt, case) * jnp.asarray(w))

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (q, k, v, pos_w, ts_w)))
    t = torch.as_tensor
    kw = dict(num_targets=None if nt is None else t(nt), **case)
    leaves = [t(x).requires_grad_(True) for x in (q, k, v, pos_w, ts_w)]
    out = hr.hstu_mha_dense_relbias_cuda(*leaves[:3], t(lengths), t(ts), *leaves[3:], **kw)
    (out * t(w)).sum().backward()
    # the backward wrapper computes the plain backward on CPU tensors
    direct = hr.hstu_mha_relbias_bwd_cuda(t(q), t(k), t(v), t(lengths), t(ts), t(pos_w), t(ts_w), t(w), **kw)
    for name, leaf, d, g in zip(("dq", "dk", "dv", "dpos_w", "dts_w"), leaves, direct, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), err_msg=name, **BWD_TOL)
        # twice the same plain backward; the tables' index sums may reorder
        torch.testing.assert_close(d, leaf.grad, rtol=1e-5, atol=1e-6)
    for b in range(B):
        for leaf in leaves[:3]:
            assert (leaf.grad[b, lengths[b]:] == 0).all()


def test_bias_reads_the_next_timestamp_past_the_length():
    """Row length - 1 reads the timestamp at index ``length``, where training
    scatters the target's: changing it changes that row and no other."""
    B, N, H, D, V, Nm = 2, 40, 2, 8, 8, 40
    q, k, v, lengths, ts, pos_w, ts_w = _setup(7, B, N, H, D, V, Nm)
    lengths[:] = [N, 17]
    ts[1, 17:] = 0
    t = torch.as_tensor
    base = hr.hstu_mha_dense_relbias_plain(t(q), t(k), t(v), t(lengths), t(ts), t(pos_w), t(ts_w))
    ts2 = ts.copy()
    ts2[1, 17] = ts[1, 16] + 5_000_000
    moved = hr.hstu_mha_dense_relbias_plain(t(q), t(k), t(v), t(lengths), t(ts2), t(pos_w), t(ts_w))
    changed = (base != moved).any(dim=-1).any(dim=-1)  # [B, N]
    assert changed[1, 16] and changed.sum() == 1
    want = np.asarray(_pallas(*map(jnp.asarray, (q, k, v)), lengths, ts2,
                              jnp.asarray(pos_w), jnp.asarray(ts_w), None, {}))
    np.testing.assert_allclose(moved.numpy(), want, **FWD_TOL)


def _stand_ins(monkeypatch):
    """K6's launch replaced by the plain forward on CPU tensors, with the
    arguments the launch helper gets; the backward wrapper (which computes
    the plain backward on CPU tensors) recorded as K7, or as K7-det where it
    is asked for the fixed order. Returns the list of calls."""
    called = []

    def fwd(q, k, v, lens, nt, ts, pos_w, ts_w, kw):
        called.append("K6")
        assert ts.dtype == torch.float32
        return hr.hstu_mha_dense_relbias_plain(
            q, k, v, lens, ts, pos_w, ts_w, num_targets=nt, num_buckets=ts_w.shape[0] - 1, **kw
        )

    bwd = hr.hstu_mha_relbias_bwd_cuda
    monkeypatch.setattr(hr, "_relbias_fwd", fwd)
    monkeypatch.setattr(
        hr, "hstu_mha_relbias_bwd_cuda",
        lambda *a, **kw: called.append("K7-det" if kw["deterministic"] else "K7") or bwd(*a, **kw),
    )
    return called


def _through_the_function(q, k, v, lengths, ts, pos_w, ts_w, nt, weight, kw):
    """Gradients of the five leaves through `_HstuMhaRelbias`, on q, k and v
    that are views of one projection, as the STU passes them."""
    t = torch.as_tensor
    B, N, H, D = q.shape
    V = v.shape[3]
    proj = torch.cat([t(v).reshape(B, N, H * V), t(q).reshape(B, N, H * D), t(k).reshape(B, N, H * D)], dim=-1)
    proj.requires_grad_(True)
    v_, q_, k_ = torch.split(proj, [H * V, H * D, H * D], dim=-1)
    tables = [t(pos_w).requires_grad_(True), t(ts_w).requires_grad_(True)]
    out = hr._HstuMhaRelbias.apply(
        q_.reshape(B, N, H, D), k_.reshape(B, N, H, D), v_.reshape(B, N, H, V),
        *tables, t(ts).float(), t(lengths), None if nt is None else t(nt), kw,
    )
    (out.reshape(B, N, H * V) * weight).sum().backward()
    return proj.grad, tables[0].grad, tables[1].grad


def test_autograd_function_joins_k6_and_k7(monkeypatch):
    """`_HstuMhaRelbias`, which `hstu_mha_dense_relbias_cuda` applies on CUDA
    tensors, driven on the CPU with both launches replaced by the plain
    versions: q, k, v, ``pos_w`` and ``ts_w`` all get gradients, equal to
    autograd through the plain forward; the timestamps and lengths get none.
    The output gradient comes from a reshape of a transposed buffer and is
    not contiguous."""
    B, N, H, D, V, Nm = 2, 24, 2, 8, 8, 30
    q, k, v, lengths, ts, pos_w, ts_w = _setup(9, B, N, H, D, V, Nm, nb=16)
    nt = np.array([3, 1], np.int32)
    kw = dict(alpha=0.5, max_seq_len=32, causal=True, max_attn_len=0,
              contextual_seq_len=0, min_full_attn_seq_len=0)
    weight = torch.as_tensor(
        np.random.default_rng(1).standard_normal((N, B, H * V)).astype(np.float32)
    ).transpose(0, 1)
    called = _stand_ins(monkeypatch)
    got = _through_the_function(q, k, v, lengths, ts, pos_w, ts_w, nt, weight, kw)
    assert called == ["K6", "K7"]

    t = torch.as_tensor
    ref = [t(x).requires_grad_(True) for x in (q, k, v, pos_w, ts_w)]
    out = hr.hstu_mha_dense_relbias_plain(
        *ref[:3], t(lengths), t(ts), *ref[3:], num_targets=t(nt), num_buckets=16, **kw
    )
    (out.reshape(B, N, H * V) * weight).sum().backward()
    dv, dq, dk = torch.split(got[0], [H * V, H * D, H * D], dim=-1)
    for g, r in zip((dq.reshape(B, N, H, D), dk.reshape(B, N, H, D), dv.reshape(B, N, H, V), got[1], got[2]), ref):
        assert g is not None
        torch.testing.assert_close(g, r.grad, rtol=1e-5, atol=1e-6)


def test_timestamps_are_cast_before_they_are_subtracted():
    """The kernels get float32 timestamps, cast before any subtraction: the
    plain version gives the same on the integers and on their float32 cast,
    and other buckets than subtracting the integers first would give."""
    B, N, H, D, V, Nm = 2, 24, 2, 8, 8, 24
    q, k, v, lengths, ts, pos_w, ts_w = _setup(11, B, N, H, D, V, Nm)
    # steps of minutes: the 128 s rounding of the cast moves many buckets
    ts = 1_600_000_000 + np.cumsum(np.random.default_rng(12).integers(1, 300, size=(B, N)), axis=1)
    t = torch.as_tensor
    want = hr.hstu_mha_dense_relbias_plain(t(q), t(k), t(v), t(lengths), t(ts), t(pos_w), t(ts_w))
    torch.testing.assert_close(
        hr.hstu_mha_dense_relbias_plain(t(q), t(k), t(v), t(lengths), t(ts).float(), t(pos_w), t(ts_w)),
        want, rtol=0, atol=0,
    )
    nxt = np.minimum(np.arange(N) + 1, N - 1)
    exact = np.abs(ts[:, nxt][:, :, None] - ts[:, None, :]).astype(np.float64)
    f32 = ts.astype(np.float32)
    cast = np.abs(f32[:, nxt][:, :, None] - f32[:, None, :]).astype(np.float64)
    bucket = lambda x: np.floor(np.log(np.maximum(x, 1.0)) / 0.301)  # noqa: E731
    assert (bucket(exact) != bucket(cast)).any()


@pytest.mark.parametrize("warn_only", [False, True])
def test_backward_raises_under_deterministic_mode(warn_only, monkeypatch):
    """Under `torch.use_deterministic_algorithms(True)`, with or without
    ``warn_only``, the backward no longer raises or warns (K7 sums with
    atomics; the refusal is gone): it takes K7-det, the fixed-order
    backward, and gives the plain version's gradients."""
    B, N, H, D, V, Nm = 2, 12, 2, 8, 8, 12
    q, k, v, lengths, ts, pos_w, ts_w = _setup(13, B, N, H, D, V, Nm, nb=8)
    kw = dict(alpha=1.0, max_seq_len=N, causal=True, max_attn_len=0,
              contextual_seq_len=0, min_full_attn_seq_len=0)
    weight = torch.as_tensor(np.random.default_rng(14).standard_normal((B, N, H * V)).astype(np.float32))
    called = _stand_ins(monkeypatch)
    prev = torch.are_deterministic_algorithms_enabled()
    prev_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=warn_only)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = _through_the_function(q, k, v, lengths, ts, pos_w, ts_w, None, weight, kw)
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=prev_warn)
    assert called == ["K6", "K7-det"]
    t = torch.as_tensor
    ref = [t(x).requires_grad_(True) for x in (q, k, v, pos_w, ts_w)]
    out = hr.hstu_mha_dense_relbias_plain(*ref[:3], t(lengths), t(ts), *ref[3:], num_buckets=8, **kw)
    (out.reshape(B, N, H * V) * weight).sum().backward()
    dv, dq, dk = torch.split(got[0], [H * V, H * D, H * D], dim=-1)
    for g, r in zip((dq.reshape(B, N, H, D), dk.reshape(B, N, H, D), dv.reshape(B, N, H, V), got[1], got[2]), ref):
        torch.testing.assert_close(g, r.grad, rtol=1e-5, atol=1e-6)


def test_input_checks(monkeypatch):
    """The checks of the CUDA branch, driven on CPU tensors."""
    monkeypatch.setattr(hr.ha, "_check_qkv", lambda q, k, v: q.device)
    B, N, H, D = 2, 20, 2, 8
    q = torch.zeros(B, N, H, D)
    lengths, ts = torch.ones(B, dtype=torch.int64), torch.zeros(B, N, dtype=torch.int64)
    z = torch.zeros
    ok = hr._checked(q, q, q, lengths, ts, z(2 * N - 1), z(129), 128, None)
    assert ok[0].dtype == torch.float32 and ok[0].is_contiguous() and ok[1].dtype == torch.int32 and ok[2] is None
    assert hr._checked(q, q, q, lengths, ts, z(2 * N - 1), z(129), 128, lengths)[2].dtype == torch.int32
    for match, args in (
        ("2 \\* Nm - 1", (lengths, ts, z(10), z(129), 128)),
        ("num_buckets \\+ 1", (lengths, ts, z(2 * N - 1), z(100), 128)),
        ("timestamps must have shape", (lengths, ts[:, :-1], z(2 * N - 1), z(129), 128)),
        ("lengths must have shape", (lengths[:1], ts, z(2 * N - 1), z(129), 128)),
    ):
        with pytest.raises(ValueError, match=match):
            hr._checked(q, q, q, *args, None)
    long = torch.zeros(B, 130, H, D)  # N may pass Nm by 127 at most
    with pytest.raises(ValueError, match="beyond the position table"):
        hr._checked(long, long, long, lengths, z(B, 130), z(2 * 2 - 1), z(129), 128, None)
    with pytest.raises(ValueError, match="k has"):
        hr._checked(q, q[:, :-1], q, lengths, ts, z(2 * N - 1), z(129), 128, None)


TILE_EDGES = [63, 64, 65, 127, 128, 129]  # K7's 64-row and 64-column tile ends


@pytest.mark.parametrize("backward", [False, True])
def test_plain_matches_pallas_at_tile_edges(backward):
    B, N, H, D, V, Nm = len(TILE_EDGES), 130, 1, 8, 8, 130
    q, k, v, _, ts, pos_w, ts_w = _setup(21, B, N, H, D, V, Nm, nb=32)
    lengths = np.asarray(TILE_EDGES, np.int32)
    t = torch.as_tensor
    case = dict(num_buckets=32)
    if not backward:
        want = np.asarray(_pallas(*map(jnp.asarray, (q, k, v)), lengths, ts,
                                  jnp.asarray(pos_w), jnp.asarray(ts_w), None, case))
        got = hr.hstu_mha_dense_relbias_cuda(t(q), t(k), t(v), t(lengths), t(ts), t(pos_w), t(ts_w), **case)
        np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
        return
    w = np.random.default_rng(22).standard_normal((B, N, H, V)).astype(np.float32)
    for b in range(B):
        w[b, lengths[b]:] = 0.0

    def loss(q_, k_, v_, pw_, tw_):
        return jnp.sum(_pallas(q_, k_, v_, lengths, ts, pw_, tw_, None, case) * jnp.asarray(w))

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (q, k, v, pos_w, ts_w)))
    got = hr.hstu_mha_relbias_bwd_cuda(t(q), t(k), t(v), t(lengths), t(ts), t(pos_w), t(ts_w), t(w), **case)
    for name, g, r in zip(("dq", "dk", "dv", "dpos_w", "dts_w"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name, **BWD_TOL)
    for b in range(B):
        for g in got[:3]:
            assert (g[b, lengths[b]:] == 0).all()


@pytest.mark.parametrize(
    "D,V,H,Nm,NB,width,head_group,head_groups,shared_bytes",
    [
        (32, 32, 8, 511, 128, 32, 4, 2, 195116),  # the ml-3b preset
        (32, 32, 3, 211, 128, 32, 4, 1, 190316),  # a group that H does not fill
        (25, 25, 2, 200, 128, 32, 4, 1, 190140),  # padded to 32
        (16, 8, 9, 60, 16, 32, 4, 3, 180284),
        (50, 50, 1, 200, 128, 64, 2, 1, 214716),  # the ml-1m preset's one head
        (32, 64, 5, 200, 128, 64, 2, 3, 214716),  # the wider of D and V decides
    ],
)
def test_backward_launch_plan(D, V, H, Nm, NB, width, head_group, head_groups, shared_bytes):
    """K7 pads both head widths to 32 or 64, loops 4 or 2 heads inside a
    block, and sizes its shared memory: (2 HG + 4) tiles of 64 x (W + 8), P,
    dS and their head sum at 64 x 72, both tables, dpos_w's sums and 16
    copies of dts_w's."""
    plan = hr._relbias_bwd_plan(D, V, H, Nm, NB)
    assert plan == dict(route="narrow", width=width, head_group=head_group, head_groups=head_groups,
                        shared_bytes=shared_bytes)
    tiles = (2 * head_group + 4) * 64 * (width + 8) + 3 * 64 * 72
    assert shared_bytes == 4 * (tiles + 2 * (2 * Nm - 1) + 17 * (NB + 1)) <= 232448


@pytest.mark.parametrize("args,match", [((0, 32, 2, 100, 128), "at least 1"), ((32, 0, 2, 100, 128), "at least 1")])
def test_backward_launch_plan_raises(args, match):
    """What the kernel does not take raises with the sizes; nothing falls
    back to the plain version. A width of 0 is all that is left."""
    with pytest.raises(ValueError, match=match):
        hr._relbias_bwd_plan(*args)


@pytest.mark.parametrize(
    "args,route",
    [
        ((129, 32, 2, 100, 128), "wide"),
        ((32, 136, 2, 100, 128), "wide"),
        ((32, 32, 2, 100, 70000), "read"),
        ((32, 32, 2, 8000, 128), "read"),
    ],
)
def test_backward_launch_plan_admits(args, route):
    """Shapes past K7's staged tiling: heads wider than 128 take the wide bodies;
    many buckets and a long position table are read from device memory,
    with 16 copies of dts_w's 296 reachable buckets beside the tiles."""
    plan = hr._relbias_bwd_plan(*args)
    assert plan["shared_bytes"] <= 232448 and plan["route"] == route
    if route == "wide":
        assert plan["head_group"] == 1 and plan["head_groups"] == args[2]
    else:
        tiles = (2 * plan["head_group"] + 4) * 64 * (plan["width"] + 8) + 3 * 64 * 72
        assert plan["shared_bytes"] == 4 * (tiles + 16 * min(args[4] + 1, 296))


@pytest.mark.parametrize("H", [3, 5])
def test_plain_forward_matches_pallas_where_head_groups_end(H):
    """H that the forward's groups of 2 heads (and the backward's of 4) do
    not fill, at lengths around the 32-column key tiles and 128-row query
    tiles."""
    B, N, D, V, Nm = 4, 140, 8, 8, 140
    q, k, v, _, ts, pos_w, ts_w = _setup(23, B, N, H, D, V, Nm, nb=32)
    lengths = np.asarray([31, 33, 97, 129], np.int32)
    case = dict(num_buckets=32)
    want = np.asarray(_pallas(*map(jnp.asarray, (q, k, v)), lengths, ts,
                              jnp.asarray(pos_w), jnp.asarray(ts_w), None, case))
    t = torch.as_tensor
    got = hr.hstu_mha_dense_relbias_cuda(t(q), t(k), t(v), t(lengths), t(ts), t(pos_w), t(ts_w), **case)
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


@pytest.mark.parametrize("H", [1, 3, 4, 8])
@pytest.mark.parametrize("D", [25, 32, 40, 50, 64, 128, 256])
def test_forward_launch_plan(D, H):
    """K6's launch takes K1's tiling and adds both tables and the row's
    timestamps (up to the last key tile) to the block's shared memory."""
    V = min(D, 128)
    B, N, Nm, NB = 96, 511, 511, 128
    plan = hr.ha._fwd_plan(D, V, H, Nm, NB, True, B, N)
    dense = hr.ha._fwd_plan(D, V, H, 0, 0, False, B, N)
    key_tile = dense["key_tile"]
    tables = 2 * Nm - 1 + NB + 1 + -(-N // key_tile) * key_tile
    assert plan == dict(dense, shared_bytes=dense["shared_bytes"] + 4 * tables)
    assert plan["shared_bytes"] <= 232448


def test_forward_launch_plan_reads_tables_that_do_not_fit():
    """Tables that do not fit beside the tiles are read from
    device memory: the plan keeps the tiles alone."""
    plan = hr.ha._fwd_plan(128, 128, 2, 20000, 128, True, 2, 20100)
    dense = hr.ha._fwd_plan(128, 128, 2, 0, 0, False, 2, 20100)
    assert plan == dict(dense, route="read")


def test_forward_launch_goes_by_the_plan(monkeypatch):
    """`_relbias_fwd` checks the plan before it launches: tables that do not
    fit are read (a launch), a grid beyond CUDA's raises and nothing is
    launched or counted."""
    calls = []
    monkeypatch.setattr(hr.ha, "_launch", lambda *a: calls.append(a))
    monkeypatch.setattr(hr.ha, "_stream", lambda device: 0)
    B, N, H, D = 2, 40, 3, 32
    q = torch.zeros(B, N, H, D)
    lens, ts = torch.tensor([40, 9], dtype=torch.int32), torch.zeros(B, N)
    kw = dict(alpha=1.0, max_seq_len=None, causal=True, max_attn_len=0, contextual_seq_len=0,
              min_full_attn_seq_len=0)
    before = hr.hstu_mha_dense_relbias_cuda.launches.count
    hr._relbias_fwd(q, q, q, lens, None, ts, torch.zeros(2 * N - 1), torch.zeros(129), kw)
    assert len(calls) == 1 and calls[0][0] == "hstu_mha_relbias_fwd"
    hr._relbias_fwd(q, q, q, lens, None, ts, torch.zeros(2 * 60000 - 1), torch.zeros(129), kw)
    assert len(calls) == 2 and calls[1][0] == "hstu_mha_relbias_fwd"
    assert [c[-2] for c in calls] == [hr.ha._ROUTES["narrow"], hr.ha._ROUTES["read"]]
    monkeypatch.setattr(hr.ha, "_MAX_GRID_X", 1)
    with pytest.raises(ValueError, match="grid"):
        hr._relbias_fwd(q, q, q, lens, None, ts, torch.zeros(2 * N - 1), torch.zeros(129), kw)
    assert len(calls) == 2 and hr.hstu_mha_dense_relbias_cuda.launches.count == before + 2
