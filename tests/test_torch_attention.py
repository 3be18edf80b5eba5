"""The PyTorch port's attention against the JAX package: the three mask
functions, the plain version of kernel K1 (dense) against the Pallas
kernel in interpret mode and the XLA spec, and the plain version of kernel
K5 (M-FALCON delta) against the Pallas delta kernel and the XLA delta path,
also at the lengths where the CUDA kernel's 64-column chunks and 8-row tiles
end; K1's plain version at the seams of the CUDA forward's tiling (query tiles
of 64 or 128 rows, key tiles of 32 columns, groups of heads that H does not
fill); and what the wrappers compute in Python (K1's and K6's launch plan,
K2's and K4's launch plan and their 16-byte loads, K5's launch plan, the
16-byte alignment test, the stride check).
Inputs are made with numpy from a seed and fed to both packages; float32
throughout, atol = rtol = 1e-5 (the two differ only in summation order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from generative_recommenders_tpu.ops import attention_mask as jmask
from generative_recommenders_tpu.ops.hstu_compute import delta_hstu_mha as jax_delta_xla
from generative_recommenders_tpu.ops.pallas.hstu_attention import (
    delta_hstu_mha_pallas,
    hstu_mha_dense_pallas,
)
from generative_recommenders_tpu.ops.xla.hstu_attention import hstu_mha_dense as jax_mha_dense
from generative_recommenders_tpu_torch.ops import attention_mask as tmask
from generative_recommenders_tpu_torch.ops.cuda import hstu_attention as ha
from generative_recommenders_tpu_torch.ops.cuda.hstu_attention import (
    delta_hstu_mha_cuda,
    hstu_mha_bwd_cuda,
    hstu_mha_dense_cuda,
)

TOL = dict(rtol=1e-5, atol=1e-5)

# the mask cases of tests/test_pallas_attention.py
CASES = [
    dict(),
    dict(num_targets=True),
    dict(max_attn_len=5),
    dict(num_targets=True, max_attn_len=5),
    dict(num_targets=True, contextual_seq_len=3),
    dict(max_attn_len=6, min_full_attn_seq_len=4),
    dict(causal=False),
]
DELTA_CASES = [
    dict(),
    dict(num_targets=True),
    dict(num_targets=True, contextual_seq_len=2),
    dict(num_targets=True, max_attn_len=4),
    dict(max_attn_len=5, min_full_attn_seq_len=3),
]


def _inputs(seed, B, Nq, N, H, D, V, min_len=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Nq, H, D)).astype(np.float32) * 0.5
    k = rng.standard_normal((B, N, H, D)).astype(np.float32) * 0.5
    v = rng.standard_normal((B, N, H, V)).astype(np.float32) * 0.5
    lengths = rng.integers(min_len, N + 1, size=(B,)).astype(np.int32)
    lengths[0] = N  # one full row
    return q, k, v, lengths


def _targets(case, lengths, ctx, seed=1):
    if not case.pop("num_targets", False):
        return None
    rng = np.random.default_rng(seed)
    return np.minimum(rng.integers(0, 4, size=lengths.shape), lengths - ctx - 1).clip(0).astype(np.int32)


def _opt(x, fn):
    return None if x is None else fn(x)


@pytest.mark.parametrize("case", CASES)
def test_masks_match_jax(case):
    case = dict(case)
    N, B, M = 19, 4, 3
    ctx = case.get("contextual_seq_len", 0)
    rng = np.random.default_rng(5)
    lengths = rng.integers(max(M, ctx + 1), N + 1, size=(B,)).astype(np.int32)
    nt = _targets(case, lengths, ctx)
    want = jmask.make_valid_attn_mask(N, jnp.asarray(lengths), num_targets=_opt(nt, jnp.asarray), **case)
    got = tmask.make_valid_attn_mask(N, torch.as_tensor(lengths), num_targets=_opt(nt, torch.as_tensor), **case)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tmask.apply_padding_guard(got, torch.as_tensor(lengths)).numpy(),
        np.asarray(jmask.apply_padding_guard(want, jnp.asarray(lengths))),
    )
    rows = lengths[:, None] - M + np.arange(M)[None, :]
    want_d = jmask.make_delta_attn_mask(
        N, jnp.asarray(lengths), jnp.asarray(rows), num_targets=_opt(nt, jnp.asarray), **case
    )
    got_d = tmask.make_delta_attn_mask(
        N, torch.as_tensor(lengths), torch.as_tensor(rows), num_targets=_opt(nt, torch.as_tensor), **case
    )
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


@pytest.mark.parametrize("case", CASES)
def test_dense_plain_matches_pallas_and_xla(case):
    """K1's plain version, through the wrapper on CPU tensors, at an unaligned
    N and a normaliser other than N; rows >= length must be exactly 0."""
    case = dict(case)
    B, N, H, D, V = 3, 27, 2, 8, 8
    ctx = case.get("contextual_seq_len", 0)
    q, k, v, lengths = _inputs(0, B, N, N, H, D, V, min_len=ctx + 1)
    nt = _targets(case, lengths, ctx)
    kw = dict(alpha=0.7, max_seq_len=40, **case)
    got = hstu_mha_dense_cuda(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), torch.as_tensor(lengths),
        num_targets=_opt(nt, torch.as_tensor), **kw,
    ).numpy()
    want_pallas = hstu_mha_dense_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        num_targets=_opt(nt, jnp.asarray), block_q=8, block_k=8, interpret=True, **kw,
    )
    np.testing.assert_allclose(got, np.asarray(want_pallas), **TOL)
    mask = jmask.apply_padding_guard(
        jmask.make_valid_attn_mask(
            N, jnp.asarray(lengths), num_targets=_opt(nt, jnp.asarray), **case
        ),
        jnp.asarray(lengths),
    )
    want_xla = jax_mha_dense(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), alpha=0.7, max_seq_len=40, mask=mask
    )
    np.testing.assert_allclose(got, np.asarray(want_xla), **TOL)
    for b in range(B):
        assert (got[b, lengths[b]:] == 0).all()


@pytest.mark.parametrize("case", DELTA_CASES)
def test_delta_plain_matches_pallas_and_xla(case):
    """K5's plain version, through the wrapper on CPU tensors: the M newest
    queries of each row against the cache + delta K/V."""
    case = dict(case)
    B, M, N, H, D, V = 3, 3, 21, 2, 8, 8
    ctx = case.get("contextual_seq_len", 0)
    q, k, v, lengths = _inputs(2, B, M, N, H, D, V, min_len=M + ctx + 1)
    nt = _targets(case, lengths, ctx)
    kw = dict(alpha=0.6, norm_len=33, **case)
    got = delta_hstu_mha_cuda(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), torch.as_tensor(lengths),
        num_targets=_opt(nt, torch.as_tensor), **kw,
    ).numpy()
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths))
    want_pallas = delta_hstu_mha_pallas(
        *args, num_targets=_opt(nt, jnp.asarray), block_k=8, interpret=True, **kw
    )
    np.testing.assert_allclose(got, np.asarray(want_pallas), **TOL)
    if "min_full_attn_seq_len" not in case:  # the XLA delta path has no such band
        want_xla = jax_delta_xla(*args, num_targets=_opt(nt, jnp.asarray), kernel="xla", **kw)
        np.testing.assert_allclose(got, np.asarray(want_xla), **TOL)


def test_wrappers_reject_what_the_kernels_do_not_take():
    """The additive bias's forward runs (K1-bias's plain version here) and
    its gradient raises NotImplementedError, the forward-only path of the
    JAX package; meta tensors, neither CPU nor CUDA, raise."""
    q = torch.ones(1, 4, 1, 8, requires_grad=True)
    lengths = torch.tensor([4])
    out = hstu_mha_dense_cuda(q, q, q, lengths, bias=torch.zeros(1, 4, 4))
    torch.testing.assert_close(out, hstu_mha_dense_cuda(q, q, q, lengths), rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="forward-only"):
        out.sum().backward()
    q = q.detach()
    meta = q.to("meta")
    with pytest.raises(ValueError):
        hstu_mha_dense_cuda(meta, meta, meta, lengths)
    with pytest.raises(ValueError):
        delta_hstu_mha_cuda(meta, meta, meta, lengths)


# (M, N, lengths): the seams of the CUDA kernel's tiling, 64 key columns and 8
# query rows per block, through the plain version; a row whose cache is empty
# (length = M) beside a full one
DELTA_EDGES = [
    (5, 70, [63, 64, 65, 70]),
    (5, 70, [5, 70, 6, 64]),
    (1, 70, [1, 64, 65, 70]),
    (17, 80, [17, 64, 65, 80]),
    (8, 66, [8, 9, 65, 66]),
]


@pytest.mark.parametrize("M,N,lengths", DELTA_EDGES)
def test_delta_plain_matches_pallas_at_chunk_edges(M, N, lengths):
    B, H, D, V = len(lengths), 2, 8, 8
    q, k, v, _ = _inputs(7, B, M, N, H, D, V)
    lengths = np.asarray(lengths, np.int32)
    nt = np.minimum(M, lengths - 1).astype(np.int32)
    kw = dict(alpha=0.6, norm_len=N + 3)
    got = delta_hstu_mha_cuda(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), torch.as_tensor(lengths),
        num_targets=torch.as_tensor(nt), **kw,
    ).numpy()
    want = delta_hstu_mha_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        num_targets=jnp.asarray(nt), block_k=8, interpret=True, **kw,
    )
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize(
    "shape,chunks,row_tiles,scratch",
    [
        ((32, 5, 523, 4, 128), 9, 1, (9, 32, 5, 4, 128)),  # the serving chunk
        ((32, 160, 678, 4, 128), 11, 20, (11, 32, 160, 4, 128)),
        ((4, 5, 64, 2, 32), 1, 1, None),  # one chunk: no scratch, no counter
        ((4, 5, 65, 2, 32), 2, 1, (2, 4, 5, 2, 32)),
        ((3, 1, 63, 2, 40), 1, 1, None),
        ((3, 17, 200, 2, 25), 4, 3, (4, 3, 17, 2, 25)),
    ],
)
def test_delta_launch_plan(shape, chunks, row_tiles, scratch):
    """K5's grid covers (chunk, head x row tile, batch row); the scratch holds
    one partial output per chunk."""
    B, M, N, H, V = shape
    plan = ha._delta_plan(B, M, N, H, V)
    assert plan["chunks"] == chunks and plan["row_tiles"] == row_tiles
    assert plan["grid"] == (chunks, H * row_tiles, B)
    assert plan["scratch_shape"] == scratch
    assert plan["counters"] == B * H * row_tiles


@pytest.mark.parametrize("shape", [(70000, 5, 100, 1, 8), (2, 8 * 20000, 100, 4, 8)])
def test_delta_launch_plan_rejects_a_grid_beyond_cuda(shape):
    with pytest.raises(ValueError, match="grid"):
        ha._delta_plan(*shape)


@pytest.mark.parametrize(
    "make,want",
    [
        (lambda: torch.zeros(2, 9, 2, 128), True),
        (lambda: torch.zeros(2, 9, 2, 40), True),
        (lambda: torch.zeros(2, 9, 2, 25), False),  # width
        (lambda: torch.zeros(2 * 9 * 2 * 128 + 1)[1:].reshape(2, 9, 2, 128), False),  # pointer
        (lambda: torch.zeros(2, 9, 4 * 128)[..., 128:384].reshape(2, 9, 2, 128), True),  # a uvqk view
        (lambda: torch.zeros(2, 9, 2 * 8 + 2)[..., 2:].reshape(2, 9, 2, 8), False),  # row stride 18
    ],
)
def test_vector_loads_need_16_byte_alignment(make, want):
    t = make()
    assert t.stride(-1) == 1
    assert ha._vec16(t) is want


def test_kernels_refuse_a_strided_last_dim():
    t = torch.zeros(1, 4, 1, 16)[..., ::2]
    with pytest.raises(ValueError, match="contiguous in its last dim"):
        ha._check("delta_q", t, 4, t.device)


# the CUDA forward's seams: key tiles of 32 columns, query tiles of 64 or 128
# rows, heads in groups of 2 at widths up to 64
FWD_EDGES = [31, 32, 33, 63, 64, 65, 127, 128, 129]


@pytest.mark.parametrize("H,case", [(1, dict()), (3, dict(num_targets=True, contextual_seq_len=2))])
def test_dense_plain_matches_pallas_at_tile_edges(H, case):
    case = dict(case)
    B, N, D, V = len(FWD_EDGES), 130, 8, 8
    ctx = case.get("contextual_seq_len", 0)
    q, k, v, _ = _inputs(8, B, N, N, H, D, V)
    lengths = np.asarray(FWD_EDGES, np.int32)
    nt = _targets(case, lengths, ctx)
    kw = dict(alpha=0.6, max_seq_len=N + 5, **case)
    got = hstu_mha_dense_cuda(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), torch.as_tensor(lengths),
        num_targets=_opt(nt, torch.as_tensor), **kw,
    ).numpy()
    want = hstu_mha_dense_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        num_targets=_opt(nt, jnp.asarray), block_q=64, block_k=64, interpret=True, **kw,
    )
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    for b in range(B):
        assert (got[b, lengths[b]:] == 0).all()


# padded width -> (query rows, heads per block, key columns per tile), as
# csrc/hstu_attention_fwd.cuh's `Tiling`
FWD_TILING = {32: (128, 2, 32), 64: (128, 2, 32), 128: (64, 1, 32), 256: (64, 1, 16)}


@pytest.mark.parametrize("H", [1, 3, 4, 8])
@pytest.mark.parametrize("D", [25, 32, 40, 50, 64, 128, 256])
def test_forward_launch_plan(D, H):
    """K1's launch at every width and head count the kernel phase uses: D
    and V padded to the next of 32, 64, 128 (256 for D, V at most 128);
    Q of the head group at a pitch of W + 8 and two stages of a K and a V
    tile; one block per (query tile, head group, batch row)."""
    V = min(D, 128)
    B, N = 3, 674
    plan = ha._fwd_plan(D, V, H, 0, 0, False, B, N)
    width = next(w for w in (32, 64, 128, 256) if D <= w)
    rows, group, key_tile = FWD_TILING[width]
    vw = min(width, 128)
    assert plan["width"] == width and plan["query_rows"] == rows
    assert plan["head_group"] == group and plan["head_groups"] == -(-H // group)
    assert plan["key_tile"] == key_tile
    assert plan["shared_bytes"] == 4 * (group * rows * (width + 8) + 2 * key_tile * (width + 8 + vw + 4))
    assert plan["shared_bytes"] <= 232448
    assert plan["grid"] == (-(-N // rows) * -(-H // group) * B,)


def test_forward_launch_plan_takes_the_wider_of_d_and_v():
    assert ha._fwd_plan(16, 100, 2, 0, 0, False)["width"] == 128
    assert ha._fwd_plan(200, 16, 2, 0, 0, False)["width"] == 256


@pytest.mark.parametrize("args,match", [((0, 32), "at least 1"), ((32, 0), "at least 1")])
def test_forward_launch_plan_raises(args, match):
    """A width of 0 is the one width the kernels refuse."""
    with pytest.raises(ValueError, match=match):
        ha._fwd_plan(*args, 2, 0, 0, False)


@pytest.mark.parametrize("D,V", [(257, 32), (32, 129), (256, 129), (512, 320)])
def test_forward_launch_plan_admits_wide_heads(D, V):
    """D above 256 or V above 128 take a wide body: in float32 at D up to 256
    (V 129 to 256; D up to 128 to V 384) the tile forward, one block per
    (64-row query tile, head, batch row), 32-key steps, its block's shared
    memory `_tile_bytes`; else the wide body on thread block clusters: 64
    query rows, 32-key steps, a cluster of `_wide_fwd_cluster` blocks per
    (query tile, head, batch row), each block's shared memory
    `_wide_fwd_bytes` of its columns."""
    B, H, N = 3, 2, 674
    plan = ha._fwd_plan(D, V, H, 0, 0, False, B, N)
    if D <= 256 and V <= 256:
        assert plan["route"] == "wide_tile" and (plan["query_rows"], plan["key_tile"]) == (64, 32)
        assert plan["shared_bytes"] == ha._tile_bytes(D, V) <= 232448
        assert plan["grid"] == (-(-N // 64) * H * B,)
        return
    assert plan["route"] == "wide" and plan["d_chunks"] == -(-D // 128) and plan["v_chunks"] == -(-V // 128)
    cs, dw, vw, md, mv = ha._wide_fwd_cluster(D, V)
    assert (plan["query_rows"], plan["key_tile"], plan["cluster"]) == (64, 32, cs)
    assert plan["shared_bytes"] == ha._wide_fwd_bytes(dw, vw, md, mv, 4, cs >= 4) <= 232448
    assert plan["grid"] == (-(-N // 64) * H * B * cs,)


def test_dense_launch_goes_by_the_plan(monkeypatch):
    """`_dense_fwd` checks the plan before it launches: a grid beyond CUDA's
    raises and launches nothing."""
    calls = []
    monkeypatch.setattr(ha, "_launch", lambda *a: calls.append(a))
    monkeypatch.setattr(ha, "_stream", lambda device: 0)
    q = torch.zeros(2, 70, 3, 32)
    lens = torch.tensor([70, 9], dtype=torch.int32)
    kw = dict(alpha=1.0, max_seq_len=None, causal=True, max_attn_len=0, contextual_seq_len=0,
              min_full_attn_seq_len=0)
    counter = hstu_mha_dense_cuda.launches["hstu_mha_fwd"]
    before = counter.count
    assert ha._dense_fwd(q, q, q, lens, None, kw).shape == (2, 70, 3, 32)
    assert len(calls) == 1 and calls[0][0] == "hstu_mha_fwd"
    assert counter.count == before + 1
    monkeypatch.setattr(ha, "_MAX_GRID_X", 2)
    with pytest.raises(ValueError, match="grid"):
        ha._dense_fwd(q, q, q, lens, None, kw)
    assert len(calls) == 1 and counter.count == before + 1


# padded width -> (query rows, key columns, shared bytes), as
# csrc/hstu_attention_bwd_dkv.cuh's `Tiling` and `smem_bytes`
BWD_TILING = {32: (64, 64, 98352), 64: (64, 64, 147504), 128: (32, 64, 157736), 256: (32, 64, 223272)}


@pytest.mark.parametrize("H", [1, 3, 4])
@pytest.mark.parametrize("D,V", [(25, 25), (32, 32), (40, 16), (64, 64), (16, 100), (128, 128), (200, 96), (256, 128)])
def test_backward_launch_plan(D, V, H):
    """K2's and K4's launch at the widths the kernel phase uses: D and V
    padded to the next of 32, 64, 128 (256 for D, V at most 128); K and V of
    a 64-column key tile, two stages of Q and dO and the tile pair's P and dS
    in the block's shared memory; one block per (key tile, head, batch row)."""
    B, N = 32, 1036
    plan = ha._bwd_plan(D, V, H, B, N)
    width = next(w for w in (32, 64, 128, 256) if max(D, V) <= w)
    rows, cols, shared = BWD_TILING[width]
    assert plan["width"] == width and plan["query_rows"] == rows and plan["key_cols"] == cols
    assert plan["head_group"] == 1
    assert plan["shared_bytes"] == shared <= 232448
    assert plan["grid"] == (-(-N // cols) * H * B,)


@pytest.mark.parametrize("args,match", [((0, 32), "at least 1"), ((32, 0), "at least 1")])
def test_backward_launch_plan_raises(args, match):
    with pytest.raises(ValueError, match=match):
        ha._bwd_plan(*args, 4, 32, 268)


@pytest.mark.parametrize("D,V", [(257, 32), (32, 129), (256, 256), (320, 136)])
def test_backward_launch_plan_admits_wide_heads(D, V):
    """D above 256 or V above 128 take the wide dkv pass (K2 with its dQ): a
    cluster per (64-column key tile, head, batch row) of one block per
    chunk, D's then V's; each block 64 resident rows of one chunk, two
    stages of 32 streamed rows, two exchange buffers and the A tile."""
    B, H, N = 32, 4, 268
    plan = ha._bwd_plan(D, V, H, B, N)
    chunks = -(-D // 128) + -(-V // 128)
    assert plan["route"] == "wide" and plan["grid"] == (-(-N // 64) * H * B * chunks,)
    assert plan["cluster"] == chunks and plan["chunks_per_block"] == 1
    assert plan["d_blocks"] == -(-D // 128) and plan["v_blocks"] == -(-V // 128)
    assert plan["shared_bytes"] == 4 * (64 * 136 + 2 * 32 * 136 + 64 * 40 + 2 * 64 * 40 + 8) <= 232448
    assert plan["dq"]["grid"] == plan["grid"]


# padded width -> (query rows, key columns, shared bytes), as
# csrc/hstu_attention_bwd_dq.cuh's `Tiling` and `smem_bytes`
DQ_TILING = {32: (64, 64, 79888), 64: (64, 64, 129040), 128: (64, 64, 227344), 256: (64, 32, 215056)}


@pytest.mark.parametrize("H", [1, 3, 4])
@pytest.mark.parametrize("D,V", [(25, 25), (32, 32), (40, 16), (64, 64), (16, 100), (128, 128), (200, 96), (256, 128)])
def test_dq_launch_plan(D, V, H):
    """K3's launch at the widths the kernel phase uses: D and V padded to the
    next of 32, 64, 128 (256 for D, V at most 128); Q and dO of a 64-row
    query tile, two stages of K and V and the tile pair's dS in the block's
    shared memory; one block per (query tile, head, batch row)."""
    B, N = 32, 1036
    plan = ha._dq_plan(D, V, H, B, N)
    width = next(w for w in (32, 64, 128, 256) if max(D, V) <= w)
    rows, cols, shared = DQ_TILING[width]
    assert plan["width"] == width and plan["query_rows"] == rows and plan["key_cols"] == cols
    assert plan["head_group"] == 1
    assert plan["shared_bytes"] == shared <= 232448
    assert plan["grid"] == (-(-N // rows) * H * B,)


@pytest.mark.parametrize("args,match", [((0, 32), "at least 1"), ((32, 0), "at least 1")])
def test_dq_launch_plan_raises(args, match):
    with pytest.raises(ValueError, match=match):
        ha._dq_plan(*args, 4, 32, 1036)


@pytest.mark.parametrize("D,V", [(257, 32), (32, 129), (256, 256), (1024, 8)])
def test_dq_launch_plan_admits_wide_heads(D, V):
    """D above 256 or V above 128 take the wide dq pass: a cluster per
    (64-row query tile, head, batch row), one block per chunk of D and V of
    128, or per two chunks past a portable cluster's 8 blocks (D 1024: 8 + 1
    chunks in 4 + 1 blocks)."""
    B, H, N = 32, 4, 1036
    plan = ha._dq_plan(D, V, H, B, N)
    m = 1 if -(-D // 128) + -(-V // 128) <= 8 else 2
    cluster = -(-D // (128 * m)) + -(-V // (128 * m))
    assert plan["route"] == "wide" and plan["grid"] == (-(-N // 64) * H * B * cluster,)
    assert plan["cluster"] == cluster and plan["chunks_per_block"] == m
    assert plan["shared_bytes"] == 4 * (m * 64 * 136 + 2 * m * 32 * 136 + 64 * 40 + 2 * 64 * 40 + 8) <= 232448


_C_TYPES = {"const float*": ha._P, "float*": ha._P, "const int*": ha._P, "int*": ha._P, "void*": ha._P, "int": ha._I,
            "long long": ha._L, "float": ha._F, "const __nv_bfloat16*": ha._P, "__nv_bfloat16*": ha._P,
            "const void*": ha._P}  # K1-bias's bias: float32 or bfloat16


@pytest.mark.parametrize("name", sorted(ha._ARGTYPES))
def test_argtypes_follow_the_c_signatures(name):
    """Each kernel's ctypes argument list has the types of its `extern "C"`
    entry point, parameter by parameter (the backward kernels' ends with
    the four `vec_*` flags before the route; every one but K5's and
    K5-bf16's with the route and the stream), in the source of its library (a bfloat16 entry
    point lives in its float32 kernel's): a pointer or an int out of place
    would be cut or misread without an error."""
    import os
    import re

    from generative_recommenders_tpu_torch.ops.cuda import build

    with open(os.path.join(build.CSRC_DIR, build.KERNEL_SOURCES[ha._LIBRARY.get(name, name)])) as f:
        src = f.read()
    params = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", src, re.S).group(1)
    types = [re.sub(r"\s+", " ", p.strip()).rsplit(" ", 1)[0] for p in params.split(",")]
    assert [_C_TYPES[t] for t in types] == ha._ARGTYPES[name]
    names = [p.split()[-1] for p in params.split(",")]
    if name.startswith("hstu_mha_bwd"):
        assert names[-6:-2] == ["vec_q", "vec_k", "vec_v", "vec_do"]
    if not name.startswith("delta_hstu_mha_fwd"):
        assert names[-2:] == ["route", "stream"]


def _uvqk_views(B, N, H, D, V, seed=0):
    """q, k, v as the STU passes them: views of one [B, N, (2V + 2D) H]
    projection (port `ops/hstu_compute.py`)."""
    from generative_recommenders_tpu_torch.ops.hstu_compute import hstu_compute_uqvk

    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.as_tensor(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    Dm, width = 16, (2 * V + 2 * D) * H
    _, q, k, v = hstu_compute_uqvk(t(B, N, Dm), torch.ones(Dm), torch.zeros(Dm), t(Dm, width), t(width),
                                   num_heads=H, attn_dim=D, hidden_dim=V)
    assert not q.is_contiguous() and q.stride(1) == width
    return q, k, v


def _shifted(x):
    """``x``'s values at a pointer one float past a 16-byte boundary."""
    return torch.cat([x.reshape(-1)[:1], x.reshape(-1)])[1:].reshape(x.shape)


@pytest.mark.parametrize("layout,want", [
    ("uvqk views, D = V = 128", (1, 1, 1, 1)),
    ("uvqk views, D = V = 25", (0, 0, 0, 0)),
    ("contiguous, D = V = 32", (1, 1, 1, 1)),
    ("contiguous at an odd float, D = V = 32", (0, 0, 0, 1)),
])
def test_backward_launch_decides_vector_loads(monkeypatch, layout, want):
    """K2, K3 and K4 take the `vec_*` flags of q, k, v and dO (16-byte loads
    where the pointer, the strides and the width allow them). Each call
    passes as many arguments as its C signature has, the last two its
    plan's route and the stream."""
    calls = []
    monkeypatch.setattr(ha, "_launch", lambda *a: calls.append(a))
    monkeypatch.setattr(ha, "_stream", lambda device: 0)
    B, N, H = 2, 40, 2
    if layout.startswith("uvqk"):
        D = 128 if "128" in layout else 25
        q, k, v = _uvqk_views(B, N, H, D, D)
    else:
        D = 32
        q, k, v = (torch.zeros(B, N, H, D) for _ in range(3))
        if "odd" in layout:
            q, k, v = (_shifted(x) for x in (q, k, v))
            assert all(x.data_ptr() % 16 == 4 for x in (q, k, v))
    do = torch.zeros(N, B, H, D).transpose(0, 1)
    lens = torch.tensor([N, 9], dtype=torch.int32)
    kw = dict(alpha=1.0, max_seq_len=None, causal=True, max_attn_len=0, contextual_seq_len=0,
              min_full_attn_seq_len=0)
    for name in ("hstu_mha_bwd_fused", "hstu_mha_bwd_dkv", "hstu_mha_bwd_dq"):
        before = hstu_mha_bwd_cuda.launches[name].count
        ha._bwd_kernel(name, q, k, v, lens, None, do, kw)
        assert hstu_mha_bwd_cuda.launches[name].count == before + 1
        args = calls[-1]
        assert args[0] == name and len(args) == 1 + len(ha._ARGTYPES[name])
        assert args[-6:-2] == want and args[-2] == ha._ROUTES["narrow"]


def test_backward_launch_goes_by_the_plan(monkeypatch):
    """K2, K3 and K4 check their plans before they launch: a grid beyond
    CUDA's raises and launches nothing."""
    calls = []
    monkeypatch.setattr(ha, "_launch", lambda *a: calls.append(a))
    monkeypatch.setattr(ha, "_stream", lambda device: 0)
    monkeypatch.setattr(ha, "_MAX_GRID_X", 2)
    q = torch.zeros(2, 70, 3, 32)
    lens = torch.tensor([70, 9], dtype=torch.int32)
    kw = dict(alpha=1.0, max_seq_len=None, causal=True, max_attn_len=0, contextual_seq_len=0,
              min_full_attn_seq_len=0)
    for name in ("hstu_mha_bwd_fused", "hstu_mha_bwd_dkv", "hstu_mha_bwd_dq"):
        with pytest.raises(ValueError, match="grid"):
            ha._bwd_kernel(name, q, q, q, lens, None, q, kw)
    assert calls == []
