"""The PyTorch port's attention against the JAX package: the three mask
functions, the plain version of kernel K1 (dense) against the Pallas
kernel in interpret mode and the XLA spec, and the plain version of kernel
K5 (M-FALCON delta) against the Pallas delta kernel and the XLA delta path,
also at the lengths where the CUDA kernel's 64-column chunks and 8-row tiles
end; and what K5's wrapper computes in Python (its launch plan, the 16-byte
alignment test, the stride check).
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
    q = torch.zeros(1, 4, 1, 8)
    lengths = torch.tensor([4])
    with pytest.raises(NotImplementedError):
        hstu_mha_dense_cuda(q, q, q, lengths, bias=torch.zeros(1, 4, 4))
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
