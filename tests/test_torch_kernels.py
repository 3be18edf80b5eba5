"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test skips without a CUDA card. This file imports no
JAX, so on a machine without JAX it runs with the repo's conftest left out:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Float32 with TF32 off; kernel and plain version differ only in summation
order and the exp of silu, so atol = rtol = 1e-5 of outputs of order 1e-2.
The backward kernels are held to the plain backward the same way; K2's dq
sums arrive in a different order on every run (atomics), K3 + K4 give the
same bits every run, and so do K2's dk and dv. K2 and K4 share a body that
walks 32- or 64-row query tiles over a 64-column key tile, at head widths
padded to 32, 64, 128 or 256: they are also run at the lengths, widths and
contextual rows where that tiling ends, and beside a row of length 0. K3
walks 64-column key tiles (32 at width 256) for a 64-row query tile and is run at the
seams of that tiling too. The relative-bias pair K6 / K7 likewise; K7's two table
gradients sum up to B * H * N^2 / 2 float32 terms per entry, in an order that
changes from run to run, and are held to 2e-5 of each table gradient's
largest entry. K5 cuts the key range into 64-column chunks across blocks and
adds the chunks' partial sums in chunk order (the same bits every run); K7
works on 64 x 64 tile pairs with groups of 4 (or 2) heads inside a block and
sums dk and dv without atomics; K1 and K6 walk 32-column key tiles for query
tiles of 64 or 128 rows and groups of 1 or 2 heads, and sum in a fixed order
(K1: the same bits every run): all four are also run at the lengths, row
counts, head counts and widths where those tilings end. K6 and K7 on
bfloat16 are held to their bfloat16 plain versions within 2^-6 of each
bfloat16 output's largest entry (the same rounding points; a sum taken in
another order now and then rounds to the neighbouring bfloat16); so are K1
and K2 on bfloat16 (K1-bf16, K2-bf16), whose dk and dv are the same bits on
every run. K7-det, the fixed-order relative-bias backward, gives the same
bits in every output on a second run, and is held to 2e-5 of each output's
largest entry in float32 (to 2^-6, the tables to 1e-5, on bfloat16).
"""

import numpy as np
import pytest
import torch

from generative_recommenders_tpu_torch.ops.cuda.hstu_attention import (
    delta_hstu_mha_cuda,
    delta_hstu_mha_plain,
    hstu_mha_bwd_cuda,
    hstu_mha_bwd_plain,
    hstu_mha_dense_cuda,
    hstu_mha_dense_plain,
)
from generative_recommenders_tpu_torch.ops.cuda.hstu_attention_relbias import (
    hstu_mha_dense_relbias_cuda,
    hstu_mha_dense_relbias_plain,
    hstu_mha_relbias_bwd_cuda,
    hstu_mha_relbias_bwd_plain,
)
from generative_recommenders_tpu_torch.ops.hstu_compute import hstu_compute_uqvk

TOL = dict(rtol=1e-5, atol=1e-5)
CASES = [
    dict(),
    dict(num_targets=True),
    dict(max_attn_len=5),
    dict(num_targets=True, contextual_seq_len=3),
    dict(max_attn_len=6, min_full_attn_seq_len=4),
    dict(causal=False),
]
RELBIAS_CASES = [
    dict(),
    dict(num_targets=True),
    dict(max_attn_len=37),
    dict(num_targets=True, max_attn_len=37, min_full_attn_seq_len=16),
    dict(causal=False),
]
TABLE_TOL = 2e-5  # of a table gradient's largest entry
DELTA_CASES = [
    dict(),
    dict(num_targets=True, contextual_seq_len=2),
    dict(num_targets=True, max_attn_len=4, min_full_attn_seq_len=3),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, B, Nq, N, H, D, V, ctx, num_targets, device):
    rng = np.random.default_rng(seed)
    t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    q, k, v = (
        t(rng.standard_normal(shape).astype(np.float32) * 0.5)
        for shape in ((B, Nq, H, D), (B, N, H, D), (B, N, H, V))
    )
    lengths = rng.integers(Nq + ctx + 1 if Nq < N else ctx + 1, N + 1, size=(B,)).astype(np.int32)
    lengths[0] = N
    nt = None
    if num_targets:
        nt = t(np.minimum(rng.integers(0, 4, size=(B,)), lengths - ctx - 1).clip(0).astype(np.int32))
    return q, k, v, t(lengths), nt


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_dense_kernel_matches_plain(cuda, case):
    case = dict(case)
    nt_on = case.pop("num_targets", False)
    q, k, v, lengths, nt = _inputs(0, 3, 70, 70, 2, 32, 32, case.get("contextual_seq_len", 0), nt_on, cuda)
    kw = dict(alpha=0.7, max_seq_len=90, num_targets=nt, **case)
    launches = hstu_mha_dense_cuda.launches.count
    got = hstu_mha_dense_cuda(q, k, v, lengths, **kw)
    assert hstu_mha_dense_cuda.launches.count == launches + 1
    torch.testing.assert_close(got, hstu_mha_dense_plain(q, k, v, lengths, **kw), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("case", DELTA_CASES)
def test_delta_kernel_matches_plain(cuda, case):
    case = dict(case)
    nt_on = case.pop("num_targets", False)
    q, k, v, lengths, nt = _inputs(1, 3, 5, 70, 2, 32, 32, case.get("contextual_seq_len", 0), nt_on, cuda)
    kw = dict(alpha=0.6, norm_len=90, num_targets=nt, **case)
    launches = delta_hstu_mha_cuda.launches.count
    got = delta_hstu_mha_cuda(q, k, v, lengths, **kw)
    assert delta_hstu_mha_cuda.launches.count == launches + 1
    torch.testing.assert_close(got, delta_hstu_mha_plain(q, k, v, lengths, **kw), **TOL)


def _delta_seam(name, device):
    """(q, k, v, lengths, num_targets) of one case at a seam of K5's tiling."""
    rng = np.random.default_rng(11)
    t = lambda *shape: torch.as_tensor(rng.standard_normal(shape).astype(np.float32) * 0.5, device=device)  # noqa: E731
    ints = lambda x: torch.tensor(x, dtype=torch.int32, device=device)  # noqa: E731
    H = 2
    if name == "chunk edges":  # 64-column chunks: one, one full, two, three and a column
        M, D, V, lengths = 5, 32, 32, [63, 64, 65, 127, 128, 129, 200]
    elif name == "empty cache beside a full row":  # length = M: every key is a delta key
        M, D, V, lengths = 5, 32, 32, [5, 200, 6, 64]
    elif name == "M=1":
        M, D, V, lengths = 1, 64, 64, [1, 64, 65, 200]
    elif name == "M=17":  # three row tiles of 8, the last with one row
        M, D, V, lengths = 17, 32, 32, [17, 18, 100, 200]
    elif name == "D=V=40":  # 16-byte loads with a zero-padded tail
        M, D, V, lengths = 5, 40, 40, [5, 64, 129, 200]
    elif name == "D=V=25":  # the scalar path
        M, D, V, lengths = 5, 25, 25, [6, 65, 128, 200]
    else:
        raise ValueError(name)
    B, N = len(lengths), 200
    return t(B, M, H, D), t(B, N, H, D), t(B, N, H, V), ints(lengths), ints([min(M, n - 1) for n in lengths])


@pytest.mark.gpu
@pytest.mark.parametrize(
    "name",
    ["chunk edges", "empty cache beside a full row", "M=1", "M=17", "D=V=40", "D=V=25"],
)
def test_delta_kernel_at_its_seams(cuda, name):
    q, k, v, lengths, nt = _delta_seam(name, cuda)
    kw = dict(alpha=0.6, norm_len=230, num_targets=nt, contextual_seq_len=0)
    poison = torch.full((q.shape[0] * q.shape[1] * 2 * v.shape[3] + 4096,), float("nan"), device=cuda)
    del poison  # an element the kernel fails to write shows as NaN
    got = delta_hstu_mha_cuda(q, k, v, lengths, **kw)
    torch.testing.assert_close(got, delta_hstu_mha_plain(q, k, v, lengths, **kw), **TOL)
    # the chunks' partial sums are added in chunk order: the same bits
    assert torch.equal(got, delta_hstu_mha_cuda(q, k, v, lengths, **kw))


@pytest.mark.gpu
def test_delta_kernel_on_a_strided_q_view(cuda):
    """q as the serving path passes it (a view of the chunk's uvqk projection)
    over contiguous K/V, as M-FALCON's padded cache; and K/V at an offset of
    one float, which takes the scalar loads."""
    B, M, N, H, D, V = 4, 5, 300, 4, 128, 128
    rng = np.random.default_rng(12)
    t = lambda *shape: torch.as_tensor(rng.standard_normal(shape).astype(np.float32) * 0.5, device=cuda)  # noqa: E731
    q = t(B, M, H * (2 * V + 2 * D))[..., 2 * H * V:2 * H * V + H * D].reshape(B, M, H, D)
    assert not q.is_contiguous() and q.stride(-1) == 1
    k, v = t(B, N, H, D), t(B, N, H, V)
    lengths = torch.tensor([300, 129, 64, 5], dtype=torch.int32, device=cuda)
    kw = dict(alpha=0.1, norm_len=400, num_targets=torch.full((B,), M, dtype=torch.int32, device=cuda),
              contextual_seq_len=3)
    want = delta_hstu_mha_plain(q, k, v, lengths, **kw)
    torch.testing.assert_close(delta_hstu_mha_cuda(q, k, v, lengths, **kw), want, **TOL)
    shifted = [torch.cat([x.reshape(-1)[:1], x.reshape(-1)])[1:].reshape(x.shape) for x in (k, v)]
    assert all(x.data_ptr() % 16 == 4 for x in shifted)
    torch.testing.assert_close(delta_hstu_mha_cuda(q, *shifted, lengths, **kw), want, **TOL)


@pytest.mark.gpu
def test_kernels_match_plain_on_uvqk_views(cuda):
    """q, k and v as the serving path passes them: strided views split from
    one [B, N, (2V + 2D) * H] projection."""
    B, N, M, H, D, V, Dm, ctx = 3, 70, 5, 2, 32, 16, 48, 2
    rng = np.random.default_rng(2)
    t = lambda *shape: torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=cuda)  # noqa: E731
    width = (2 * V + 2 * D) * H
    _, q, k, v = hstu_compute_uqvk(
        t(B, N, Dm), torch.ones(Dm, device=cuda), torch.zeros(Dm, device=cuda),
        t(Dm, width) / Dm**0.5, t(width), num_heads=H, attn_dim=D, hidden_dim=V,
    )
    assert not q.is_contiguous() and q.stride(1) == width
    lengths = torch.tensor([N, 40, 9], dtype=torch.int32, device=cuda)
    nt = torch.tensor([5, 3, 1], dtype=torch.int32, device=cuda)
    kw = dict(alpha=0.7, max_seq_len=90, num_targets=nt, contextual_seq_len=ctx)
    torch.testing.assert_close(
        hstu_mha_dense_cuda(q, k, v, lengths, **kw), hstu_mha_dense_plain(q, k, v, lengths, **kw), **TOL
    )
    kw = dict(alpha=0.7, norm_len=90, num_targets=torch.full_like(nt, M), contextual_seq_len=ctx)
    dq = q[:, :M]
    torch.testing.assert_close(
        delta_hstu_mha_cuda(dq, k, v, lengths, **kw), delta_hstu_mha_plain(dq, k, v, lengths, **kw), **TOL
    )


def _dense_seam(name, device):
    """(q, k, v, lengths, kw) of one case at a seam of K1's tiling."""
    rng = np.random.default_rng(14)
    t = lambda *shape: torch.as_tensor(rng.standard_normal(shape).astype(np.float32) * 0.5, device=device)  # noqa: E731
    ints = lambda x: torch.tensor(x, dtype=torch.int32, device=device)  # noqa: E731
    edges = [31, 32, 33, 63, 64, 65, 127, 128, 129]  # 32-column key tiles, 64- and 128-row query tiles
    H, D, V, lengths, kw = 4, 128, 128, edges, {}
    if name == "D=V=32, H=3":  # groups of 2 heads: H=3 leaves one unfilled
        H, D, V = 3, 32, 32
    elif name == "D=V=64, H=3":
        H, D, V = 3, 64, 64
    elif name == "D=V=25":  # scalar loads, a padded tail
        D = V = 25
    elif name == "D=256, V=128":
        D = 256
    elif name == "targets and contextual rows":  # contextual rows walk every key tile
        kw = dict(contextual_seq_len=3, num_targets=ints([min(5, n - 4) for n in edges]))
    elif name == "window":
        kw = dict(max_attn_len=40, min_full_attn_seq_len=8, num_targets=ints([3] * len(edges)))
    elif name != "tile edges":
        raise ValueError(name)
    B, N = len(lengths), 140
    kw = dict(alpha=D**-0.5, max_seq_len=N + 9, **kw)
    return t(B, N, H, D), t(B, N, H, D), t(B, N, H, V), ints(lengths), kw


@pytest.mark.gpu
@pytest.mark.parametrize(
    "name", ["tile edges", "D=V=32, H=3", "D=V=64, H=3", "D=V=25", "D=256, V=128", "targets and contextual rows", "window"]
)
def test_dense_kernel_at_its_seams(cuda, name):
    q, k, v, lengths, kw = _dense_seam(name, cuda)
    poison = torch.full((q.shape[0] * q.shape[1] * q.shape[2] * v.shape[3] + 4096,), float("nan"), device=cuda)
    del poison  # an element the kernel fails to write shows as NaN
    got = hstu_mha_dense_cuda(q, k, v, lengths, **kw)
    torch.testing.assert_close(got, hstu_mha_dense_plain(q, k, v, lengths, **kw), **TOL)
    dead = torch.arange(q.shape[1], device=cuda)[None, :] >= lengths[:, None]
    assert (got[dead] == 0).all()
    # no atomics, the key tiles summed in a fixed order: the same bits
    assert torch.equal(got, hstu_mha_dense_cuda(q, k, v, lengths, **kw))


def _bwd_counts():
    """The launch counts of K2, K3 and K4."""
    c = hstu_mha_bwd_cuda.launches
    return [c[n].count for n in ("hstu_mha_bwd_fused", "hstu_mha_bwd_dq", "hstu_mha_bwd_dkv")]


def _bwd_kernels(q, k, v, lengths, do, kw):
    """(K2's (dq, dk, dv), K3 + K4's), each launch counted once."""
    before = _bwd_counts()
    fused = hstu_mha_bwd_cuda(q, k, v, lengths, do, **kw)
    split = hstu_mha_bwd_cuda(q, k, v, lengths, do, split=True, **kw)
    assert [n - b for n, b in zip(_bwd_counts(), before)] == [1, 1, 1]
    return fused, split


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_backward_kernels_match_plain(cuda, case):
    case = dict(case)
    nt_on = case.pop("num_targets", False)
    q, k, v, lengths, nt = _inputs(3, 3, 70, 70, 2, 32, 32, case.get("contextual_seq_len", 0), nt_on, cuda)
    do = torch.randn(3, 70, 2, 64, device=cuda)[..., ::2]  # strided, as from a reshape
    kw = dict(alpha=0.7, max_seq_len=90, num_targets=nt, **case)
    want = hstu_mha_bwd_plain(q, k, v, lengths, do, **kw)
    for grads in _bwd_kernels(q, k, v, lengths, do, kw):
        for g, w in zip(grads, want):
            torch.testing.assert_close(g, w, **TOL)


@pytest.mark.gpu
def test_backward_kernels_match_plain_on_uvqk_views(cuda):
    """q, k and v split from one uvqk projection, as the STU passes them;
    D = 40 takes the kernels' zero-padded head width."""
    B, N, H, D, V, Dm, ctx = 3, 70, 2, 40, 16, 48, 2
    rng = np.random.default_rng(4)
    t = lambda *shape: torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=cuda)  # noqa: E731
    width = (2 * V + 2 * D) * H
    _, q, k, v = hstu_compute_uqvk(
        t(B, N, Dm), torch.ones(Dm, device=cuda), torch.zeros(Dm, device=cuda),
        t(Dm, width) / Dm**0.5, t(width), num_heads=H, attn_dim=D, hidden_dim=V,
    )
    lengths = torch.tensor([N, 40, 9], dtype=torch.int32, device=cuda)
    kw = dict(alpha=0.7, max_seq_len=90, contextual_seq_len=ctx,
              num_targets=torch.tensor([5, 3, 1], dtype=torch.int32, device=cuda))
    do = t(B, N, H, V)
    want = hstu_mha_bwd_plain(q, k, v, lengths, do, **kw)
    fused, split = _bwd_kernels(q, k, v, lengths, do, kw)
    for grads in (fused, split):
        for g, w in zip(grads, want):
            torch.testing.assert_close(g, w, **TOL)
    # the split pair is deterministic
    again = _bwd_kernels(q, k, v, lengths, do, kw)[1]
    assert all(torch.equal(a, b) for a, b in zip(split, again))


def _bwd_seam(name, device):
    """(q, k, v, lengths, kw) of one case at a seam of K2's and K4's tiling:
    64-column key tiles, query tiles of 32 rows (widths 128 and 256) or 64
    rows (widths 32 and 64)."""
    rng = np.random.default_rng(15)
    t = lambda *shape: torch.as_tensor(rng.standard_normal(shape).astype(np.float32) * 0.5, device=device)  # noqa: E731
    ints = lambda x: torch.tensor(x, dtype=torch.int32, device=device)  # noqa: E731
    edges = [31, 32, 33, 63, 64, 65, 127, 128, 129]
    H, D, V, lengths, kw = 2, 128, 128, edges, {}
    if name == "D=200, V=96":  # width 256, V padded to 128
        D, V = 200, 96
    elif name == "D=256, V=128":
        D = 256
    elif name == "D=V=64":
        D = V = 64
    elif name == "D=V=25":  # scalar loads, a padded tail; scalar dq atomics
        D = V = 25
    elif name == "a row of length 0 beside live rows":
        lengths = [0, 140, 0, 65, 1]
    elif name == "contextual rows past a query tile":  # the walk visits the contextual tiles, then the diagonal
        kw = dict(contextual_seq_len=40, num_targets=ints([min(5, n - 41) if n > 41 else 0 for n in edges]))
    elif name == "window and targets":
        kw = dict(max_attn_len=40, min_full_attn_seq_len=8, num_targets=ints([3] * len(edges)))
    elif name != "tile edges":
        raise ValueError(name)
    B, N = len(lengths), 140
    kw = dict(alpha=D**-0.5, max_seq_len=N + 9, **kw)
    return t(B, N, H, D), t(B, N, H, D), t(B, N, H, V), ints(lengths), kw


@pytest.mark.gpu
@pytest.mark.parametrize("name", [
    "tile edges", "D=200, V=96", "D=256, V=128", "D=V=64", "D=V=25", "a row of length 0 beside live rows",
    "contextual rows past a query tile", "window and targets",
])
def test_backward_kernels_at_their_seams(cuda, name):
    q, k, v, lengths, kw = _bwd_seam(name, cuda)
    do = torch.randn(q.shape[1], q.shape[0], q.shape[2], v.shape[3], device=cuda).transpose(0, 1)
    want = hstu_mha_bwd_plain(q, k, v, lengths, do, **kw)
    dead = torch.arange(q.shape[1], device=cuda)[None, :] >= lengths[:, None]
    poison = torch.full((3 * q.numel() + 4096,), float("nan"), device=cuda)
    del poison  # an element a kernel fails to write shows as NaN
    fused, split = _bwd_kernels(q, k, v, lengths, do, kw)
    for grads in (fused, split):
        for g, w in zip(grads, want):
            torch.testing.assert_close(g, w, **TOL)
            assert (g[dead] == 0).all()
    # dk and dv without atomics, the walk in a fixed order: the same bits;
    # K3's dq too
    again = _bwd_kernels(q, k, v, lengths, do, kw)
    for grads, second in zip((fused, split), again):
        assert torch.equal(grads[1], second[1]) and torch.equal(grads[2], second[2])
    assert torch.equal(split[0], again[1][0])


def _dq_seam(name, device):
    """(q, k, v, lengths, kw) of one case at a seam of K3's tiling: query
    tiles of 64 rows, key tiles of 64 columns (32 at width 256)."""
    rng = np.random.default_rng(16)
    t = lambda *shape: torch.as_tensor(rng.standard_normal(shape).astype(np.float32) * 0.5, device=device)  # noqa: E731
    ints = lambda x: torch.tensor(x, dtype=torch.int32, device=device)  # noqa: E731
    edges = [63, 64, 65, 95, 96, 97, 127, 128, 129, 191, 192, 193]
    targets = ints([3, 0, 5, 1, 2, 9, 4, 0, 7, 3, 6, 1])
    H, D, V, lengths, kw, views = 2, 128, 128, edges, dict(num_targets=targets, contextual_seq_len=2), False
    if name == "tile edges on uvqk views":
        views = True
    elif name == "window with full-attention rows":
        kw = dict(kw, max_attn_len=40, min_full_attn_seq_len=24)
    elif name == "contextual rows past a query tile":  # the tile of rows 64 .. 127 holds contextual rows
        lengths, kw = [200, 71, 129], dict(contextual_seq_len=70, num_targets=ints([3, 0, 2]))
    elif name == "D=200, V=96":  # width 256, V padded to 128
        D, V = 200, 96
    elif name == "D=V=32":  # width 32
        D = V = 32
    elif name == "D=V=25":  # scalar loads, a padded tail
        D = V = 25
    elif name == "a row of length 0 beside live rows":
        lengths, kw = [0, 200, 0, 65, 1], {}
    elif name == "non-causal":
        kw = dict(causal=False)
    else:
        raise ValueError(name)
    B, N = len(lengths), 200
    if views:
        Dm, width = 48, (2 * V + 2 * D) * H
        _, q, k, v = hstu_compute_uqvk(
            t(B, N, Dm), torch.ones(Dm, device=device), torch.zeros(Dm, device=device),
            t(Dm, width) / Dm**0.5, t(width), num_heads=H, attn_dim=D, hidden_dim=V,
        )
    else:
        q, k, v = t(B, N, H, D), t(B, N, H, D), t(B, N, H, V)
    return q, k, v, ints(lengths), dict(alpha=D**-0.5, max_seq_len=N + 9, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("name", [
    "tile edges on uvqk views", "window with full-attention rows", "contextual rows past a query tile",
    "D=200, V=96", "D=V=32", "D=V=25", "a row of length 0 beside live rows", "non-causal",
])
def test_dq_kernel_at_its_seams(cuda, name):
    """The split pair K3 + K4 against the plain backward where K3's tiling
    ends; every element of dq written (zeros past the length), and the same
    bits on a second run."""
    q, k, v, lengths, kw = _dq_seam(name, cuda)
    do = torch.randn(q.shape[1], q.shape[0], q.shape[2], v.shape[3], device=cuda).transpose(0, 1)
    want = hstu_mha_bwd_plain(q, k, v, lengths, do, **kw)
    dead = torch.arange(q.shape[1], device=cuda)[None, :] >= lengths[:, None]
    poison = torch.full((3 * q.numel() + 4096,), float("nan"), device=cuda)
    del poison  # an element a kernel fails to write shows as NaN
    before = _bwd_counts()
    got = hstu_mha_bwd_cuda(q, k, v, lengths, do, split=True, **kw)
    again = hstu_mha_bwd_cuda(q, k, v, lengths, do, split=True, **kw)
    assert [n - b for n, b in zip(_bwd_counts(), before)] == [0, 2, 2]
    for g, w, g2 in zip(got, want, again):
        torch.testing.assert_close(g, w, **TOL)
        assert (g[dead] == 0).all()
        assert torch.equal(g, g2)


@pytest.mark.gpu
@pytest.mark.parametrize("deterministic", [False, True])
def test_attention_is_differentiable_on_the_card(cuda, deterministic):
    """Autograd through `hstu_mha_dense_cuda` reaches q, k and v by K2, or
    by K3 then K4 under `torch.use_deterministic_algorithms`."""
    q, k, v, lengths, nt = _inputs(5, 2, 50, 50, 2, 32, 32, 2, True, cuda)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    kw = dict(alpha=0.5, max_seq_len=60, num_targets=nt, contextual_seq_len=2)
    before = _bwd_counts()
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic)
    try:
        hstu_mha_dense_cuda(*leaves, lengths, **kw).square().sum().backward()
    finally:
        torch.use_deterministic_algorithms(prev)
    assert [n - b for n, b in zip(_bwd_counts(), before)] == ([0, 1, 1] if deterministic else [1, 0, 0])
    ref = [x.clone().requires_grad_(True) for x in (q, k, v)]
    hstu_mha_dense_plain(*ref, lengths, **kw).square().sum().backward()
    for leaf, r in zip(leaves, ref):
        assert leaf.grad is not None
        torch.testing.assert_close(leaf.grad, r.grad, **TOL)


@pytest.mark.gpu
def test_empty_batch_counts_no_launch(cuda):
    """A batch of no rows launches no kernel, and no counter moves."""
    q, k, v = (torch.zeros(0, 8, 2, 16, device=cuda) for _ in range(3))
    lengths = torch.zeros(0, dtype=torch.int32, device=cuda)
    fwd, bwd = hstu_mha_dense_cuda.launches.count, _bwd_counts()
    assert hstu_mha_dense_cuda(q, k, v, lengths).shape == (0, 8, 2, 16)
    for split in (False, True):
        assert all(g.shape == (0, 8, 2, 16) for g in hstu_mha_bwd_cuda(q, k, v, lengths, v, split=split))
    assert hstu_mha_dense_cuda.launches.count == fwd and _bwd_counts() == bwd


def _relbias_inputs(seed, B, N, H, D, V, Nm, nb, num_targets, device):
    """q, k, v as views of one projection (as the research STU passes them),
    lengths, timestamps near 1.6e9 with each row's next one past its length
    (where training puts the target's) and zeros after it, and both tables."""
    rng = np.random.default_rng(seed)
    t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    proj = t(rng.standard_normal((B, N, H * (2 * D + V))).astype(np.float32) * 0.5)
    v, q, k = torch.split(proj, [H * V, H * D, H * D], dim=-1)
    q, k, v = q.reshape(B, N, H, D), k.reshape(B, N, H, D), v.reshape(B, N, H, V)
    lengths = rng.integers(1, N, size=(B,)).astype(np.int32)
    lengths[0] = N
    ts = 1_600_000_000 + np.cumsum(rng.integers(1, 90000, size=(B, N)), axis=1)
    ts *= np.arange(N)[None, :] <= lengths[:, None]
    nt = None
    if num_targets:
        nt = t(np.minimum(rng.integers(0, 6, size=(B,)), lengths - 1).clip(0).astype(np.int32))
    pos_w = t((rng.standard_normal(2 * Nm - 1) * 0.05).astype(np.float32))
    ts_w = t((rng.standard_normal(nb + 1) * 0.05).astype(np.float32))
    return q, k, v, t(lengths), t(ts), pos_w, ts_w, nt


@pytest.mark.gpu
@pytest.mark.parametrize("case", RELBIAS_CASES)
@pytest.mark.parametrize("shape", [(3, 211, 2, 32, 32, 211, 128), (2, 100, 2, 25, 25, 120, 40)])
def test_relbias_kernels_match_plain(cuda, case, shape):
    """K6 against the plain forward and K7 against the plain backward, each
    launch counted once; rows >= length exactly 0 in out, dq, dk and dv."""
    case = dict(case)
    B, N, H, D, V, Nm, nb = shape
    nt_on = case.pop("num_targets", False)
    q, k, v, lengths, ts, pos_w, ts_w, nt = _relbias_inputs(7, B, N, H, D, V, Nm, nb, nt_on, cuda)
    kw = dict(alpha=0.8, max_seq_len=N, num_buckets=nb, num_targets=nt, **case)
    fwd, bwd = hstu_mha_dense_relbias_cuda.launches.count, hstu_mha_relbias_bwd_cuda.launches.count
    got = hstu_mha_dense_relbias_cuda(q, k, v, lengths, ts, pos_w, ts_w, **kw)
    assert hstu_mha_dense_relbias_cuda.launches.count == fwd + 1
    torch.testing.assert_close(got, hstu_mha_dense_relbias_plain(q, k, v, lengths, ts, pos_w, ts_w, **kw), **TOL)
    dead = torch.arange(N, device=cuda)[None, :] >= lengths[:, None]
    assert (got[dead] == 0).all()

    do = torch.randn(N, B, H, V, device=cuda).transpose(0, 1)  # strided
    grads = hstu_mha_relbias_bwd_cuda(q, k, v, lengths, ts, pos_w, ts_w, do, **kw)
    assert hstu_mha_relbias_bwd_cuda.launches.count == bwd + 1
    want = hstu_mha_relbias_bwd_plain(q, k, v, lengths, ts, pos_w, ts_w, do, **kw)
    for g, w in zip(grads[:3], want[:3]):
        torch.testing.assert_close(g, w, **TOL)
        assert (g[dead] == 0).all()
    for name, g, w in zip(("dpos_w", "dts_w"), grads[3:], want[3:]):
        err = (g - w).abs().max().item() / w.abs().max().item()
        assert err <= TABLE_TOL, f"{name}: {err:.2e} of the gradient's max"


@pytest.mark.gpu
def test_relbias_attention_is_differentiable_on_the_card(cuda):
    """Autograd through `hstu_mha_dense_relbias_cuda` reaches q, k, v and
    both tables by K7; under `torch.use_deterministic_algorithms(True)` by
    K7-det (no raise), the same gradients within the tables' tolerance."""
    B, N, H, D, V, Nm, nb = 2, 70, 2, 32, 32, 80, 128
    q, k, v, lengths, ts, pos_w, ts_w, _ = _relbias_inputs(9, B, N, H, D, V, Nm, nb, False, cuda)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, pos_w, ts_w)]
    fwd, bwd = hstu_mha_dense_relbias_cuda.launches.count, hstu_mha_relbias_bwd_cuda.launches.count
    out = hstu_mha_dense_relbias_cuda(*leaves[:3], lengths, ts, *leaves[3:], max_seq_len=N)
    out.square().sum().backward()
    assert hstu_mha_dense_relbias_cuda.launches.count == fwd + 1
    assert hstu_mha_relbias_bwd_cuda.launches.count == bwd + 1
    ref = [x.clone().requires_grad_(True) for x in (q, k, v, pos_w, ts_w)]
    hstu_mha_dense_relbias_plain(*ref[:3], lengths, ts, *ref[3:], max_seq_len=N).square().sum().backward()
    for leaf, r in zip(leaves, ref):
        assert leaf.grad is not None
        scale = r.grad.abs().max().item()
        assert (leaf.grad - r.grad).abs().max().item() <= TABLE_TOL * scale + 1e-7

    for leaf in leaves:
        leaf.grad = None
    det = hstu_mha_relbias_bwd_cuda.launches_det.count
    out = hstu_mha_dense_relbias_cuda(*leaves[:3], lengths, ts, *leaves[3:], max_seq_len=N)
    torch.use_deterministic_algorithms(True)
    try:
        out.square().sum().backward()
    finally:
        torch.use_deterministic_algorithms(False)
    assert hstu_mha_relbias_bwd_cuda.launches.count == bwd + 1  # K7 not again
    assert hstu_mha_relbias_bwd_cuda.launches_det.count == det + 1
    for leaf, r in zip(leaves, ref):
        scale = r.grad.abs().max().item()
        assert (leaf.grad - r.grad).abs().max().item() <= TABLE_TOL * scale + 1e-7


@pytest.mark.gpu
def test_relbias_empty_batch_counts_no_launch(cuda):
    q, k, v = (torch.zeros(0, 8, 2, 16, device=cuda) for _ in range(3))
    lengths = torch.zeros(0, dtype=torch.int32, device=cuda)
    ts = torch.zeros(0, 8, dtype=torch.int64, device=cuda)
    pos_w, ts_w = torch.zeros(15, device=cuda), torch.zeros(129, device=cuda)
    fwd, bwd = hstu_mha_dense_relbias_cuda.launches.count, hstu_mha_relbias_bwd_cuda.launches.count
    assert hstu_mha_dense_relbias_cuda(q, k, v, lengths, ts, pos_w, ts_w).shape == (0, 8, 2, 16)
    grads = hstu_mha_relbias_bwd_cuda(q, k, v, lengths, ts, pos_w, ts_w, v)
    assert [tuple(g.shape) for g in grads] == [(0, 8, 2, 16)] * 3 + [(15,), (129,)]
    assert all((g == 0).all() for g in grads[3:])
    assert hstu_mha_dense_relbias_cuda.launches.count == fwd
    assert hstu_mha_relbias_bwd_cuda.launches.count == bwd


def _relbias_seam(name, device):
    """One case at a seam of K7's tiling: (inputs of `_relbias_inputs`, kw)."""
    B, N, H, D, V, Nm, nb, lengths, kw, nt_on = 4, 140, 2, 32, 32, 140, 64, None, {}, False
    if name == "tile edges":  # 64 x 64 tile pairs: lengths around one and two tiles
        B, lengths = 6, [63, 64, 65, 127, 128, 129]
    elif name in ("H=1", "H=3", "H=8"):  # groups of 4 heads: H=3 leaves one unfilled, H=8 makes two
        H = int(name[2:])
    elif name == "D=V=25":
        D = V = 25
    elif name == "D=V=50, H=1":  # width 64: groups of 2 heads
        D = V = 50
        H = 1
    elif name == "N > Nm":  # clipped diagonals share one table entry
        Nm = 100
    elif name == "targets and contextual rows":  # the causal skip of tiles is off
        nt_on, kw = True, dict(contextual_seq_len=3)
    elif name == "D=V=64, H=3, forward key tiles":  # K6: groups of 2 heads, 32-column key tiles
        B, H, D, V, lengths = 9, 3, 64, 64, [31, 32, 33, 63, 64, 65, 127, 128, 129]
    else:
        raise ValueError(name)
    q, k, v, lens, ts, pos_w, ts_w, nt = _relbias_inputs(13, B, N, H, D, V, Nm, nb, nt_on, device)
    if lengths is not None:
        lens = torch.tensor(lengths, dtype=torch.int32, device=device)
        ts = ts * (torch.arange(N, device=device)[None, :] <= lens[:, None])
    return (q, k, v, lens, ts, pos_w, ts_w), dict(alpha=0.8, max_seq_len=N, num_buckets=nb, num_targets=nt, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "name",
    ["tile edges", "H=1", "H=3", "H=8", "D=V=25", "D=V=50, H=1", "N > Nm", "targets and contextual rows"],
)
def test_relbias_backward_at_its_seams(cuda, name):
    args, kw = _relbias_seam(name, cuda)
    q, k, v, lengths = args[:4]
    B, N, H, V = *q.shape[:3], v.shape[3]
    do = torch.randn(N, B, H, V, device=cuda).transpose(0, 1)
    poison = torch.full((3 * q.numel() + 4096,), float("nan"), device=cuda)
    del poison
    grads = hstu_mha_relbias_bwd_cuda(*args, do, **kw)
    want = hstu_mha_relbias_bwd_plain(*args, do, **kw)
    dead = torch.arange(N, device=cuda)[None, :] >= lengths[:, None]
    for g, w in zip(grads[:3], want[:3]):
        torch.testing.assert_close(g, w, **TOL)
        assert (g[dead] == 0).all()
    for gname, g, w in zip(("dpos_w", "dts_w"), grads[3:], want[3:]):
        err = (g - w).abs().max().item() / w.abs().max().item()
        assert err <= TABLE_TOL, f"{gname}: {err:.2e} of the gradient's max"
    # dk and dv are summed in registers in a fixed order; only dq and the
    # tables go through atomics
    again = hstu_mha_relbias_bwd_cuda(*args, do, **kw)
    assert torch.equal(grads[1], again[1]) and torch.equal(grads[2], again[2])


@pytest.mark.gpu
def test_relbias_backward_refuses_wide_heads(cuda):
    """Heads wider than 64 raise on the card; nothing falls back."""
    (q, k, v, lengths, ts, pos_w, ts_w), kw = _relbias_seam("H=1", cuda)
    wide = torch.zeros(*q.shape[:3], 72, device=cuda)
    before = hstu_mha_relbias_bwd_cuda.launches.count
    with pytest.raises(ValueError, match="D, V <= 64"):
        hstu_mha_relbias_bwd_cuda(wide, wide, v, lengths, ts, pos_w, ts_w, torch.zeros_like(v), **kw)
    assert hstu_mha_relbias_bwd_cuda.launches.count == before


@pytest.mark.gpu
@pytest.mark.parametrize(
    "name",
    ["tile edges", "H=1", "H=3", "H=8", "D=V=25", "D=V=50, H=1", "N > Nm", "targets and contextual rows",
     "D=V=64, H=3, forward key tiles"],
)
def test_relbias_forward_at_its_seams(cuda, name):
    args, kw = _relbias_seam(name, cuda)
    q, v, lengths = args[0], args[2], args[3]
    poison = torch.full((q.shape[0] * q.shape[1] * q.shape[2] * v.shape[3] + 4096,), float("nan"), device=cuda)
    del poison
    before = hstu_mha_dense_relbias_cuda.launches.count
    got = hstu_mha_dense_relbias_cuda(*args, **kw)
    assert hstu_mha_dense_relbias_cuda.launches.count == before + 1
    torch.testing.assert_close(got, hstu_mha_dense_relbias_plain(*args, **kw), **TOL)
    dead = torch.arange(q.shape[1], device=cuda)[None, :] >= lengths[:, None]
    assert (got[dead] == 0).all()


BF16_TOL = 2.0**-6  # of an output's largest entry: K6 and K7 on bfloat16 against their bfloat16 plain versions


@pytest.mark.gpu
@pytest.mark.parametrize("case", RELBIAS_CASES)
@pytest.mark.parametrize("shape", [(3, 211, 2, 32, 32, 211, 128), (2, 100, 2, 25, 25, 120, 40)])
def test_relbias_bf16_kernels_match_plain(cuda, case, shape):
    """K6 and K7 on bfloat16 q, k, v and dO against their bfloat16 plain
    versions, which round P, dO / norm and dS to bfloat16 where the kernels
    do: out, dq, dk and dv bfloat16 within 2^-6 of their largest entry (a
    sum taken in another order now and then rounds to the neighbouring
    bfloat16), the float32 tables within `TABLE_TOL`; each launch counted
    once as a bfloat16 launch; rows >= length exactly 0."""
    case = dict(case)
    B, N, H, D, V, Nm, nb = shape
    nt_on = case.pop("num_targets", False)
    q, k, v, lengths, ts, pos_w, ts_w, nt = _relbias_inputs(8, B, N, H, D, V, Nm, nb, nt_on, cuda)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    kw = dict(alpha=1.0, max_seq_len=N, num_buckets=nb, num_targets=nt, **case)
    c6, c7 = hstu_mha_dense_relbias_cuda, hstu_mha_relbias_bwd_cuda
    before = (c6.launches.count, c6.launches_bf16.count, c7.launches.count, c7.launches_bf16.count)
    got = c6(q, k, v, lengths, ts, pos_w, ts_w, **kw)
    do = torch.randn(N, B, H, V, device=cuda).to(torch.bfloat16).transpose(0, 1)  # strided
    grads = c7(q, k, v, lengths, ts, pos_w, ts_w, do, **kw)
    after = (c6.launches.count, c6.launches_bf16.count, c7.launches.count, c7.launches_bf16.count)
    assert [a - b for a, b in zip(after, before)] == [0, 1, 0, 1]
    dead = torch.arange(N, device=cuda)[None, :] >= lengths[:, None]
    want = hstu_mha_relbias_bwd_plain(q, k, v, lengths, ts, pos_w, ts_w, do, **kw)
    outs = [(got, hstu_mha_dense_relbias_plain(q, k, v, lengths, ts, pos_w, ts_w, **kw))]
    for name, (g, w) in zip(("out", "dq", "dk", "dv"), outs + list(zip(grads[:3], want[:3]))):
        assert g.dtype == w.dtype == torch.bfloat16, name
        err = (g.float() - w.float()).abs().max().item() / w.float().abs().max().item()
        assert err <= BF16_TOL, f"{name}: {err:.2e} of its max"
        assert (g[dead] == 0).all(), name
    for name, g, w in zip(("dpos_w", "dts_w"), grads[3:], want[3:]):
        assert g.dtype == torch.float32
        err = (g - w).abs().max().item() / w.abs().max().item()
        assert err <= TABLE_TOL, f"{name}: {err:.2e} of the gradient's max"


@pytest.mark.gpu
def test_relbias_bf16_refuses_what_it_does_not_take(cuda):
    """alpha other than 1 (the TPU kernel rounds alpha q to bfloat16), a dO
    of another type than q, and q, k, v of mixed types raise; nothing is
    launched."""
    B, N, H, D, V, Nm, nb = 2, 40, 2, 32, 32, 40, 128
    q, k, v, lengths, ts, pos_w, ts_w, _ = _relbias_inputs(10, B, N, H, D, V, Nm, nb, False, cuda)
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    c6, c7 = hstu_mha_dense_relbias_cuda, hstu_mha_relbias_bwd_cuda
    before = (c6.launches_bf16.count, c7.launches_bf16.count)
    with pytest.raises(ValueError, match="alpha = 1"):
        c6(qb, kb, vb, lengths, ts, pos_w, ts_w, alpha=0.5)
    with pytest.raises(TypeError, match="k must be bfloat16"):
        c6(qb, k, vb, lengths, ts, pos_w, ts_w)
    with pytest.raises(TypeError, match="do must be bfloat16"):
        c7(qb, kb, vb, lengths, ts, pos_w, ts_w, torch.zeros(B, N, H, V, device=cuda))
    assert (c6.launches_bf16.count, c7.launches_bf16.count) == before


# ------------------------------------------------ K1 and K2 on bfloat16
def _bf16_err(got, want):
    """|got - want|'s largest entry as a share of want's (float32 of both)."""
    return (got.float() - want.float()).abs().max().item() / max(want.float().abs().max().item(), 1e-30)


def _bf16_views(seed, B, N, H, D, V, device):
    """q, k, v as bfloat16 views of one bfloat16 uvqk projection, and a
    strided bfloat16 dO."""
    rng = np.random.default_rng(seed)
    proj = torch.as_tensor(rng.standard_normal((B, N, H * (2 * V + 2 * D))).astype(np.float32),
                           device=device).to(torch.bfloat16)
    _, v, q, k = torch.split(proj, [H * V, H * V, H * D, H * D], dim=-1)
    do = torch.as_tensor(rng.standard_normal((N, B, H, V)).astype(np.float32), device=device)
    return (q.reshape(B, N, H, D), k.reshape(B, N, H, D), v.reshape(B, N, H, V),
            do.to(torch.bfloat16).transpose(0, 1))


def _dense_bf16_checks(q, k, v, lengths, do, kw):
    """K1-bf16 and K2-bf16 against their bfloat16 plain versions: each
    launch counted once as a bfloat16 launch (no float32 launch), every
    output bfloat16 within `BF16_TOL` of its largest entry, rows >= length
    exactly 0, dk and dv the same bits on a second run."""
    before = (hstu_mha_dense_cuda.launches.count, hstu_mha_dense_cuda.launches_bf16.count,
              hstu_mha_bwd_cuda.launches_bf16.count, *_bwd_counts())
    got = hstu_mha_dense_cuda(q, k, v, lengths, **kw)
    grads = hstu_mha_bwd_cuda(q, k, v, lengths, do, **kw)
    after = (hstu_mha_dense_cuda.launches.count, hstu_mha_dense_cuda.launches_bf16.count,
             hstu_mha_bwd_cuda.launches_bf16.count, *_bwd_counts())
    assert [a - b for a, b in zip(after, before)] == [0, 1, 1, 0, 0, 0]
    want = [hstu_mha_dense_plain(q, k, v, lengths, **kw), *hstu_mha_bwd_plain(q, k, v, lengths, do, **kw)]
    dead = torch.arange(q.shape[1], device=q.device)[None, :] >= lengths[:, None]
    for name, g, w in zip(("out", "dq", "dk", "dv"), [got, *grads], want):
        assert g.dtype == w.dtype == torch.bfloat16, name
        assert _bf16_err(g, w) <= BF16_TOL, f"{name}: {_bf16_err(g, w):.2e} of its max"
        assert (g[dead] == 0).all(), name
    again = hstu_mha_bwd_cuda(q, k, v, lengths, do, **kw)
    assert torch.equal(grads[1], again[1]) and torch.equal(grads[2], again[2])


@pytest.mark.gpu
@pytest.mark.parametrize("alpha", [1.0, 0.125])
@pytest.mark.parametrize("case", CASES)
def test_dense_bf16_kernels_match_plain(cuda, case, alpha):
    """K1-bf16 and K2-bf16 on bfloat16 views of one projection, at alpha 1
    (the research model's) and 1/8 (alpha q rounded to bfloat16), with each
    mask case; a row of length 0 beside full ones."""
    case = dict(case)
    nt_on = case.pop("num_targets", False)
    B, N, H, D, V = 3, 150, 2, 32, 32
    q, k, v, do = _bf16_views(21, B, N, H, D, V, cuda)
    lengths = torch.tensor([N, 77, 0], dtype=torch.int32, device=cuda)
    nt = torch.tensor([3, 2, 0], dtype=torch.int32, device=cuda) if nt_on else None
    _dense_bf16_checks(q, k, v, lengths, do, dict(alpha=alpha, max_seq_len=N + 7, num_targets=nt, **case))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "name", ["tile edges", "D=V=32, H=3", "D=V=64, H=3", "D=V=25", "D=256, V=128", "targets and contextual rows", "window"]
)
def test_dense_bf16_kernels_at_their_seams(cuda, name):
    """K1-bf16 and K2-bf16 where the forward's and the backward's tilings
    end (the float32 seams' inputs rounded to bfloat16)."""
    q, k, v, lengths, kw = _dense_seam(name, cuda)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    do = torch.randn(q.shape[1], q.shape[0], q.shape[2], v.shape[3], device=cuda).to(torch.bfloat16).transpose(0, 1)
    _dense_bf16_checks(q, k, v, lengths, do, kw)


@pytest.mark.gpu
def test_dense_bf16_attention_is_differentiable_on_the_card(cuda):
    """Autograd through `hstu_mha_dense_cuda` on bfloat16 reaches q, k and v
    by K1-bf16 and K2-bf16; under deterministic algorithms the bfloat16
    backward raises a RuntimeError naming K3/K4-bf16 (nothing launched), or
    with ``warn_only`` warns and takes K2-bf16."""
    B, N, H, D, V = 2, 70, 2, 32, 32
    q, k, v, _ = _bf16_views(22, B, N, H, D, V, cuda)
    lengths = torch.tensor([N, 41], dtype=torch.int32, device=cuda)
    weight = torch.randn(B, N, H, V, device=cuda)

    def grads():
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        (hstu_mha_dense_cuda(*leaves, lengths).float() * weight).sum().backward()
        return [x.grad for x in leaves]

    k2 = hstu_mha_bwd_cuda.launches_bf16.count
    got = grads()
    assert hstu_mha_bwd_cuda.launches_bf16.count == k2 + 1
    want = hstu_mha_bwd_plain(q, k, v, lengths, weight.to(torch.bfloat16))
    for g, w in zip(got, want):
        assert _bf16_err(g, w) <= BF16_TOL
    split = _bwd_counts()
    torch.use_deterministic_algorithms(True)
    try:
        with pytest.raises(RuntimeError, match="K3/K4-bf16"):
            grads()
    finally:
        torch.use_deterministic_algorithms(False)
    assert hstu_mha_bwd_cuda.launches_bf16.count == k2 + 1 and _bwd_counts() == split
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with pytest.warns(UserWarning, match="K3/K4-bf16"):
            grads()
    finally:
        torch.use_deterministic_algorithms(False)
    assert hstu_mha_bwd_cuda.launches_bf16.count == k2 + 2


# ------------------------------------------- K7-det, the fixed-order K7
DET_TOL = 2e-5  # of an output's largest entry, float32
DET_TABLE_TOL_BF16 = 1e-5  # of a table gradient's largest entry, bfloat16 inputs


def _det_checks(args, do, kw, bf16):
    """K7-det against the plain backward, its launch counted once as K7-det
    (float32 or bfloat16) and nothing else; every output, tables included,
    the same bits on a second run; rows >= length exactly 0."""
    c = hstu_mha_relbias_bwd_cuda
    counters = (c.launches, c.launches_bf16, c.launches_det, c.launches_det_bf16)
    before = [x.count for x in counters]
    grads = c(*args, do, deterministic=True, **kw)
    assert [x.count - b for x, b in zip(counters, before)] == ([0, 0, 0, 1] if bf16 else [0, 0, 1, 0])
    again = c(*args, do, deterministic=True, **kw)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    want = hstu_mha_relbias_bwd_plain(*args, do, **kw)
    q, lengths = args[0], args[3]
    dead = torch.arange(q.shape[1], device=q.device)[None, :] >= lengths[:, None]
    for name, g, w in zip(("dq", "dk", "dv", "dpos_w", "dts_w"), grads, want):
        table = name.startswith("dpos") or name.startswith("dts")
        assert g.dtype == w.dtype == (torch.float32 if table or not bf16 else torch.bfloat16), name
        tol = (DET_TABLE_TOL_BF16 if table else BF16_TOL) if bf16 else DET_TOL
        assert _bf16_err(g, w) <= tol, f"{name}: {_bf16_err(g, w):.2e} of its max"
        if not table:
            assert (g[dead] == 0).all(), name


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", RELBIAS_CASES)
@pytest.mark.parametrize("shape", [(3, 211, 2, 32, 32, 211, 128), (2, 100, 2, 25, 25, 120, 40)])
def test_relbias_det_matches_plain(cuda, case, shape, bf16):
    """K7-det (float32; bfloat16 at alpha 1) at the research widths with each
    mask case."""
    case = dict(case)
    B, N, H, D, V, Nm, nb = shape
    nt_on = case.pop("num_targets", False)
    q, k, v, lengths, ts, pos_w, ts_w, nt = _relbias_inputs(23, B, N, H, D, V, Nm, nb, nt_on, cuda)
    if bf16:
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    do = torch.randn(N, B, H, V, device=cuda).to(q.dtype).transpose(0, 1)  # strided
    kw = dict(alpha=1.0 if bf16 else 0.8, max_seq_len=N, num_buckets=nb, num_targets=nt, **case)
    _det_checks((q, k, v, lengths, ts, pos_w, ts_w), do, kw, bf16)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
@pytest.mark.parametrize(
    "name",
    ["tile edges", "H=1", "H=3", "H=8", "D=V=25", "D=V=50, H=1", "N > Nm", "targets and contextual rows"],
)
def test_relbias_det_at_its_seams(cuda, name, bf16):
    """K7-det where K7's tile pairs and head groups and K3's query tiles end,
    and where clipped diagonals share one table entry (N > Nm)."""
    args, kw = _relbias_seam(name, cuda)
    if bf16:
        args = tuple(x.to(torch.bfloat16) for x in args[:3]) + args[3:]
        kw = dict(kw, alpha=1.0)
    q, v = args[0], args[2]
    do = torch.randn(q.shape[1], q.shape[0], q.shape[2], v.shape[3], device=cuda).to(q.dtype).transpose(0, 1)
    _det_checks(args, do, kw, bf16)


@pytest.mark.gpu
def test_relbias_det_plan_matches_the_launch(cuda):
    """`_relbias_det_plan`'s partial buffer is what K7-det writes: at
    ml-1m large's shape, the blocks' rows sum to the table gradients."""
    from generative_recommenders_tpu_torch.ops.cuda import hstu_attention_relbias as hr

    B, N, H, D, V, Nm, nb = 4, 211, 2, 25, 25, 211, 128
    q, k, v, lengths, ts, pos_w, ts_w, _ = _relbias_inputs(24, B, N, H, D, V, Nm, nb, False, cuda)
    plan = hr._relbias_det_plan(D, V, H, B, N, Nm, nb)
    assert plan["partial_shape"] == (4 * 1 * B, 2 * Nm - 1 + nb + 1)
    do = torch.randn(B, N, H, V, device=cuda)
    grads = hstu_mha_relbias_bwd_cuda(q, k, v, lengths, ts, pos_w, ts_w, do, deterministic=True, max_seq_len=N)
    want = hstu_mha_relbias_bwd_plain(q, k, v, lengths, ts, pos_w, ts_w, do, max_seq_len=N)
    for g, w in zip(grads[3:], want[3:]):
        assert _bf16_err(g, w) <= DET_TOL
