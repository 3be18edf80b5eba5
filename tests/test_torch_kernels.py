"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test skips without a CUDA card. This file imports no
JAX, so on a machine without JAX it runs with the repo's conftest left out:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Float32 with TF32 off; kernel and plain version differ only in summation
order and the exp of silu, so atol = rtol = 1e-5 of outputs of order 1e-2.
The backward kernels are held to the plain backward the same way; K2's dq
sums arrive in a different order on every run (atomics), K3 + K4 give the
same bits every run. The relative-bias pair K6 / K7 likewise; K7's two table
gradients sum up to B * H * N^2 / 2 float32 terms per entry, in an order that
changes from run to run, and are held to 2e-5 of each table gradient's
largest entry. K5 cuts the key range into 64-column chunks across blocks and
adds the chunks' partial sums in chunk order (the same bits every run); K7
works on 64 x 64 tile pairs with groups of 4 (or 2) heads inside a block and
sums dk and dv without atomics: both are also run at the lengths, row counts,
head counts and widths where those tilings end.
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
    both tables by K7; under `torch.use_deterministic_algorithms(True)` the
    backward raises a RuntimeError that names the kernel's wrapper."""
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

    out = hstu_mha_dense_relbias_cuda(*leaves[:3], lengths, ts, *leaves[3:], max_seq_len=N)
    torch.use_deterministic_algorithms(True)
    try:
        with pytest.raises(RuntimeError, match="hstu_mha_relbias_bwd_cuda does not have a deterministic"):
            out.sum().backward()
    finally:
        torch.use_deterministic_algorithms(False)
    assert hstu_mha_relbias_bwd_cuda.launches.count == bwd + 1  # nothing was launched


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
