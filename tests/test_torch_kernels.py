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
every run; so are K3-bf16 and K4-bf16, the split backward on bfloat16,
whose every output is the same bits on a second run. K6-bf16 and K7-bf16
also at alpha 1/8 (alpha q rounded to bfloat16). K7-bf16, K7-det-bf16 and K3-bf16
run bodies of their own on the bfloat16 tensor cores, also held at lengths
on their tile edges and at head groups left unfilled. K7-det, the
fixed-order relative-bias backward, gives the same bits in every output on
a second run, and is held to 2e-5 of each output's largest entry in float32 (to
2^-6, the tables to 1e-5, on bfloat16). K1-bias, K1 with an additive [B, N,
N] bias, is held to its plain version as K1 (float32) and K1-bf16
(bfloat16) are, with a float32 or bfloat16 bias, one per batch row or one
for the batch. The wide backward (heads above the narrow bodies' widths: a
thread block cluster per tile, one block per chunk of 128 columns of D and
V, two past a portable cluster's 8 blocks) is also run at the cluster's
edges (D = V = 512, D 640 / V 512, the V-256 ranker's D 128 / V 256) and
with the relative bias's tables read; its dk and dv, and K7-det's every
output, the same bits on a second run.
"""

import warnings

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
# the wide bodies and the long tables against the plain versions, as a share
# of each output's largest entry: chip_smoke.py's REL_TOL (float32)
WIDE_TOL = 2e-5
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
    launches = hstu_mha_dense_cuda.launches["hstu_mha_fwd"].count
    got = hstu_mha_dense_cuda(q, k, v, lengths, **kw)
    assert hstu_mha_dense_cuda.launches["hstu_mha_fwd"].count == launches + 1
    torch.testing.assert_close(got, hstu_mha_dense_plain(q, k, v, lengths, **kw), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("case", DELTA_CASES)
def test_delta_kernel_matches_plain(cuda, case):
    case = dict(case)
    nt_on = case.pop("num_targets", False)
    q, k, v, lengths, nt = _inputs(1, 3, 5, 70, 2, 32, 32, case.get("contextual_seq_len", 0), nt_on, cuda)
    kw = dict(alpha=0.6, norm_len=90, num_targets=nt, **case)
    launches = delta_hstu_mha_cuda.launches["delta_hstu_mha_fwd"].count
    got = delta_hstu_mha_cuda(q, k, v, lengths, **kw)
    assert delta_hstu_mha_cuda.launches["delta_hstu_mha_fwd"].count == launches + 1
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
@pytest.mark.parametrize("case", DELTA_CASES)
@pytest.mark.parametrize("alpha", [1.0, 0.3])
def test_delta_bf16_kernel_matches_plain(cuda, case, alpha):
    """K5-bf16 against its bfloat16 plain version within 2^-6 of the
    output's largest entry, counted under its own entry point; the same
    bits on a second run. alpha 0.3 is no bfloat16 number: alpha q is
    rounded where the Pallas kernel rounds it."""
    case = dict(case)
    nt_on = case.pop("num_targets", False)
    q, k, v, lengths, nt = _inputs(1, 3, 5, 70, 2, 32, 32, case.get("contextual_seq_len", 0), nt_on, cuda)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    kw = dict(alpha=alpha, norm_len=90, num_targets=nt, **case)
    counters = delta_hstu_mha_cuda.launches
    before = {k_: c.count for k_, c in counters.items()}
    got = delta_hstu_mha_cuda(q, k, v, lengths, **kw)
    assert {k_: c.count - before[k_] for k_, c in counters.items()} == {"delta_hstu_mha_fwd": 0,
                                                                         "delta_hstu_mha_fwd_bf16": 1}
    assert got.dtype == torch.bfloat16
    assert _bf16_err(got, delta_hstu_mha_plain(q, k, v, lengths, **kw)) <= BF16_TOL
    assert torch.equal(got, delta_hstu_mha_cuda(q, k, v, lengths, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "name",
    ["chunk edges", "empty cache beside a full row", "M=1", "M=17", "D=V=40", "D=V=25"],
)
def test_delta_bf16_kernel_at_its_seams(cuda, name):
    """K5-bf16 at the seams of K5's tiling (the 16-byte loads of 8 elements
    where the rows allow them, the scalar path at D = V = 25), and at V
    above 128 and D above 256; the same bits twice."""
    q, k, v, lengths, nt = (x.to(torch.bfloat16) if x.is_floating_point() else x for x in _delta_seam(name, cuda))
    kw = dict(alpha=0.6, norm_len=230, num_targets=nt, contextual_seq_len=0)
    got = delta_hstu_mha_cuda(q, k, v, lengths, **kw)
    assert _bf16_err(got, delta_hstu_mha_plain(q, k, v, lengths, **kw)) <= BF16_TOL
    assert torch.equal(got, delta_hstu_mha_cuda(q, k, v, lengths, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("D,V", [(64, 256), (320, 32)])
def test_delta_bf16_kernel_at_wide_heads(cuda, D, V):
    q, k, v, lengths, nt = _inputs(41, 3, 12, 200, 2, D, V, 1, True, cuda)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    kw = dict(alpha=D**-0.5, norm_len=210, num_targets=nt, contextual_seq_len=1)
    got = delta_hstu_mha_cuda(q, k, v, lengths, **kw)
    assert _bf16_err(got, delta_hstu_mha_plain(q, k, v, lengths, **kw)) <= BF16_TOL
    assert torch.equal(got, delta_hstu_mha_cuda(q, k, v, lengths, **kw))


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
    fwd, bwd = [c.count for c in hstu_mha_dense_cuda.launches.values()], _bwd_counts()
    assert hstu_mha_dense_cuda(q, k, v, lengths).shape == (0, 8, 2, 16)
    for split in (False, True):
        assert all(g.shape == (0, 8, 2, 16) for g in hstu_mha_bwd_cuda(q, k, v, lengths, v, split=split))
    assert [c.count for c in hstu_mha_dense_cuda.launches.values()] == fwd and _bwd_counts() == bwd


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
def test_relbias_backward_takes_wide_heads(cuda):
    """Heads wider than 128 take the wide bodies: one K7
    launch, against the plain backward."""
    (q, k, v, lengths, ts, pos_w, ts_w), kw = _relbias_seam("H=1", cuda)
    wide = torch.randn(*q.shape[:3], 136, device=cuda) * 0.3
    do = torch.randn_like(v)
    before = hstu_mha_relbias_bwd_cuda.launches.count
    grads = hstu_mha_relbias_bwd_cuda(wide, wide, v, lengths, ts, pos_w, ts_w, do, **kw)
    assert hstu_mha_relbias_bwd_cuda.launches.count == before + 1
    want = hstu_mha_relbias_bwd_plain(wide, wide, v, lengths, ts, pos_w, ts_w, do, **kw)
    for name, g, w in zip(("dq", "dk", "dv", "dpos_w", "dts_w"), grads, want):
        assert _bf16_err(g, w) <= WIDE_TOL, f"{name}: {_bf16_err(g, w):.2e} of its max"


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
    """alpha other than 1 is taken (K6-bf16 against its plain version, one
    launch); a dO of another type than q, and q, k, v of mixed types raise,
    and nothing is launched."""
    B, N, H, D, V, Nm, nb = 2, 40, 2, 32, 32, 40, 128
    q, k, v, lengths, ts, pos_w, ts_w, _ = _relbias_inputs(10, B, N, H, D, V, Nm, nb, False, cuda)
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    c6, c7 = hstu_mha_dense_relbias_cuda, hstu_mha_relbias_bwd_cuda
    got = c6(qb, kb, vb, lengths, ts, pos_w, ts_w, alpha=0.5)
    assert _bf16_err(got, hstu_mha_dense_relbias_plain(qb, kb, vb, lengths, ts, pos_w, ts_w, alpha=0.5)) <= BF16_TOL
    before = (c6.launches_bf16.count, c7.launches_bf16.count)
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


def _bf16_bwd_counts():
    """The launch counts of K2-bf16, K3-bf16 and K4-bf16."""
    c = hstu_mha_bwd_cuda.launches
    return [c[n].count for n in ("hstu_mha_bwd_fused_bf16", "hstu_mha_bwd_dq_bf16", "hstu_mha_bwd_dkv_bf16")]


def _dense_bf16_checks(q, k, v, lengths, do, kw):
    """K1-bf16 and K2-bf16, then K3-bf16 + K4-bf16, against their bfloat16
    plain versions: each launch counted once as a bfloat16 launch (no
    float32 launch), every output bfloat16 within `BF16_TOL` of its largest
    entry, rows >= length exactly 0, K2-bf16's dk and dv and every output of
    the split the same bits on a second run."""
    fwd = hstu_mha_dense_cuda.launches
    before = (fwd["hstu_mha_fwd"].count, fwd["hstu_mha_fwd_bf16"].count, *_bf16_bwd_counts(), *_bwd_counts())
    got = hstu_mha_dense_cuda(q, k, v, lengths, **kw)
    grads = hstu_mha_bwd_cuda(q, k, v, lengths, do, **kw)
    split = hstu_mha_bwd_cuda(q, k, v, lengths, do, split=True, **kw)
    after = (fwd["hstu_mha_fwd"].count, fwd["hstu_mha_fwd_bf16"].count, *_bf16_bwd_counts(), *_bwd_counts())
    assert [a - b for a, b in zip(after, before)] == [0, 1, 1, 1, 1, 0, 0, 0]
    want = [hstu_mha_dense_plain(q, k, v, lengths, **kw), *hstu_mha_bwd_plain(q, k, v, lengths, do, **kw)]
    dead = torch.arange(q.shape[1], device=q.device)[None, :] >= lengths[:, None]
    for name, g, w in zip(("out", "dq", "dk", "dv", "split dq", "split dk", "split dv"),
                          [got, *grads, *split], want + want[1:]):
        assert g.dtype == w.dtype == torch.bfloat16, name
        assert _bf16_err(g, w) <= BF16_TOL, f"{name}: {_bf16_err(g, w):.2e} of its max"
        assert (g[dead] == 0).all(), name
    again = hstu_mha_bwd_cuda(q, k, v, lengths, do, **kw)
    assert torch.equal(grads[1], again[1]) and torch.equal(grads[2], again[2])
    again = hstu_mha_bwd_cuda(q, k, v, lengths, do, split=True, **kw)
    assert all(torch.equal(a, b) for a, b in zip(split, again))


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
    by K1-bf16 and K2-bf16; under deterministic algorithms (``warn_only``
    or not, no warning) by K3-bf16 then K4-bf16, the same bits twice."""
    B, N, H, D, V = 2, 70, 2, 32, 32
    q, k, v, _ = _bf16_views(22, B, N, H, D, V, cuda)
    lengths = torch.tensor([N, 41], dtype=torch.int32, device=cuda)
    weight = torch.randn(B, N, H, V, device=cuda)

    def grads():
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        (hstu_mha_dense_cuda(*leaves, lengths).float() * weight).sum().backward()
        return [x.grad for x in leaves]

    k2 = _bf16_bwd_counts()
    got = grads()
    assert [a - b for a, b in zip(_bf16_bwd_counts(), k2)] == [1, 0, 0]
    want = hstu_mha_bwd_plain(q, k, v, lengths, weight.to(torch.bfloat16))
    for g, w in zip(got, want):
        assert _bf16_err(g, w) <= BF16_TOL
    split = _bwd_counts()
    runs = []
    for warn_only in (False, True):
        torch.use_deterministic_algorithms(True, warn_only=warn_only)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                runs.append(grads())
        finally:
            torch.use_deterministic_algorithms(False)
    assert [a - b for a, b in zip(_bf16_bwd_counts(), k2)] == [1, 2, 2] and _bwd_counts() == split
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    for g, w in zip(runs[0], want):
        assert _bf16_err(g, w) <= BF16_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("case", [dict(), dict(causal=False), dict(num_targets=True, contextual_seq_len=3),
                                  dict(max_attn_len=300, min_full_attn_seq_len=40)])
def test_bf16_forward_cuts_long_walks(cuda, case, D):
    """K1-bf16 and K6-bf16 where a walk over the keys spans several chunks of
    the bfloat16 body's plan (N 1300 in chunks of 512: up to three, their
    float32 sums added in chunk order; widths 32 and 64, whose tilings
    differ): within 2^-6 of their plain versions,
    rows >= length exactly 0, the same bits on a second run; K2-bf16 and
    K3-bf16 + K4-bf16 at the same lengths (`_dense_bf16_checks`)."""
    from generative_recommenders_tpu_torch.ops.cuda.hstu_attention import _fwd_plan

    case = dict(case)
    nt_on = case.pop("num_targets", False)
    B, N, H, V = 3, 1300, 3, D
    plan = _fwd_plan(D, V, H, 0, 0, False, B, N, torch.bfloat16)
    assert plan["chunks"] == 3 and plan["scratch_shape"] == (3, B, N, H, V)
    q, k, v, do = _bf16_views(31, B, N, H, D, V, cuda)
    lengths = torch.tensor([N, 1030, 0], dtype=torch.int32, device=cuda)
    nt = torch.tensor([5, 2, 0], dtype=torch.int32, device=cuda) if nt_on else None
    kw = dict(alpha=0.125, max_seq_len=N, num_targets=nt, **case)
    _dense_bf16_checks(q, k, v, lengths, do, kw)
    got = hstu_mha_dense_cuda(q, k, v, lengths, **kw)
    assert torch.equal(got, hstu_mha_dense_cuda(q, k, v, lengths, **kw))
    rng = np.random.default_rng(32)
    ts = torch.as_tensor(1_600_000_000 + np.cumsum(rng.integers(1, 90000, size=(B, N)), axis=1), device=cuda)
    pos_w = torch.as_tensor((rng.standard_normal(2 * N - 1) * 0.05).astype(np.float32), device=cuda)
    ts_w = torch.as_tensor((rng.standard_normal(129) * 0.05).astype(np.float32), device=cuda)
    got = hstu_mha_dense_relbias_cuda(q, k, v, lengths, ts, pos_w, ts_w, **kw)
    assert torch.equal(got, hstu_mha_dense_relbias_cuda(q, k, v, lengths, ts, pos_w, ts_w, **kw))
    want = hstu_mha_dense_relbias_plain(q, k, v, lengths, ts, pos_w, ts_w, **kw)
    assert got.dtype == want.dtype == torch.bfloat16
    assert _bf16_err(got, want) <= BF16_TOL, f"K6-bf16: {_bf16_err(got, want):.2e} of its max"
    dead = torch.arange(N, device=cuda)[None, :] >= lengths[:, None]
    assert (got[dead] == 0).all()


# ------------------------------------------- K7-det, the fixed-order K7
DET_TOL = 2e-5  # of an output's largest entry, float32
DET_TABLE_TOL_BF16 = 1e-5  # of a table gradient's largest entry, bfloat16 inputs


def _det_checks(args, do, kw, bf16):
    """K7-det against the plain backward, its launch counted once as K7-det
    (float32 or bfloat16) and nothing else (no dq pass: K3's counters stand
    still, and the plan has none); every output, tables included, the same
    bits on a second run; rows >= length exactly 0."""
    from generative_recommenders_tpu_torch.ops.cuda import hstu_attention_relbias as hr

    c = hstu_mha_relbias_bwd_cuda
    dq_pass = hstu_mha_bwd_cuda.launches
    counters = (c.launches, c.launches_bf16, c.launches_det, c.launches_det_bf16,
                dq_pass["hstu_mha_bwd_dq"], dq_pass["hstu_mha_bwd_dq_bf16"])
    before = [x.count for x in counters]
    grads = c(*args, do, deterministic=True, **kw)
    assert [x.count - b for x, b in zip(counters, before)] == ([0, 0, 0, 1, 0, 0] if bf16 else [0, 0, 1, 0, 0, 0])
    q, v, pos_w, ts_w = args[0], args[2], args[5], args[6]
    plan = hr._relbias_det_plan(q.shape[3], v.shape[3], q.shape[2], q.shape[0], q.shape[1], (pos_w.shape[0] + 1) // 2,
                                ts_w.shape[0] - 1, kw.get("causal", True), kw.get("contextual_seq_len", 0))
    assert "dq_route" not in plan
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


# ------------------------------------ K6 / K7 on bfloat16 at alpha 1/8 and 0.3
@pytest.mark.gpu
@pytest.mark.parametrize("alpha", [0.125, 0.3])
@pytest.mark.parametrize("deterministic", [False, True], ids=["K7-bf16", "K7-det-bf16"])
@pytest.mark.parametrize("shape", [(3, 211, 2, 32, 32, 211, 128), (2, 100, 2, 25, 25, 120, 40)])
def test_relbias_bf16_kernels_at_alpha(cuda, shape, deterministic, alpha):
    """K6-bf16 and K7-bf16 (or K7-det-bf16) at alpha 1/8 and 0.3 (which
    bfloat16 does not hold exactly), which the kernels form as
    bfloat16(alpha q) on their way into shared memory, against their
    bfloat16 plain versions, which round there too (and which
    `tests/test_torch_bf16.py` holds against the Pallas pair at the same
    alphas); K7-det-bf16's every output the same bits twice."""
    B, N, H, D, V, Nm, nb = shape
    q, k, v, lengths, ts, pos_w, ts_w, nt = _relbias_inputs(25, B, N, H, D, V, Nm, nb, True, cuda)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    kw = dict(alpha=alpha, max_seq_len=N, num_buckets=nb, num_targets=nt)
    got = hstu_mha_dense_relbias_cuda(q, k, v, lengths, ts, pos_w, ts_w, **kw)
    assert _bf16_err(got, hstu_mha_dense_relbias_plain(q, k, v, lengths, ts, pos_w, ts_w, **kw)) <= BF16_TOL
    do = torch.randn(N, B, H, V, device=cuda).to(torch.bfloat16).transpose(0, 1)
    args = (q, k, v, lengths, ts, pos_w, ts_w)
    if deterministic:
        _det_checks(args, do, kw, bf16=True)
        return
    grads = hstu_mha_relbias_bwd_cuda(*args, do, **kw)
    want = hstu_mha_relbias_bwd_plain(*args, do, **kw)
    for name, g, w in zip(("dq", "dk", "dv", "dpos_w", "dts_w"), grads, want):
        table = name in ("dpos_w", "dts_w")
        assert _bf16_err(g, w) <= (TABLE_TOL if table else BF16_TOL), f"{name}: {_bf16_err(g, w):.2e} of its max"


# --------------------------------------------- K3-bf16 + K4-bf16 at the seams
@pytest.mark.gpu
@pytest.mark.parametrize("name", [
    "tile edges on uvqk views", "window with full-attention rows", "contextual rows past a query tile",
    "D=200, V=96", "D=V=32", "D=V=25", "a row of length 0 beside live rows", "non-causal",
])
def test_split_bf16_kernels_at_their_seams(cuda, name):
    """K3-bf16 and K4-bf16 where K3's and K4's tilings end (the float32
    seams' inputs rounded to bfloat16, alpha 1/sqrt(D)) against the
    bfloat16 plain backward, every output the same bits twice."""
    q, k, v, lengths, kw = _dq_seam(name, cuda)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    do = torch.randn(q.shape[1], q.shape[0], q.shape[2], v.shape[3], device=cuda).to(torch.bfloat16).transpose(0, 1)
    before = _bf16_bwd_counts()
    split = hstu_mha_bwd_cuda(q, k, v, lengths, do, split=True, **kw)
    assert [a - b for a, b in zip(_bf16_bwd_counts(), before)] == [0, 1, 1]
    want = hstu_mha_bwd_plain(q, k, v, lengths, do, **kw)
    dead = torch.arange(q.shape[1], device=cuda)[None, :] >= lengths[:, None]
    for g_name, g, w in zip(("dq", "dk", "dv"), split, want):
        assert g.dtype == torch.bfloat16 and _bf16_err(g, w) <= BF16_TOL, f"{g_name}: {_bf16_err(g, w):.2e}"
        assert (g[dead] == 0).all(), g_name
    again = hstu_mha_bwd_cuda(q, k, v, lengths, do, split=True, **kw)
    assert all(torch.equal(a, b) for a, b in zip(split, again))


# ------------------- the bfloat16 bodies of K7, K7-det and K3 at their edges
EDGE_LENGTHS = [15, 16, 17, 63, 64, 65, 127, 128, 129]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["K7-bf16", "K7-det-bf16", "K3-bf16"])
@pytest.mark.parametrize("H,D,V", [(3, 32, 32), (9, 32, 32), (3, 64, 64), (2, 48, 40), (3, 25, 25), (3, 128, 128),
                                   (1, 100, 72)])
def test_bf16_backward_bodies_at_their_edges(cuda, kernel, H, D, V):
    """The bfloat16 bodies of K7, K7-det and K3 at lengths on the edges of
    their 16-row steps and 64-row tiles, with head groups that H leaves
    unfilled (3 and 9 heads against K7's groups of 4 at width 32, 3 and 1
    against its groups of 2 at width 128), at widths 32, 64 and 128, at D 48
    / V 40, D 100 / V 72 and at D = V = 25 (rows read element by
    element), at alpha 0.3 (bfloat16(alpha q) formed by the pre-scaling
    pass), against their bfloat16 plain versions: outputs within
    `BF16_TOL`, the tables within `TABLE_TOL` (K7-det's
    `DET_TABLE_TOL_BF16`), rows past the length exactly 0; K7-bf16's dk and
    dv, every output of K7-det-bf16 and K3-bf16's dq the same bits on a
    second run."""
    B, N = len(EDGE_LENGTHS), 140
    if kernel == "K3-bf16":
        q, k, v, do = _bf16_views(31, B, N, H, D, V, cuda)
        lengths = torch.tensor(EDGE_LENGTHS, dtype=torch.int32, device=cuda)
        kw = dict(alpha=0.3, max_seq_len=N)
        before = _bf16_bwd_counts()
        dq = hstu_mha_bwd_cuda(q, k, v, lengths, do, split=True, **kw)[0]
        assert [a - b for a, b in zip(_bf16_bwd_counts(), before)] == [0, 1, 1]
        want = hstu_mha_bwd_plain(q, k, v, lengths, do, **kw)[0]
        assert dq.dtype == torch.bfloat16 and _bf16_err(dq, want) <= BF16_TOL, f"dq: {_bf16_err(dq, want):.2e}"
        assert (dq[torch.arange(N, device=cuda)[None, :] >= lengths[:, None]] == 0).all()
        assert torch.equal(dq, hstu_mha_bwd_cuda(q, k, v, lengths, do, split=True, **kw)[0])
        return
    q, k, v, _, ts, pos_w, ts_w, _ = _relbias_inputs(32, B, N, H, D, V, N, 128, False, cuda)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    lengths = torch.tensor(EDGE_LENGTHS, dtype=torch.int32, device=cuda)
    args = (q, k, v, lengths, ts, pos_w, ts_w)
    do = torch.randn(N, B, H, V, device=cuda).to(torch.bfloat16).transpose(0, 1)
    kw = dict(alpha=0.3, max_seq_len=N, num_buckets=128)
    if kernel == "K7-det-bf16":
        _det_checks(args, do, kw, bf16=True)
        return
    c = hstu_mha_relbias_bwd_cuda
    before = (c.launches.count, c.launches_bf16.count, c.launches_det_bf16.count)
    grads = c(*args, do, **kw)
    assert [x - b for x, b in zip((c.launches.count, c.launches_bf16.count, c.launches_det_bf16.count), before)] \
        == [0, 1, 0]
    want = hstu_mha_relbias_bwd_plain(*args, do, **kw)
    dead = torch.arange(N, device=cuda)[None, :] >= lengths[:, None]
    for name, g, w in zip(("dq", "dk", "dv", "dpos_w", "dts_w"), grads, want):
        table = name in ("dpos_w", "dts_w")
        assert g.dtype == (torch.float32 if table else torch.bfloat16), name
        assert _bf16_err(g, w) <= (TABLE_TOL if table else BF16_TOL), f"{name}: {_bf16_err(g, w):.2e} of its max"
        if not table:
            assert (g[dead] == 0).all(), name
    again = c(*args, do, **kw)
    assert torch.equal(grads[1], again[1]) and torch.equal(grads[2], again[2])


# ----------------------------------------------------------------- K1-bias
def _bias_checks(q, k, v, lengths, bias, kw):
    """K1-bias against its plain version: one launch on its entry point's
    counter and none on K1's, the output of q's type within TOL (float32) or
    `BF16_TOL` (bfloat16), rows >= length exactly 0, the same bits twice."""
    bf16 = q.dtype == torch.bfloat16
    c = hstu_mha_dense_cuda.launches
    counters = [c[n] for n in ("hstu_mha_fwd", "hstu_mha_fwd_bf16", "hstu_mha_fwd_bias", "hstu_mha_fwd_bias_bf16")]
    before = [x.count for x in counters]
    got = hstu_mha_dense_cuda(q, k, v, lengths, bias=bias, **kw)
    assert [x.count - b for x, b in zip(counters, before)] == [0, 0, int(not bf16), int(bf16)]
    want = hstu_mha_dense_plain(q, k, v, lengths, bias=bias, **kw)
    assert got.dtype == want.dtype == q.dtype
    if bf16:
        assert _bf16_err(got, want) <= BF16_TOL, f"{_bf16_err(got, want):.2e} of its max"
    else:
        torch.testing.assert_close(got, want, **TOL)
    dead = torch.arange(q.shape[1], device=q.device)[None, :] >= lengths[:, None]
    assert (got[dead] == 0).all()
    assert torch.equal(got, hstu_mha_dense_cuda(q, k, v, lengths, bias=bias, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("bias_type", ["float32", "bfloat16"])
@pytest.mark.parametrize("qkv_type", ["float32", "bfloat16"])
@pytest.mark.parametrize("broadcast", [False, True], ids=["bias [B, N, N]", "bias [1, N, N]"])
@pytest.mark.parametrize("case", CASES)
def test_dense_bias_kernel_matches_plain(cuda, case, broadcast, qkv_type, bias_type):
    """K1-bias with each mask case at N = 70 (not a tile multiple), on views
    of one projection."""
    case = dict(case)
    nt_on = case.pop("num_targets", False)
    q, k, v, lengths, nt = _inputs(30, 3, 70, 70, 2, 32, 32, case.get("contextual_seq_len", 0), nt_on, cuda)
    if qkv_type == "bfloat16":
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    bias = torch.randn(1 if broadcast else 3, 70, 70, device=cuda).to(getattr(torch, bias_type))
    _bias_checks(q, k, v, lengths, bias, dict(alpha=0.7, max_seq_len=90, num_targets=nt, **case))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "name", ["tile edges", "D=V=32, H=3", "D=V=64, H=3", "D=V=25", "D=256, V=128", "targets and contextual rows", "window"]
)
def test_dense_bias_kernel_at_its_seams(cuda, name):
    """K1-bias where K1's tiling ends, with a bias whose rows lie at an odd
    pitch (element pairs read one by one) and with a contiguous one."""
    q, k, v, lengths, kw = _dense_seam(name, cuda)
    B, N = q.shape[:2]
    _bias_checks(q, k, v, lengths, torch.randn(B, N, N + 1, device=cuda)[..., :N], kw)
    _bias_checks(q, k, v, lengths, torch.randn(B, N, N, device=cuda), kw)


# ------------------------------------------------- every width, every table
# Heads wider than the narrow bodies take (D above 256 or V above 128; D or V
# above 64 in the relative-bias backward) run on the wide bodies
# (csrc/hstu_attention_wide.cuh); position tables too long to stage beside
# the tiles, and more buckets than fit, are read from device memory. Each is
# held to its plain version: float32 within WIDE_TOL of each output's largest
# entry, bfloat16 within BF16_TOL (tables: TABLE_TOL with atomics, the same
# bits twice under K7-det).
WIDE_SHAPES = [(32, 136), (64, 192), (128, 256), (32, 320), (264, 32), (320, 64), (512, 136)]


def _wide_views(seed, B, N, H, D, V, dtype, device):
    """q, k, v as views of one projection, a strided dO, lengths with a
    short row, num_targets; alpha 1 / sqrt(D) keeps S of order 1."""
    rng = np.random.default_rng(seed)
    proj = torch.as_tensor(rng.standard_normal((B, N, H * (2 * D + V))).astype(np.float32),
                           device=device).to(dtype)
    v, q, k = torch.split(proj, [H * V, H * D, H * D], dim=-1)
    do = torch.as_tensor(rng.standard_normal((N, B, H, V)).astype(np.float32), device=device).to(dtype)
    lengths = rng.integers(1, N, size=(B,)).astype(np.int32)
    lengths[0] = N
    nt = np.minimum(rng.integers(0, 4, size=(B,)), lengths - 2).clip(0).astype(np.int32)
    return (q.reshape(B, N, H, D), k.reshape(B, N, H, D), v.reshape(B, N, H, V), do.transpose(0, 1),
            torch.as_tensor(lengths, device=device), torch.as_tensor(nt, device=device))


def _held(name, got, want, bf16, tol=WIDE_TOL):
    err = _bf16_err(got, want)
    assert err <= (BF16_TOL if bf16 else tol), f"{name}: {err:.2e} of its max"


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("D,V", WIDE_SHAPES)
def test_dense_kernels_at_wide_heads(cuda, D, V, bf16):
    """K1, K1-bias, K2 and K3 + K4 (float32 or bfloat16) at widths their own
    tilings do not take, with targets and a contextual row, on views of one
    projection; each launch counted once, K3 + K4 the same bits twice."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    q, k, v, do, lengths, nt = _wide_views(40, 2, 150, 2, D, V, dtype, cuda)
    kw = dict(alpha=D**-0.5, max_seq_len=160, num_targets=nt, contextual_seq_len=1)
    sfx = "_bf16" if bf16 else ""
    fwd, bwd = hstu_mha_dense_cuda.launches, hstu_mha_bwd_cuda.launches
    before = [fwd["hstu_mha_fwd" + sfx].count, fwd["hstu_mha_fwd_bias" + sfx].count,
              bwd["hstu_mha_bwd_fused" + sfx].count, bwd["hstu_mha_bwd_dq" + sfx].count,
              bwd["hstu_mha_bwd_dkv" + sfx].count]
    out = hstu_mha_dense_cuda(q, k, v, lengths, **kw)
    bias = torch.randn(2, 150, 150, device=cuda) * 0.3
    biased = hstu_mha_dense_cuda(q, k, v, lengths, bias=bias, **kw)
    fused = hstu_mha_bwd_cuda(q, k, v, lengths, do, **kw)
    split = hstu_mha_bwd_cuda(q, k, v, lengths, do, split=True, **kw)
    after = [fwd["hstu_mha_fwd" + sfx].count, fwd["hstu_mha_fwd_bias" + sfx].count,
             bwd["hstu_mha_bwd_fused" + sfx].count, bwd["hstu_mha_bwd_dq" + sfx].count,
             bwd["hstu_mha_bwd_dkv" + sfx].count]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 1, 1]
    _held("out", out, hstu_mha_dense_plain(q, k, v, lengths, **kw), bf16)
    _held("biased out", biased, hstu_mha_dense_plain(q, k, v, lengths, bias=bias, **kw), bf16)
    want = hstu_mha_bwd_plain(q, k, v, lengths, do, **kw)
    dead = torch.arange(150, device=cuda)[None, :] >= lengths[:, None]
    for kind, grads in (("K2", fused), ("K3 + K4", split)):
        for name, g, w in zip(("dq", "dk", "dv"), grads, want):
            assert g.dtype == dtype and g.shape == w.shape
            _held(f"{kind} {name}", g, w, bf16)
            assert (g[dead] == 0).all()
    again = hstu_mha_bwd_cuda(q, k, v, lengths, do, split=True, **kw)
    assert all(torch.equal(a, b) for a, b in zip(split, again))


@pytest.mark.gpu
@pytest.mark.parametrize("D,V", [(32, 136), (64, 256), (264, 32), (320, 200), (1024, 8)])
def test_delta_kernel_at_wide_heads(cuda, D, V):
    """K5 at V above 128 (V in chunks of 128 across the grid) and D above 256
    (q read in chunks), over several key chunks and row tiles."""
    q, k, v, lengths, nt = _inputs(41, 3, 12, 200, 2, D, V, 1, True, cuda)
    kw = dict(alpha=D**-0.5, norm_len=210, num_targets=nt, contextual_seq_len=1)
    before = delta_hstu_mha_cuda.launches["delta_hstu_mha_fwd"].count
    got = delta_hstu_mha_cuda(q, k, v, lengths, **kw)
    assert delta_hstu_mha_cuda.launches["delta_hstu_mha_fwd"].count == before + 1
    _held("out", got, delta_hstu_mha_plain(q, k, v, lengths, **kw), False)
    assert torch.equal(got, delta_hstu_mha_cuda(q, k, v, lengths, **kw))


def _relbias_all(args, do, kw, bf16):
    """K6, K7 and K7-det against their plain versions: each launch counted
    once, on the route its plan chose, the tables within TABLE_TOL (K7-det:
    DET_TOL, the same bits twice)."""
    from generative_recommenders_tpu_torch.ops.cuda import hstu_attention_relbias as hr

    c6, c7 = hstu_mha_dense_relbias_cuda, hstu_mha_relbias_bwd_cuda
    counters = (c6.launches_bf16 if bf16 else c6.launches, c7.launches_bf16 if bf16 else c7.launches)
    before = [(x.count, x.routes) for x in counters]
    out = c6(*args, **kw)
    grads = c7(*args, do, **kw)
    assert [x.count - b for x, (b, _) in zip(counters, before)] == [1, 1]
    (B, N, H, D), V = args[0].shape, args[2].shape[3]
    Nm, NB = (args[5].shape[0] + 1) // 2, args[6].shape[0] - 1
    routes = [hr.ha._fwd_plan(D, V, H, Nm, NB, True, B, N, args[0].dtype)["route"],
              hr._relbias_bwd_plan(D, V, H, Nm, NB, args[0].dtype, B, N)["route"]]
    assert [[r for r, n in x.routes.items() if n != b.get(r, 0)] for x, (_, b) in zip(counters, before)] == [
        [r] for r in routes]
    _held("out", out, hstu_mha_dense_relbias_plain(*args, **kw), bf16)
    want = hstu_mha_relbias_bwd_plain(*args, do, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        _held(name, g, w, bf16)
    for name, g, w in zip(("dpos_w", "dts_w"), grads[3:], want[3:]):
        _held(name, g, w, False, TABLE_TOL)
    _det_checks(args, do, kw, bf16)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("D,V", [(128, 128), (72, 32), (256, 256), (320, 136)])
def test_relbias_kernels_at_wide_heads(cuda, D, V, bf16):
    """K6 (its own tiling up to D 256 / V 128, the wide body above) and K7 /
    K7-det (one pass up to 128, the wide bodies above) at the heads of a d
    256 model split over 2 heads and wider."""
    q, k, v, lengths, ts, pos_w, ts_w, nt = _relbias_inputs(42, 2, 150, 2, D, V, 160, 128, True, cuda)
    if bf16:
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    do = torch.randn(150, 2, 2, V, device=cuda).to(q.dtype).transpose(0, 1)
    kw = dict(alpha=1.0 if bf16 else D**-0.5, max_seq_len=150, num_buckets=128, num_targets=nt)
    _relbias_all((q, k, v, lengths, ts, pos_w, ts_w), do, kw, bf16)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
@pytest.mark.parametrize(
    "H,D,N,Nm,nb",
    [(2, 32, 300, 2848, 128), (2, 64, 200, 1312, 128), (2, 64, 200, 500, 1024), (2, 32, 300, 22000, 128),
     (2, 64, 260, 22000, 200), (8, 32, 4096, 4096, 128), (8, 64, 700, 2048, 128), (2, 64, 200, 8000, 1024)],
    ids=["width 32, Nm 2848", "width 64, Nm 1312", "1024 buckets", "width 32, Nm 22000", "width 64, Nm 22000",
         "H 8, width 32, N = Nm = 4096", "H 8, width 64, Nm 2048", "1024 buckets, Nm 8000"],
)
def test_relbias_kernels_with_long_tables(cuda, H, D, N, Nm, nb, bf16):
    """Tables that do not fit beside the tiles: K7 and K7-det
    read them and flush each step's window of dpos_w; at Nm 22000 K6
    reads them too. On bfloat16, whose tiles take half the bytes, K7 and
    K7-det stage the tables up to Nm 2848, 2048 and 4096 and with 1024
    buckets at Nm 500, and read them at Nm 8000 and beyond (each launch
    on the route its plan chose for its type). Short batches against a long table, as
    a model with a long maximum length trains; the 1024-bucket case puts
    gaps past float32's range on some rows (bucket NB) and gaps near it. At
    H 8 K7's groups of 4 (width 32) and 2 (width 64) heads are full, as in
    the long-history model (H 8, N = Nm = 4096, width 32)."""
    q, k, v, lengths, ts, pos_w, ts_w, nt = _relbias_inputs(43, 3, N, H, D, D, Nm, nb, False, cuda)
    if nb > 295:
        ts = ts.to(torch.float32)
        ts[1, ::7] = 3e38
        ts[1, 3::7] = -3e38
    if bf16:
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    do = torch.randn(N, 3, H, D, device=cuda).to(q.dtype).transpose(0, 1)
    kw = dict(alpha=1.0 if bf16 else 0.5, max_seq_len=N, num_buckets=nb, num_targets=None)
    _relbias_all((q, k, v, lengths, ts, pos_w, ts_w), do, kw, bf16)


# ------------------------------- the wide backward at its clusters' edges
# (D, V): 8 chunks, the most a portable cluster holds at one chunk a block;
# 9 chunks, past it (5 blocks of two chunks); the V-256 ranker's layer
CLUSTER_SHAPES = [(512, 512), (640, 512), (128, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("D,V", CLUSTER_SHAPES)
def test_wide_backward_at_the_cluster_edges(cuda, D, V, bf16):
    """K2 and K3 + K4 (float32 or bfloat16) on the wide backward's clusters
    at the portable cluster's edge, past it and at the V-256 ranker's
    layer, with targets and a contextual row: every output within
    `WIDE_TOL` (bfloat16 `BF16_TOL`) of the plain backward, zeros past the
    lengths; K2's dk and dv and every output of K3 + K4 the same bits on a
    second run; each launch on the route ``wide``."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    q, k, v, do, lengths, nt = _wide_views(46, 2, 150, 2, D, V, dtype, cuda)
    kw = dict(alpha=D**-0.5, max_seq_len=160, num_targets=nt, contextual_seq_len=1)
    sfx = "_bf16" if bf16 else ""
    counter = hstu_mha_bwd_cuda.launches["hstu_mha_bwd_fused" + sfx]
    before = counter.routes.get("wide", 0)
    fused = hstu_mha_bwd_cuda(q, k, v, lengths, do, **kw)
    assert counter.routes.get("wide", 0) == before + 1
    split = hstu_mha_bwd_cuda(q, k, v, lengths, do, split=True, **kw)
    want = hstu_mha_bwd_plain(q, k, v, lengths, do, **kw)
    dead = torch.arange(150, device=cuda)[None, :] >= lengths[:, None]
    for kind, grads in (("K2", fused), ("K3 + K4", split)):
        for name, g, w in zip(("dq", "dk", "dv"), grads, want):
            assert g.dtype == dtype and g.shape == w.shape
            _held(f"{kind} {name}", g, w, bf16)
            assert (g[dead] == 0).all()
    again = hstu_mha_bwd_cuda(q, k, v, lengths, do, **kw)
    assert torch.equal(fused[1], again[1]) and torch.equal(fused[2], again[2])
    again = hstu_mha_bwd_cuda(q, k, v, lengths, do, split=True, **kw)
    assert all(torch.equal(a, b) for a, b in zip(split, again))


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("D,V,Nm", [(256, 256, 8000), (136, 512, 300), (640, 512, 160)])
def test_wide_relbias_backward_on_clusters(cuda, D, V, Nm, bf16):
    """K7 and K7-det on the wide backward's clusters, the tables read from
    device memory (Nm 8000: more than a narrow block stages), at widths
    that take one chunk a block and past a portable cluster: outputs and
    tables against the plain backward (`_relbias_all`: K7-det's outputs the
    same bits twice), K7's dk and dv the same bits twice."""
    q, k, v, lengths, ts, pos_w, ts_w, nt = _relbias_inputs(47, 3, 150, 2, D, V, Nm, 128, True, cuda)
    if bf16:
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    do = torch.randn(150, 3, 2, V, device=cuda).to(q.dtype).transpose(0, 1)
    kw = dict(alpha=1.0 if bf16 else D**-0.5, max_seq_len=150, num_buckets=128, num_targets=nt)
    args = (q, k, v, lengths, ts, pos_w, ts_w)
    _relbias_all(args, do, kw, bf16)
    grads = hstu_mha_relbias_bwd_cuda(*args, do, **kw)
    again = hstu_mha_relbias_bwd_cuda(*args, do, **kw)
    assert torch.equal(grads[1], again[1]) and torch.equal(grads[2], again[2])


# --------------------- the wide forward on clusters; the widest backward
# (D, V): a cluster of 2 (D split in halves of 64), 4 (V's chunk in slices
# of 32), 9 (split per-element work), and 16 blocks of 2 D tiles or of 2 V
# tiles; D not a multiple of 8 (bfloat16 element loads)
FWD_CLUSTER_SHAPES = [(128, 256), (512, 64), (1100, 700), (3968, 128), (2048, 2049), (36, 300)]


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("D,V", FWD_CLUSTER_SHAPES)
def test_wide_forward_on_clusters(cuda, D, V, bf16):
    """K1, K1-bias and K6 (float32 or bfloat16) on the wide forward's clusters
    (route ``wide``; K1 in float32 where the tile forward takes the widths
    on it, ``wide_tile``), with targets and a contextual row on views
    of one projection: within `WIDE_TOL` (bfloat16 `BF16_TOL`) of their
    plain versions, zeros past the lengths, the same bits on a second run."""
    from generative_recommenders_tpu_torch.ops.cuda import hstu_attention as ha

    dtype = torch.bfloat16 if bf16 else torch.float32
    q, k, v, _, lengths, nt = _wide_views(48, 2, 150, 2, D, V, dtype, cuda)
    kw = dict(alpha=D**-0.5, max_seq_len=160, num_targets=nt, contextual_seq_len=1)
    counter = hstu_mha_dense_cuda.launches["hstu_mha_fwd" + ("_bf16" if bf16 else "")]
    route = "wide_tile" if ha._fwd_tile(D, V, False, dtype) else "wide"
    assert ha._fwd_plan(D, V, 2, 0, 0, False, 2, 150, dtype)["route"] == route
    before = counter.routes.get(route, 0)
    out = hstu_mha_dense_cuda(q, k, v, lengths, **kw)
    assert counter.routes.get(route, 0) == before + 1
    _held("out", out, hstu_mha_dense_plain(q, k, v, lengths, **kw), bf16)
    dead = torch.arange(150, device=cuda)[None, :] >= lengths[:, None]
    assert (out[dead] == 0).all()
    assert torch.equal(out, hstu_mha_dense_cuda(q, k, v, lengths, **kw))
    bias = torch.randn(2, 150, 150, device=cuda) * 0.3
    _held("biased out", hstu_mha_dense_cuda(q, k, v, lengths, bias=bias, **kw),
          hstu_mha_dense_plain(q, k, v, lengths, bias=bias, **kw), bf16)
    rq, rk, rv, rl, ts, pos_w, ts_w, rnt = _relbias_inputs(49, 2, 150, 2, D, V, 150, 128, True, cuda)
    rq, rk, rv = (x.to(dtype) for x in (rq, rk, rv))
    rkw = dict(alpha=1.0 if bf16 else D**-0.5, max_seq_len=150, num_buckets=128, num_targets=rnt)
    _held("K6 out", hstu_mha_dense_relbias_cuda(rq, rk, rv, rl, ts, pos_w, ts_w, **rkw),
          hstu_mha_dense_relbias_plain(rq, rk, rv, rl, ts, pos_w, ts_w, **rkw), bf16)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("D,V", [(4352, 64), (8192, 64), (128, 4352)])
def test_wide_forward_past_the_clusters(cuda, D, V, bf16, monkeypatch):
    """Past 3 tiles a block of 16 blocks, K1, K1-bias and K6 (float32 or
    bfloat16) take the per-pair forward (route ``wide_chunks``), with
    targets and a contextual row on views of one projection: within
    `WIDE_TOL` (bfloat16 `BF16_TOL`) of their plain versions, zeros past the
    lengths, K1's, K1-bias's and K6's outputs the same bits twice; and with
    the scratch's cap lowered so that each (batch row, head) slab is a group
    of its own (4 groups), the same checks again."""
    from generative_recommenders_tpu_torch.ops.cuda import hstu_attention as ha

    dtype = torch.bfloat16 if bf16 else torch.float32
    q, k, v, _, lengths, nt = _wide_views(54, 2, 150, 2, D, V, dtype, cuda)
    kw = dict(alpha=D**-0.5, max_seq_len=160, num_targets=nt, contextual_seq_len=1)
    bias = torch.randn(2, 150, 150, device=cuda, generator=torch.Generator(cuda).manual_seed(55)) * 0.3
    rq, rk, rv, rl, ts, pos_w, ts_w, rnt = _relbias_inputs(56, 2, 150, 2, D, V, 150, 128, True, cuda)
    rq, rk, rv = (x.to(dtype) for x in (rq, rk, rv))
    rkw = dict(alpha=1.0 if bf16 else D**-0.5, max_seq_len=150, num_buckets=128, num_targets=rnt)
    dead = torch.arange(150, device=cuda)[None, :] >= lengths[:, None]
    for groups in (1, 4):
        if groups == 4:
            monkeypatch.setattr(ha, "_PAIR_SCRATCH_CAP", 1)
        plan = ha._fwd_plan(D, V, 2, 0, 0, False, 2, 150, dtype)
        assert plan["route"] == "wide_chunks" and plan["groups"] == groups
        counter = hstu_mha_dense_cuda.launches["hstu_mha_fwd" + ("_bf16" if bf16 else "")]
        before = counter.routes.get("wide_chunks", 0)
        out = hstu_mha_dense_cuda(q, k, v, lengths, **kw)
        assert counter.routes.get("wide_chunks", 0) == before + 1
        _held(f"out ({groups} groups)", out, hstu_mha_dense_plain(q, k, v, lengths, **kw), bf16)
        assert (out[dead] == 0).all()
        assert torch.equal(out, hstu_mha_dense_cuda(q, k, v, lengths, **kw))
        biased = hstu_mha_dense_cuda(q, k, v, lengths, bias=bias, **kw)
        _held(f"biased out ({groups} groups)", biased, hstu_mha_dense_plain(q, k, v, lengths, bias=bias, **kw), bf16)
        assert torch.equal(biased, hstu_mha_dense_cuda(q, k, v, lengths, bias=bias, **kw))
        k6 = hstu_mha_dense_relbias_cuda(rq, rk, rv, rl, ts, pos_w, ts_w, **rkw)
        _held(f"K6 out ({groups} groups)", k6, hstu_mha_dense_relbias_plain(rq, rk, rv, rl, ts, pos_w, ts_w, **rkw),
              bf16)
        assert torch.equal(k6, hstu_mha_dense_relbias_cuda(rq, rk, rv, rl, ts, pos_w, ts_w, **rkw))


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("D,V", [(3968, 128), (2048, 2049)])
def test_widest_backward_on_the_per_chunk_route(cuda, D, V, bf16, monkeypatch):
    """Past 16 blocks of two chunks, K2, K3 + K4, K7 and K7-det take the
    per-pair backward (route ``wide_chunks``): against their plain versions
    with targets and a contextual row, and with a window (``max_attn_len``
    and ``min_full_attn_seq_len``); K2's and K3 + K4's outputs, K7's dq, dk
    and dv and K7-det's the same bits twice (K7's tables are added with
    atomics); and with the scratch's cap lowered so that each (batch row,
    head) slab is a group of its own (4 groups), the same checks again."""
    from generative_recommenders_tpu_torch.ops.cuda import hstu_attention as ha

    dtype = torch.bfloat16 if bf16 else torch.float32
    q, k, v, do, lengths, nt = _wide_views(50, 2, 100, 2, D, V, dtype, cuda)
    rq, rk, rv, rl, ts, pos_w, ts_w, rnt = _relbias_inputs(51, 2, 100, 2, D, V, 100, 128, True, cuda)
    rq, rk, rv = (x.to(dtype) for x in (rq, rk, rv))
    rdo = torch.randn(100, 2, 2, V, device=cuda).to(dtype).transpose(0, 1)
    masks = (dict(num_targets=nt, contextual_seq_len=1), dict(max_attn_len=20, min_full_attn_seq_len=10))
    for groups in (1, 4):
        if groups == 4:
            monkeypatch.setattr(ha, "_PAIR_SCRATCH_CAP", 1)
        assert ha._bwd_plan(D, V, 2, 2, 100, dtype)["groups"] == groups
        for mask in masks:
            kw = dict(alpha=D**-0.5, max_seq_len=110, **mask)
            counter = hstu_mha_bwd_cuda.launches["hstu_mha_bwd_fused" + ("_bf16" if bf16 else "")]
            before = counter.routes.get("wide_chunks", 0)
            fused = hstu_mha_bwd_cuda(q, k, v, lengths, do, **kw)
            assert counter.routes.get("wide_chunks", 0) == before + 1
            split = hstu_mha_bwd_cuda(q, k, v, lengths, do, split=True, **kw)
            want = hstu_mha_bwd_plain(q, k, v, lengths, do, **kw)
            for kind, grads in (("K2", fused), ("K3 + K4", split)):
                for name, g, w in zip(("dq", "dk", "dv"), grads, want):
                    _held(f"{kind} {name} ({groups} groups, {sorted(mask)})", g, w, bf16)
                again = hstu_mha_bwd_cuda(q, k, v, lengths, do, split=kind != "K2", **kw)
                assert all(torch.equal(a, b) for a, b in zip(grads, again)), kind
            rkw = dict(alpha=1.0 if bf16 else D**-0.5, max_seq_len=100, num_buckets=128,
                       **(dict(num_targets=rnt) if "num_targets" in mask else mask))
            args = (rq, rk, rv, rl, ts, pos_w, ts_w)
            _relbias_all(args, rdo, rkw, bf16)
            k7 = [hstu_mha_relbias_bwd_cuda(*args, rdo, **rkw) for _ in range(2)]
            assert all(torch.equal(a, b) for a, b in zip(k7[0][:3], k7[1][:3])), "K7's dq, dk, dv"


# (D, V) of the tile forward: D up to 256 with V of 129 to 256, D up to 128
# with V up to 384, and the two main-path layers' widths (D 128 / V 256, D =
# V = 256)
TILE_SHAPES = [(65, 129), (129, 256), (128, 384), (256, 256), (128, 256), (256, 129), (100, 320), (64, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("D,V", TILE_SHAPES)
def test_wide_forward_on_the_tile_route(cuda, D, V):
    """Float32 K1 and K1-bias on the tile forward (route ``wide_tile``): rows
    on the 64-row tile edges (lengths 63, 64, 65 and N = 150), targets and a
    contextual row, on views of one projection, a float32 bias per row and a
    bfloat16 one shared by the batch (batch stride 0): within `WIDE_TOL` of
    their plain versions, zeros past the lengths, the same bits twice."""
    from generative_recommenders_tpu_torch.ops.cuda import hstu_attention as ha

    B, N, H = 4, 150, 2
    q, k, v, _, _, nt = _wide_views(52, B, N, H, D, V, torch.float32, cuda)
    lengths = torch.tensor([150, 63, 64, 65], dtype=torch.int32, device=cuda)
    kw = dict(alpha=D**-0.5, max_seq_len=N, num_targets=nt, contextual_seq_len=2)
    assert ha._fwd_plan(D, V, H, 0, 0, False, B, N)["route"] == "wide_tile"
    counter = hstu_mha_dense_cuda.launches["hstu_mha_fwd"]
    before = counter.routes.get("wide_tile", 0)
    out = hstu_mha_dense_cuda(q, k, v, lengths, **kw)
    assert counter.routes.get("wide_tile", 0) == before + 1
    _held("out", out, hstu_mha_dense_plain(q, k, v, lengths, **kw), False)
    dead = torch.arange(N, device=cuda)[None, :] >= lengths[:, None]
    assert (out[dead] == 0).all()
    assert torch.equal(out, hstu_mha_dense_cuda(q, k, v, lengths, **kw))
    gen = torch.Generator(cuda).manual_seed(53)
    for bias in (torch.randn(B, N, N, device=cuda, generator=gen) * 0.3,
                 (torch.randn(1, N, N, device=cuda, generator=gen) * 0.3).to(torch.bfloat16)):
        got = hstu_mha_dense_cuda(q, k, v, lengths, bias=bias, **kw)
        _held(f"out with a {bias.dtype} bias", got, hstu_mha_dense_plain(q, k, v, lengths, bias=bias, **kw), False)
        assert torch.equal(got, hstu_mha_dense_cuda(q, k, v, lengths, bias=bias, **kw))


# ------------------------------------- K7 and K7-det in one pass up to 128
ONE_PASS_SHAPES = [(72, 72), (96, 96), (128, 128), (128, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("Nm", [160, 8000], ids=["tables staged", "tables read"])
@pytest.mark.parametrize("D,V", ONE_PASS_SHAPES)
def test_relbias_backward_in_one_pass_up_to_128(cuda, D, V, Nm, bf16):
    """K7 and K7-det at heads of 65 to 128 (float32 or bfloat16) take their
    one-pass bodies (routes ``narrow`` and ``read``, not the wide bodies),
    with targets, lengths on the 64-row tile edges and a table staged or
    read: outputs within `WIDE_TOL` (bfloat16 `BF16_TOL`) of the plain
    backward, the tables within `TABLE_TOL` (K7-det-bf16's within
    `DET_TABLE_TOL_BF16`), K7's dk and dv and every K7-det output the same
    bits on a second run."""
    from generative_recommenders_tpu_torch.ops.cuda import hstu_attention_relbias as hr

    B, N, H = 4, 150, 2
    q, k, v, _, ts, pos_w, ts_w, nt = _relbias_inputs(44, B, N, H, D, V, Nm, 128, True, cuda)
    lengths = torch.tensor([150, 64, 65, 129], dtype=torch.int32, device=cuda)
    if bf16:
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    dtype = q.dtype
    route = hr._relbias_bwd_plan(D, V, H, Nm, 128, dtype, B, N)["route"]
    assert route == ("narrow" if Nm == 160 else "read")
    assert hr._relbias_det_plan(D, V, H, B, N, Nm, 128, True, 0, dtype)["route"] == route
    do = torch.randn(N, B, H, V, device=cuda).to(dtype).transpose(0, 1)
    kw = dict(alpha=1.0 if bf16 else D**-0.5, max_seq_len=N, num_buckets=128, num_targets=nt)
    args = (q, k, v, lengths, ts, pos_w, ts_w)
    _relbias_all(args, do, kw, bf16)
    grads = hstu_mha_relbias_bwd_cuda(*args, do, **kw)
    again = hstu_mha_relbias_bwd_cuda(*args, do, **kw)
    assert torch.equal(grads[1], again[1]) and torch.equal(grads[2], again[2])


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("D,V", ONE_PASS_SHAPES)
def test_relbias_one_pass_against_the_wide_bodies(cuda, D, V, bf16):
    """The one-pass bodies and the wide bodies (forced on the same inputs by
    `variants._wide_forced`) compute one function: K7's and K7-det's outputs
    within `WIDE_TOL` (bfloat16: `BF16_TOL`, the tables `TABLE_TOL`) of each
    other."""
    from generative_recommenders_tpu_torch.ops.cuda.variants import _wide_forced

    B, N, H = 3, 140, 2
    q, k, v, lengths, ts, pos_w, ts_w, nt = _relbias_inputs(45, B, N, H, D, V, 140, 128, False, cuda)
    if bf16:
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    do = torch.randn(N, B, H, V, device=cuda).to(q.dtype).transpose(0, 1)
    kw = dict(alpha=0.5, max_seq_len=N, num_buckets=128)
    args = (q, k, v, lengths, ts, pos_w, ts_w)
    own = [hstu_mha_relbias_bwd_cuda(*args, do, deterministic=det, **kw) for det in (False, True)]
    c = hstu_mha_relbias_bwd_cuda
    before = (c.launches_bf16 if bf16 else c.launches).routes.get("wide", 0)
    with _wide_forced():
        wide = [hstu_mha_relbias_bwd_cuda(*args, do, deterministic=det, **kw) for det in (False, True)]
    assert (c.launches_bf16 if bf16 else c.launches).routes.get("wide", 0) == before + 1
    for got, want in zip(own, wide):
        for name, g, w in zip(("dq", "dk", "dv", "dpos_w", "dts_w"), got, want):
            table = name in ("dpos_w", "dts_w")
            _held(name, g, w, bf16 and not table, TABLE_TOL if table else WIDE_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "D,V,view",
    [(128, 128, True), (128, 128, False), (40, 40, True), (25, 25, False), (8, 136, False), (64, 256, True),
     (512, 64, False), (264, 40, True)],
)
def test_delta_bf16_kernel_in_16_byte_pieces(cuda, D, V, view):
    """K5-bf16's layout (a lane reads 8 elements of a K row in one 16-byte
    load and owns 8 V columns) at widths that take the pieces (D and V
    multiples of 8 on views of one projection or contiguous rows), at widths
    read element by element (D 25, V 136 by 8-column pieces past V 128), at
    V 256 (two V chunks) and at D above 256 (q read in chunks): within
    `BF16_TOL` of its plain version, the same bits on a second run."""
    rng = np.random.default_rng(46)
    B, M, N, H = 3, 5, 200, 2
    t = lambda x: torch.as_tensor(x.astype(np.float32), device=cuda).to(torch.bfloat16)  # noqa: E731
    if view:  # K and V as views of one projection, 8 columns a head before them
        proj = t(rng.standard_normal((B, N, H * (8 + D + V))))
        k = proj[..., 8 * H:8 * H + H * D].reshape(B, N, H, D)
        v = proj[..., 8 * H + H * D:].reshape(B, N, H, V)
    else:
        k, v = t(rng.standard_normal((B, N, H, D))), t(rng.standard_normal((B, N, H, V)))
    q = t(rng.standard_normal((B, M, H, D)))
    lengths = torch.tensor([200, 70, 5], dtype=torch.int32, device=cuda)
    kw = dict(alpha=D**-0.5, norm_len=210, num_targets=torch.tensor([2, 0, 1], dtype=torch.int32, device=cuda))
    from generative_recommenders_tpu_torch.ops.cuda import hstu_attention as ha

    assert ha._vec16(k, 8) == (D % 8 == 0) and ha._delta_plan(B, M, N, H, V, D, torch.bfloat16)["k_piece"] == 8
    got = delta_hstu_mha_cuda(q, k, v, lengths, **kw)
    assert got.dtype == torch.bfloat16
    assert _bf16_err(got, delta_hstu_mha_plain(q, k, v, lengths, **kw)) <= BF16_TOL
    assert torch.equal(got, delta_hstu_mha_cuda(q, k, v, lengths, **kw))
