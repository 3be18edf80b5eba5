"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test skips without a CUDA card. This file imports no
JAX, so on a machine without JAX it runs with the repo's conftest left out:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Float32 with TF32 off; kernel and plain version differ only in summation
order and the exp of silu, so atol = rtol = 1e-5 of outputs of order 1e-2.
"""

import numpy as np
import pytest
import torch

from generative_recommenders_tpu_torch.ops.cuda.hstu_attention import (
    delta_hstu_mha_cuda,
    delta_hstu_mha_plain,
    hstu_mha_dense_cuda,
    hstu_mha_dense_plain,
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
