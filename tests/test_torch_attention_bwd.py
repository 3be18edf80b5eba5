"""The PyTorch port's attention backward against the JAX package: the plain
backward (`hstu_mha_bwd_plain`, and the backward wrapper on CPU tensors)
against `jax.grad` through `hstu_mha_dense_pallas` in interpret mode, on
both of its backward paths (the fused kernel and the split dq / dkv pair);
and the wiring of the autograd function that carries K1's output to the
backward kernels on the card. Inputs are made with numpy from a seed.

Tolerance rtol 1e-4, atol 1e-5, as `tests/test_pallas_attention.py`'s
backward test: both sides are float32 but sum the gradient products in
different orders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from generative_recommenders_tpu.ops.pallas import hstu_attention as pallas_attn
from generative_recommenders_tpu_torch.ops.cuda import hstu_attention as ha

TOL = dict(rtol=1e-4, atol=1e-5)

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


def _setup(seed, B, N, H, D, V, ctx):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((B, N, H, D)).astype(np.float32) * 0.3 for _ in range(2))
    v = rng.standard_normal((B, N, H, V)).astype(np.float32) * 0.3
    lengths = rng.integers(ctx + 1, N + 1, size=(B,)).astype(np.int32)
    lengths[0] = N  # one full row
    do = rng.standard_normal((B, N, H, V)).astype(np.float32)
    return q, k, v, lengths, do


def _targets(case, lengths, ctx):
    if not case.pop("num_targets", False):
        return None
    rng = np.random.default_rng(1)
    return np.minimum(rng.integers(0, 4, size=lengths.shape), lengths - ctx - 1).clip(0).astype(np.int32)


def _pallas_grads(q, k, v, lengths, nt, do, kw):
    def loss(q_, k_, v_):
        out = pallas_attn.hstu_mha_dense_pallas(
            q_, k_, v_, jnp.asarray(lengths),
            num_targets=None if nt is None else jnp.asarray(nt),
            block_q=8, block_k=8, interpret=True, **kw,
        )
        return jnp.sum(out * jnp.asarray(do))

    return jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


@pytest.mark.parametrize("split", [False, True], ids=["fused", "split"])
@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_pallas(case, split, monkeypatch):
    """The JAX package takes its fused backward kernel when the rows fit its
    VMEM budget, else the dq / dkv pair; the split run forces the pair (at
    another N, so that the jitted backward is traced anew). The plain
    backward gives exact zeros at rows >= length; the Pallas gradients there
    are zeroed before comparing, as the JAX test does."""
    case = dict(case)
    B, N, H, D, V = 2, 20 if split else 16, 2, 8, 8
    ctx = case.get("contextual_seq_len", 0)
    q, k, v, lengths, do = _setup(3, B, N, H, D, V, ctx)
    nt = _targets(case, lengths, ctx)
    kw = dict(alpha=0.7, max_seq_len=N + 5, **case)
    if split:
        monkeypatch.setattr(pallas_attn, "_use_resident_bwd", lambda *a: False)
    want = _pallas_grads(q, k, v, lengths, nt, do, kw)
    t = torch.as_tensor
    args = (t(q), t(k), t(v), t(lengths), t(do))
    tkw = dict(num_targets=None if nt is None else t(nt), **kw)
    got = ha.hstu_mha_bwd_plain(*args, **tkw)
    # the backward wrapper computes the plain backward on CPU tensors
    wrappers = [ha.hstu_mha_bwd_cuda(*args, split=s, **tkw) for s in (False, True)]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.array(w)
        for b in range(B):
            assert (g[b, lengths[b]:] == 0).all(), f"{name}: rows >= length are not 0"
            w[b, lengths[b]:] = 0.0
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)
    for grads in wrappers:
        for g, w in zip(grads, got):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("deterministic", [False, True])
def test_autograd_function_runs_the_backward_kernels(deterministic, monkeypatch):
    """`_HstuMhaDense`, the autograd function that `hstu_mha_dense_cuda` uses
    on CUDA tensors, driven here on the CPU with K1's launch replaced by the
    plain forward (the backward wrapper computes the plain backward on CPU
    tensors): q, k and v all get gradients, equal to autograd through the
    plain forward, from K2, or from K3 then K4 under
    ``torch.use_deterministic_algorithms(True)``. The output gradient comes
    from a reshape and is not contiguous, as on the STU path."""
    B, N, H, D, V = 2, 12, 2, 8, 8
    q, k, v, lengths, do = _setup(5, B, N, H, D, V, 2)
    nt = np.array([3, 1], np.int32)
    kw = dict(alpha=0.5, max_seq_len=16, causal=True, max_attn_len=0,
              contextual_seq_len=2, min_full_attn_seq_len=0)
    monkeypatch.setattr(
        ha, "_dense_fwd",
        lambda q_, k_, v_, lens, nt_, kw_: ha.hstu_mha_dense_plain(q_, k_, v_, lens, num_targets=nt_, **kw_),
    )
    called = []
    fn = ha.hstu_mha_bwd_cuda
    monkeypatch.setattr(ha, "hstu_mha_bwd_cuda", lambda *a, **kw_: called.append(kw_["split"]) or fn(*a, **kw_))

    leaves = [torch.as_tensor(x).requires_grad_(True) for x in (q, k, v)]
    weight = torch.as_tensor(do).permute(1, 0, 2, 3).reshape(N, B, H * V).transpose(0, 1)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic)
    try:
        out = ha._HstuMhaDense.apply(*leaves, torch.as_tensor(lengths), torch.as_tensor(nt), kw)
        (out.reshape(B, N, H * V) * weight).sum().backward()
    finally:
        torch.use_deterministic_algorithms(prev)
    assert called == [deterministic]  # split: K3 then K4; else K2
    ref = [torch.as_tensor(x).requires_grad_(True) for x in (q, k, v)]
    want_out = ha.hstu_mha_dense_plain(*ref, torch.as_tensor(lengths), num_targets=torch.as_tensor(nt), **kw)
    (want_out.reshape(B, N, H * V) * weight).sum().backward()
    for leaf, r in zip(leaves, ref):
        assert leaf.grad is not None
        torch.testing.assert_close(leaf.grad, r.grad, rtol=0, atol=0)
