"""K1-bias, the dense attention forward with an additive [B, N, N] bias, in
the PyTorch port against the JAX package, on the CPU at a small size.

* The CPU path of `hstu_mha_dense_cuda(bias=...)` (K1-bias's plain version)
  against `hstu_mha_dense_pallas(bias=...)` in interpret mode, whose
  `_fwd_kernel_rkv` reads the bias under `has_bias`: float32, and bfloat16
  q, k, v with a float32 or a bfloat16 bias, at an N that is not a multiple
  of the tile, with targets, contextual rows and a window; a [1, N, N] bias
  broadcast over the batch (the JAX package is handed it broadcast).
* Its gradient raises NotImplementedError in both packages: the biased
  forward is forward-only.
* The launch with `_launch` stubbed: the entry point, the bias's pointer,
  its strides (0 across the batch for a broadcast bias), its type, the C
  signature and the counter; the wrapper's checks of the bias.

Tolerances: float32 within 2e-5 of the output's largest entry (the two
differ in summation order and in the exp of silu); bfloat16 within 2^-7
(two roundings), as `tests/test_torch_bf16_dense.py`'s.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from generative_recommenders_tpu.ops.pallas.hstu_attention import hstu_mha_dense_pallas
from generative_recommenders_tpu_torch.ops.cuda import hstu_attention as ha

F32_TOL, BF16_TOL = 2e-5, 2.0**-7  # of the output's largest entry
CASES = [
    dict(),
    dict(num_targets=True, contextual_seq_len=3),
    dict(max_attn_len=6, min_full_attn_seq_len=4),
]
TYPES = {  # q, k, v; bias
    "float32": (np.float32, np.float32),
    "bfloat16": (jnp.bfloat16, np.float32),
    "bfloat16 bias": (jnp.bfloat16, jnp.bfloat16),
}


def _inputs(seed, B, N, H, D, V, ctx, targets, broadcast, types):
    """q, k, v and a [B or 1, N, N] bias of the case's types (as float32
    numpy arrays of their values), lengths with one full row and one of
    length 0, and targets or None."""
    rng = np.random.default_rng(seed)
    qkv_t, bias_t = types
    cast = lambda a, t: np.array(jnp.asarray(a, t).astype(jnp.float32))  # noqa: E731
    q, k = (cast(rng.standard_normal((B, N, H, D)) * 0.5, qkv_t) for _ in range(2))
    v = cast(rng.standard_normal((B, N, H, V)) * 0.5, qkv_t)
    bias = cast(rng.standard_normal((1 if broadcast else B, N, N)), bias_t)
    lengths = rng.integers(ctx + 2, N + 1, size=(B,)).astype(np.int32)
    lengths[0], lengths[-1] = N, 0
    nt = None
    if targets:
        nt = np.minimum(rng.integers(0, 4, size=(B,)), np.maximum(lengths - ctx - 1, 0)).astype(np.int32)
    return q, k, v, bias, lengths, nt


@pytest.mark.parametrize("broadcast", [False, True], ids=["bias [B, N, N]", "bias [1, N, N]"])
@pytest.mark.parametrize("types", list(TYPES), ids=list(TYPES))
@pytest.mark.parametrize("case", CASES)
def test_bias_forward_matches_pallas(case, types, broadcast):
    """`hstu_mha_dense_cuda(bias=...)` on CPU tensors against the Pallas
    forward with the bias in interpret mode (N = 45, padded to 48 there;
    16-row tiles), each output of q's type; rows past the length exactly
    0."""
    case = dict(case)
    targets = case.pop("num_targets", False)
    B, N, H, D, V = 3, 45, 2, 16, 16
    qkv_t, bias_t = TYPES[types]
    q, k, v, bias, lengths, nt = _inputs(31, B, N, H, D, V, case.get("contextual_seq_len", 0), targets,
                                         broadcast, TYPES[types])
    kw = dict(alpha=0.125, max_seq_len=N + 3, causal=True, **case)
    want = hstu_mha_dense_pallas(
        *(jnp.asarray(x, qkv_t) for x in (q, k, v)), jnp.asarray(lengths),
        bias=jnp.broadcast_to(jnp.asarray(bias, bias_t), (B, N, N)),
        num_targets=None if nt is None else jnp.asarray(nt), block_q=16, block_k=16, interpret=True, **kw,
    )
    tt = {np.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    t = lambda a, ty: torch.as_tensor(a).to(tt[ty])  # noqa: E731
    got = ha.hstu_mha_dense_cuda(t(q, qkv_t), t(k, qkv_t), t(v, qkv_t), torch.as_tensor(lengths),
                                 bias=t(bias, bias_t), num_targets=None if nt is None else torch.as_tensor(nt),
                                 **kw)
    assert got.dtype == tt[qkv_t] and str(want.dtype) == str(got.dtype).replace("torch.", "")
    g = got.float().numpy().astype(np.float64)
    w = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    err = np.abs(g - w).max() / np.abs(w).max()
    assert err <= (F32_TOL if qkv_t is np.float32 else BF16_TOL), f"{err:.2e} of the largest entry"
    dead = torch.arange(N)[None, :] >= torch.as_tensor(lengths)[:, None]
    assert (got[dead] == 0).all()


def test_bias_changes_the_answer():
    """The bias reaches S before silu: a nonzero bias changes the output,
    a zero bias gives the bias-free forward's bits."""
    q, k, v, bias, lengths, _ = _inputs(5, 2, 20, 1, 8, 8, 0, False, False, TYPES["float32"])
    q, k, v, lengths = (torch.as_tensor(x) for x in (q, k, v, lengths))
    plain = ha.hstu_mha_dense_cuda(q, k, v, lengths)
    assert torch.equal(ha.hstu_mha_dense_cuda(q, k, v, lengths, bias=torch.zeros(1, 20, 20)), plain)
    assert not torch.allclose(ha.hstu_mha_dense_cuda(q, k, v, lengths, bias=torch.as_tensor(bias)), plain)


def test_bias_gradient_raises_in_both_packages():
    """The biased forward is forward-only: `jax.grad` through
    `hstu_mha_dense_pallas(bias=...)` raises NotImplementedError, and so does
    the backward of `hstu_mha_dense_cuda(bias=...)`, at `backward()`, not at
    the forward."""
    q, k, v, bias, lengths, _ = _inputs(7, 2, 16, 1, 8, 8, 0, False, False, TYPES["float32"])

    def loss(q_):
        return hstu_mha_dense_pallas(q_, jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
                                     bias=jnp.asarray(bias), block_q=8, block_k=8, interpret=True).sum()

    with pytest.raises(NotImplementedError):
        jax.grad(loss)(jnp.asarray(q))
    for dtype in (torch.float32, torch.bfloat16):
        leaves = [torch.as_tensor(x).to(dtype).requires_grad_(True) for x in (q, k, v)]
        out = ha.hstu_mha_dense_cuda(*leaves, torch.as_tensor(lengths), bias=torch.as_tensor(bias))
        assert out.requires_grad and out.dtype == dtype
        with pytest.raises(NotImplementedError, match="forward-only"):
            out.float().sum().backward()


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("broadcast", [False, True], ids=["bias [B, N, N]", "bias [1, N, N]"])
def test_bias_launch(monkeypatch, bf16, broadcast):
    """`hstu_mha_dense_cuda(bias=...)` past its CPU branch (meta tensors,
    the device check passed) with the launch recorded, not made: K1-bias's
    entry point of q's type, the bias's pointer after num_targets, its batch
    stride (0 for one bias broadcast over the batch) and row stride after
    v's strides, its type flag last before the route (on bfloat16 the
    bfloat16 body's scratch pointer after out, None at N 70, and its chunk
    after the type flag); the C signature's length; one count on the entry
    point's counter and none on K1's."""
    calls = []
    monkeypatch.setattr(ha, "_launch", lambda *a: calls.append(a))
    monkeypatch.setattr(ha, "_stream", lambda device: 0)
    monkeypatch.setattr(ha, "_check_qkv", lambda q_, k_, v_, dtypes=(torch.float32,): q_.device)
    B, N, H, D = 2, 70, 3, 32
    dtype = torch.bfloat16 if bf16 else torch.float32
    q = torch.zeros(B, N, H, D, dtype=dtype, device="meta")
    # a bias read with its key axis contiguous, its rows at a pitch of 72
    bias = torch.zeros(1 if broadcast else B, N, 72, dtype=torch.bfloat16, device="meta")[..., :N]
    name = "hstu_mha_fwd_bias_bf16" if bf16 else "hstu_mha_fwd_bias"
    fwd = ha.hstu_mha_dense_cuda.launches
    counters = [fwd[n] for n in ("hstu_mha_fwd", "hstu_mha_fwd_bf16", "hstu_mha_fwd_bias", "hstu_mha_fwd_bias_bf16")]
    before = [c.count for c in counters]
    out = ha.hstu_mha_dense_cuda(q, q, q, torch.tensor([70, 9]), bias=bias, alpha=0.5)
    assert out.shape == (B, N, H, D) and out.dtype == dtype
    (call,) = calls
    assert call[0] == name and ha._LIBRARY[name] == "hstu_mha_fwd"
    assert len(call) - 1 == len(ha._ARGTYPES[name])
    o = int(bf16)  # the scratch pointer after out
    if bf16:
        assert call[5] is None and call[-3] == ha._fwd_plan(D, D, H, 0, 0, False, B, N, dtype)["key_chunk"]
    assert call[7 + o] == bias.data_ptr()
    assert call[8 + o:13 + o] == (B, N, H, D, D)
    assert call[22 + o:24 + o] == (0 if broadcast else N * 72, 72)
    assert call[24 + o:26 + o] == (0.5, 1.0 / N) and call[-3 - o] == 1 and call[-2] == ha._ROUTES["narrow"]
    assert [c.count - b for c, b in zip(counters, before)] == [0, 0, int(not bf16), int(bf16)]


def test_bias_checks(monkeypatch):
    """The wrapper refuses, before anything launches, a bias of another
    shape than [B or 1, N, N] and one of another type than float32 or
    bfloat16."""
    monkeypatch.setattr(ha, "_check_qkv", lambda q_, k_, v_, dtypes=(torch.float32,): q_.device)
    monkeypatch.setattr(ha, "_launch", lambda *a: pytest.fail("launched"))
    q = torch.zeros(2, 8, 1, 8, device="meta")
    lengths = torch.tensor([8, 3])
    with pytest.raises(ValueError, match="bias must have shape"):
        ha.hstu_mha_dense_cuda(q, q, q, lengths, bias=torch.zeros(3, 8, 8, device="meta"))
    with pytest.raises(ValueError, match="bias must have shape"):
        ha.hstu_mha_dense_cuda(q, q, q, lengths, bias=torch.zeros(2, 8, 7, device="meta"))
    with pytest.raises(TypeError, match="bias must be"):
        ha.hstu_mha_dense_cuda(q, q, q, lengths, bias=torch.zeros(2, 8, 8, dtype=torch.float16, device="meta"))
