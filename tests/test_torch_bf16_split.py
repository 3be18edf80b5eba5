"""The deterministic bfloat16 backward of the bias-free research model's
first block, K3-bf16 then K4-bf16 (`hstu_mha_bwd_cuda(split=True)` on
bfloat16), in the PyTorch port against the JAX package, on the CPU at a
small size.

* The CPU path of `hstu_mha_bwd_cuda(split=True)` on bfloat16 against the
  JAX package's split backward, `_bwd_dq_kernel` then `_bwd_dkv_kernel` in
  interpret mode: the resident-row limit of the JAX backward is set to 0 so
  that `_hstu_mha_bwd` takes the split at this size (it takes it on bfloat16
  wherever the rows outgrow VMEM, as at bench.py's H 4, D 64, N 4096), the
  jit caches cleared around it, and the choice it made checked; the four
  mask cases of `tests/test_torch_bf16_dense.py` at alpha 1 and 1/8.
* `_bwd_kernel`'s launch of K3-bf16 and K4-bf16 with the launch stubbed:
  the entry points, their arguments, the outputs each writes and the
  counter of each.

The bias-free bfloat16 research step under deterministic algorithms is a
case of `tests/test_torch_relbias_det.py`'s deterministic-step test.

Tolerance: the bfloat16 gradients within 2^-7 of their largest entry (two
roundings: a float32 sum that lands near a rounding boundary rounds the
other way when its terms come in another order), as
`tests/test_torch_bf16_dense.py`'s.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from generative_recommenders_tpu.ops.pallas import hstu_attention as pa
from generative_recommenders_tpu_torch.ops.cuda import hstu_attention as ha

KERNEL_TOL = 2.0**-7  # of the largest entry: the kernels' bfloat16 outputs
CASES = [
    dict(),
    dict(num_targets=True),
    dict(num_targets=True, contextual_seq_len=3),
    dict(max_attn_len=6, min_full_attn_seq_len=4),
]


def _close_to_max(got, want, tol, what=""):
    got = np.asarray(torch.as_tensor(got).detach().float(), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err:.2e} of the largest entry"


@pytest.fixture
def jax_split(monkeypatch):
    """The JAX backward forced onto its split kernels, and the choices
    `_use_resident_bwd` made meanwhile; the jit caches cleared before (a
    shape traced earlier keeps the path it traced) and after."""
    seen = []
    real = pa._use_resident_bwd
    monkeypatch.setattr(pa, "_RESIDENT_BYTES_LIMIT_BWD", 0)
    monkeypatch.setattr(pa, "_use_resident_bwd", lambda *a: seen.append(real(*a)) or seen[-1])
    jax.clear_caches()
    yield seen
    jax.clear_caches()


@pytest.mark.parametrize("alpha", [1.0, 0.125])
@pytest.mark.parametrize("case", CASES)
def test_bf16_split_backward_matches_pallas_split(jax_split, case, alpha):
    """(dq, dk, dv) of the CPU path of `hstu_mha_bwd_cuda(split=True)` on
    bfloat16 (K3-bf16's and K4-bf16's plain version) against the VJP of
    `hstu_mha_dense_pallas` on bfloat16, which ran `_bwd_dq_kernel` and
    `_bwd_dkv_kernel`; rows past the length get exact zeros."""
    case = dict(case)
    targets = case.pop("num_targets", False)
    ctx = case.get("contextual_seq_len", 0)
    B, N, H, D, V = 3, 48, 2, 16, 16
    rng = np.random.default_rng(23)
    bf = lambda a: np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    q, k = (bf(rng.standard_normal((B, N, H, D)) * 0.5) for _ in range(2))
    v = bf(rng.standard_normal((B, N, H, V)) * 0.5)
    do = bf(rng.standard_normal((B, N, H, V)))
    lengths = rng.integers(ctx + 2, N + 1, size=(B,)).astype(np.int32)
    lengths[0], lengths[-1] = N, 0
    nt = None
    if targets:
        nt = np.minimum(rng.integers(0, 4, size=(B,)), np.maximum(lengths - ctx - 1, 0)).astype(np.int32)
    kw = dict(alpha=alpha, max_seq_len=N + 4, causal=True, **case)
    j = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731

    def fwd(q_, k_, v_):
        return pa.hstu_mha_dense_pallas(
            q_, k_, v_, jnp.asarray(lengths), num_targets=None if nt is None else jnp.asarray(nt),
            block_q=16, block_k=16, interpret=True, **kw,
        )

    _, vjp = jax.vjp(fwd, j(q), j(k), j(v))
    want = vjp(j(do))
    assert jax_split == [False]  # the JAX backward took the split kernels
    t = lambda a: torch.as_tensor(a).to(torch.bfloat16)  # noqa: E731
    got = ha.hstu_mha_bwd_cuda(t(q), t(k), t(v), torch.as_tensor(lengths), t(do), split=True,
                               num_targets=None if nt is None else torch.as_tensor(nt), **kw)
    dead = torch.arange(N)[None, :] >= torch.as_tensor(lengths)[:, None]
    for name, g, w in zip(("dq", "dk", "dv"), got, want, strict=True):
        assert g.dtype == torch.bfloat16
        _close_to_max(g, w, KERNEL_TOL, name)
        assert (g[dead] == 0).all(), name


@pytest.mark.parametrize("name", ["hstu_mha_bwd_dq_bf16", "hstu_mha_bwd_dkv_bf16"])
def test_split_bf16_launch(monkeypatch, name):
    """`_bwd_kernel` for K3-bf16 and K4-bf16 (the launch recorded, not
    made): the float32 kernels' C signature with the bfloat16 bodies' two
    pre-scaled buffers after dO (alpha q's at alpha 1/8 and dO / norm's, of
    their plans' shapes), bfloat16 outputs where the kernel writes them and
    None where not (no float32 dq buffer: neither sums with atomics), the
    `vec_*` flags (pieces of 8 elements), and one count on the entry point's
    own counter."""
    calls = []
    monkeypatch.setattr(ha, "_launch", lambda *a: calls.append(a))
    monkeypatch.setattr(ha, "_stream", lambda device: 0)
    B, N, H, D, V = 2, 70, 3, 32, 32
    proj = torch.zeros(B, N, H * (2 * D + V), dtype=torch.bfloat16)
    q, k, v = (x.reshape(B, N, H, -1) for x in torch.split(proj, [H * D, H * D, H * V], dim=-1))
    do = torch.zeros(B, N, H, V, dtype=torch.bfloat16)
    lens = torch.tensor([70, 9], dtype=torch.int32)
    kw = dict(alpha=0.125, max_seq_len=None, causal=True, max_attn_len=0, contextual_seq_len=0,
              min_full_attn_seq_len=0)
    counters = ha.hstu_mha_bwd_cuda.launches
    before = {n: c.count for n, c in counters.items()}
    dq, dk, dv = ha._bwd_kernel(name, q, k, v, lens, None, do, kw)
    assert [n for n, c in counters.items() if c.count != before[n]] == [name]
    assert counters[name].count == before[name] + 1
    (call,) = calls
    assert call[0] == name and len(call) - 1 == len(ha._ARGTYPES[name]) and ha._LIBRARY[name] == name[:-5]
    o = 2  # the pre-scaled buffers after dO
    plan = (ha._bwd_plan if name == "hstu_mha_bwd_dkv_bf16" else ha._dq_plan)(D, V, H, B, N, torch.bfloat16)
    assert plan["q_scaled_shape"] == (B, N, H, D) and plan["do_scaled_shape"] == (B, N, H, V)
    assert all(isinstance(p, int) for p in call[5:7]) and call[5] != call[6]
    dq_ptr, dk_ptr, dv_ptr = call[5 + o:8 + o]
    if name == "hstu_mha_bwd_dq_bf16":
        assert dq.dtype == torch.bfloat16 and dq.shape == (B, N, H, D) and dk is None and dv is None
        assert dq_ptr == dq.data_ptr() and dk_ptr is None and dv_ptr is None
    else:
        assert dq is None and dk.dtype == dv.dtype == torch.bfloat16 and dv.shape == (B, N, H, V)
        assert dq_ptr is None and (dk_ptr, dv_ptr) == (dk.data_ptr(), dv.data_ptr())
    # q, k and v are views of one projection at a pitch of 80 elements; dO is contiguous
    assert call[-6:-2] == tuple(int(ha._vec16(t, 8)) for t in (q, k, v, do)) and call[-2] == ha._ROUTES["narrow"]
    assert call[15 + o:18 + o] == q.stride()[:3] and call[27 + o] == 0.125  # alpha, whole: the kernel rounds it
