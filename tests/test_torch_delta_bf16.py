"""K5 on bfloat16 (K5-bf16) in the PyTorch port, on the CPU at a small size.

`delta_hstu_mha_plain` on bfloat16 q, k and v, the function of
`delta_hstu_mha_fwd_bf16`, against the Pallas delta kernel
(`delta_hstu_mha_pallas`) in interpret mode on the same bfloat16 inputs
(numpy, from a seed): within 2^-7 of the output's largest entry (both round
alpha q and P to bfloat16 and the output once; they differ in summation
order, which now and then rounds an output to the neighbouring bfloat16).
The float32 plain path is held bit for bit to its earlier form. The wrapper
on bfloat16 CUDA tensors (its entry point, its output type, its counter) is
driven with the launch replaced by a stand-in; `tests/test_torch_kernels.py`
holds the kernel itself on the card.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from generative_recommenders_tpu.ops.pallas.hstu_attention import delta_hstu_mha_pallas
from generative_recommenders_tpu_torch.ops import hstu_attention as jagged_attention
from generative_recommenders_tpu_torch.ops.attention_mask import make_delta_attn_mask
from generative_recommenders_tpu_torch.ops.cuda import hstu_attention as ha

BF16_TOL = 2.0**-7  # of the output's largest entry


def _bf16_inputs(seed, B, M, N, H, D, V, lengths):
    """q, k, v as bfloat16 torch tensors and the same values as JAX arrays."""
    rng = np.random.default_rng(seed)
    make = lambda *shape: torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)  # noqa: E731
    q, k, v = make(B, M, H, D), make(B, N, H, D), make(B, N, H, V)
    as_jax = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
    return (q, k, v), tuple(as_jax(t) for t in (q, k, v)), np.asarray(lengths, np.int32)


@pytest.mark.parametrize(
    "B, M, N, H, D, V, lengths, alpha, targets",
    [
        (1, 2, 8, 1, 8, 8, [8], 1.0, False),  # k = v below
        (2, 4, 40, 2, 16, 24, [40, 23], 0.5, False),
        (3, 3, 40, 2, 16, 16, [40, 17, 9], 0.3, True),
    ],
    ids=["q [1,2,1,8], k = v [1,8,1,8]", "B2 M4 N40 H2 D16 V24 alpha 0.5", "num_targets, alpha 0.3"],
)
def test_bf16_delta_plain_matches_pallas_interpret(B, M, N, H, D, V, lengths, alpha, targets):
    (q, k, v), (jq, jk, jv), lens = _bf16_inputs(5, B, M, N, H, D, V, lengths)
    if B == 1 and N == 8:
        v, jv = k, jk
    nt = np.minimum(M, lens - 1).astype(np.int32) if targets else None
    kw = dict(alpha=alpha, norm_len=N + 5)
    got = ha.delta_hstu_mha_cuda(q, k, v, torch.as_tensor(lens),
                                 num_targets=None if nt is None else torch.as_tensor(nt), **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (B, M, H, V)
    want = delta_hstu_mha_pallas(jq, jk, jv, jnp.asarray(lens), num_targets=None if nt is None else jnp.asarray(nt),
                                 block_k=8, interpret=True, **kw)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_TOL * np.abs(want).max(), f"{err:.3e} of max {np.abs(want).max():.3e}"


def test_bf16_delta_plain_rounds_where_the_kernel_rounds():
    """At alpha 0.3 (not a bfloat16 number) rounding alpha q and P changes
    the answer: the plain version is nearer the Pallas kernel than the same
    function taken in float32 throughout."""
    B, M, N, H, D, V = 2, 4, 40, 2, 16, 16
    (q, k, v), (jq, jk, jv), lens = _bf16_inputs(6, B, M, N, H, D, V, [40, 30])
    kw = dict(alpha=0.3, norm_len=N)
    got = ha.delta_hstu_mha_plain(q, k, v, torch.as_tensor(lens), **kw).float()
    unrounded = ha.delta_hstu_mha_plain(q.float(), k.float(), v.float(), torch.as_tensor(lens), **kw)
    want = torch.as_tensor(np.array(delta_hstu_mha_pallas(jq, jk, jv, jnp.asarray(lens), block_k=8,
                                                          interpret=True, **kw).astype(jnp.float32)))
    assert (got - want).abs().max() < (unrounded.to(torch.bfloat16).float() - want).abs().max()


@pytest.mark.parametrize("case", [dict(), dict(num_targets=True, contextual_seq_len=2, max_attn_len=5)])
def test_float32_delta_plain_is_unchanged(case):
    """The float32 plain version, bit for bit its form before bfloat16: S =
    alpha q k^T, silu(S) / norm, the mask, P V."""
    rng = np.random.default_rng(8)
    B, M, N, H, D, V = 3, 5, 70, 2, 32, 24
    q, k, v = (torch.as_tensor(rng.standard_normal(s).astype(np.float32)) for s in
               ((B, M, H, D), (B, N, H, D), (B, N, H, V)))
    lens = torch.tensor([70, 33, 12], dtype=torch.int32)
    case = dict(case)
    nt = torch.tensor([2, 1, 3], dtype=torch.int32) if case.pop("num_targets", False) else None
    kw = dict(alpha=0.37, norm_len=81, num_targets=nt, **case)
    got = ha.delta_hstu_mha_plain(q, k, v, lens, **kw)
    qk = torch.einsum("bmhd,bnhd->bhmn", q, k) * 0.37
    p = F.silu(qk) / 81
    rows = lens.long()[:, None] - M + torch.arange(M)[None, :]
    mask = make_delta_attn_mask(N, lens, rows.clamp(0, N - 1), causal=True, num_targets=nt,
                                max_attn_len=case.get("max_attn_len", 0),
                                contextual_seq_len=case.get("contextual_seq_len", 0))
    want = torch.einsum("bhmn,bnhv->bmhv", p * mask[:, None].to(p.dtype), v)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
def test_delta_launch_takes_the_entry_point_of_its_type(monkeypatch, bf16):
    """`_delta_fwd`, the wrapper's launch on checked CUDA tensors (driven here
    on CPU tensors with the launch and the stream replaced), launches
    `delta_hstu_mha_fwd_bf16` on bfloat16 and `delta_hstu_mha_fwd` on
    float32, both in K5's library, with as many arguments as the C
    signature and the scratch of the plan; returns v's type and counts the
    launch under its entry point. The jagged `delta_hstu_mha` keeps the type
    (on the CPU, through the plain version)."""
    calls, allocs = [], []
    monkeypatch.setattr(ha, "_launch", lambda *a: calls.append(a))
    monkeypatch.setattr(ha, "_stream", lambda device: 0)
    monkeypatch.setattr(ha, "_delta_counter_buffer", lambda device, n: torch.zeros(n, dtype=torch.int32))
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda shape, **kw: allocs.append((tuple(shape), kw["dtype"]))
                        or real_empty(shape, **kw))
    dtype = torch.bfloat16 if bf16 else torch.float32
    name = "delta_hstu_mha_fwd_bf16" if bf16 else "delta_hstu_mha_fwd"
    B, M, N, H, D, V = 2, 3, 100, 2, 16, 24
    counters = ha.delta_hstu_mha_cuda.launches
    before = {k_: c.count for k_, c in counters.items()}
    q, k, v = torch.zeros(B, M, H, D, dtype=dtype), torch.zeros(B, N, H, D, dtype=dtype), torch.zeros(B, N, H, V,
                                                                                                       dtype=dtype)
    kw = dict(alpha=0.5, norm_len=None, max_attn_len=0, contextual_seq_len=0, min_full_attn_seq_len=0)
    out = ha._delta_fwd(q, k, v, torch.tensor([100, 40], dtype=torch.int32), None, kw)
    assert out.dtype == dtype and out.shape == (B, M, H, V)
    assert len(calls) == 1 and calls[0][0] == name and len(calls[0]) == 1 + len(ha._ARGTYPES[name])
    assert ha._LIBRARY.get(name, name) == "delta_hstu_mha_fwd"
    assert (ha._delta_plan(B, M, N, H, V, D)["scratch_shape"], torch.float32) in allocs
    assert {k_: c.count - before[k_] for k_, c in counters.items()} == {
        "delta_hstu_mha_fwd": 0 if bf16 else 1, "delta_hstu_mha_fwd_bf16": 1 if bf16 else 0}
    monkeypatch.undo()
    offsets = torch.tensor([0, 10, 16])
    got = jagged_attention.delta_hstu_mha(
        10, 0.5, torch.randn(B * M, H, D).to(dtype), torch.randn(16, H, D).to(dtype),
        torch.randn(16, H, V).to(dtype), offsets)
    assert got.dtype == dtype and got.shape == (B * M, H, V)
