"""K7-det, the relative-bias backward summed in one fixed order, in the
PyTorch port, on the CPU at a small size.

Its function is K7's: the CPU path of `hstu_mha_relbias_bwd_cuda` is the
plain backward whatever ``deterministic`` says, which `tests/test_torch_relbias.py`
and `tests/test_torch_bf16.py` hold against the Pallas VJP; the kernel's own
arithmetic is held to it on the card (`tests/test_torch_kernels.py`).

* `_relbias_det_plan`: the dq pass's grid and shared memory, K7's grid, the
  partial buffer of the blocks' table sums (1,536 x 1,150 floats at ml-3b's
  shape), the sum's grid, and what it refuses.
* `_relbias_bwd` with ``deterministic``: the entry point, the arguments its
  C signature takes, the partial buffer of the plan, the counters
  ``launches_det`` / ``launches_det_bf16``.
* `_HstuMhaRelbias` under `torch.use_deterministic_algorithms(True)`, driven
  on the CPU with K6's launch replaced by a stand-in: K6, then K7-det, and
  autograd's gradients, in float32 and bfloat16.
* A research training step under deterministic algorithms equal to one
  without them, bit for bit, float32 and bfloat16.
"""

import importlib

import numpy as np
import pytest
import torch

from generative_recommenders_tpu_torch.ops.cuda import hstu_attention_relbias as hr

t_seq = importlib.import_module("generative_recommenders_tpu_torch.models.sequential")
t_train = importlib.import_module("generative_recommenders_tpu_torch.train.train_loop")


def _inputs(seed, B, N, H, D, V, Nm, nb, bf16):
    rng = np.random.default_rng(seed)
    cast = (lambda a: torch.as_tensor(a).to(torch.bfloat16).float().numpy()) if bf16 else (lambda a: a)
    q, k = (cast((rng.standard_normal((B, N, H, D)) * 0.3).astype(np.float32)) for _ in range(2))
    v = cast((rng.standard_normal((B, N, H, V)) * 0.3).astype(np.float32))
    do = cast(rng.standard_normal((B, N, H, V)).astype(np.float32))
    lengths = rng.integers(1, N + 1, size=(B,)).astype(np.int32)
    lengths[0] = N
    ts = (1_600_000_000 + np.cumsum(rng.integers(1, 90000, size=(B, N)), axis=1)).astype(np.int64)
    pos_w = (rng.standard_normal(2 * Nm - 1) * 0.05).astype(np.float32)
    ts_w = (rng.standard_normal(nb + 1) * 0.05).astype(np.float32)
    return q, k, v, do, lengths, ts, pos_w, ts_w


@pytest.mark.parametrize(
    "D, V, H, B, N, Nm, NB, width, head_group, grid, partial_shape, dq_grid, dq_shared_bytes",
    [
        # ml-3b/hstu-sampled-softmax-n96-seqlen500-large: 8 key tiles x 2 head
        # groups x 96 rows = 1,536 blocks of 1,150 floats (7.1 MB)
        (32, 32, 8, 96, 511, 511, 128, 32, 4, (8, 2, 96), (1536, 1150), (8 * 8 * 96,),
         4 * ((64 + 128) * (40 + 40) + 64 * 72 + 4 + 1021 + 129 + 511)),
        # ml-1m/hstu-sampled-softmax-n128-large: D = V = 25, 2 heads in one group
        (25, 25, 2, 128, 211, 211, 128, 32, 4, (4, 1, 128), (512, 550), (4 * 2 * 128,),
         4 * ((64 + 128) * (40 + 40) + 64 * 72 + 4 + 421 + 129 + 211)),
        # width 64: groups of 2 heads, H = 3 leaves one unfilled
        (50, 50, 3, 2, 140, 140, 64, 64, 2, (3, 2, 2), (12, 344), (3 * 3 * 2,),
         4 * ((64 + 128) * (72 + 72) + 64 * 72 + 4 + 279 + 65 + 140)),
    ],
    ids=["ml-3b", "ml-1m-large", "width-64"],
)
def test_det_launch_plan(D, V, H, B, N, Nm, NB, width, head_group, grid, partial_shape, dq_grid, dq_shared_bytes):
    plan = hr._relbias_det_plan(D, V, H, B, N, Nm, NB)
    assert plan["width"] == width and plan["head_group"] == head_group
    assert plan["grid"] == grid and plan["partial_shape"] == partial_shape
    assert plan["partial_shape"][0] == grid[0] * grid[1] * grid[2]
    assert plan["dq_grid"] == dq_grid and plan["dq_shared_bytes"] == dq_shared_bytes <= 232448
    assert plan["shared_bytes"] == hr._relbias_bwd_plan(D, V, H, Nm, NB)["shared_bytes"]
    assert plan["sum_grid"] == (-(-partial_shape[1] // 32),)


@pytest.mark.parametrize("args, match", [
    ((72, 32, 2, 2, 100, 100, 128), "D, V <= 64"),
    ((32, 32, 2, 2, 100, 20000, 128), "bytes of shared memory"),
    ((32, 32, 2, 2, 40000, 1000, 10), "dq pass"),
])
def test_det_launch_plan_raises(args, match):
    with pytest.raises(ValueError, match=match):
        hr._relbias_det_plan(*args)


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
def test_deterministic_launch_goes_by_the_plan(monkeypatch, bf16):
    """`_relbias_bwd` with ``deterministic`` launches K7-det's entry point
    with as many arguments as its C signature, the partial buffer of the
    plan as its extra pointer, and counts one K7-det launch (float32 or
    bfloat16) and nothing else; no output is a zeroed accumulation buffer."""
    calls = []
    monkeypatch.setattr(hr.ha, "_launch", lambda *a: calls.append(a))
    monkeypatch.setattr(hr.ha, "_stream", lambda device: 0)
    allocs = []
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda shape, **kw: allocs.append(tuple(shape)) or real_empty(shape, **kw))
    B, N, H, D, Nm, NB = 2, 70, 3, 32, 70, 128
    dtype = torch.bfloat16 if bf16 else torch.float32
    q = torch.zeros(B, N, H, D, dtype=dtype)
    lens, ts = torch.tensor([70, 9], dtype=torch.int32), torch.zeros(B, N)
    kw = dict(alpha=1.0, max_seq_len=None, causal=True, max_attn_len=0, contextual_seq_len=0,
              min_full_attn_seq_len=0)
    c = hr.hstu_mha_relbias_bwd_cuda
    counters = (c.launches, c.launches_bf16, c.launches_det, c.launches_det_bf16)
    before = [x.count for x in counters]
    grads = hr._relbias_bwd(q, q, q, lens, None, ts, torch.zeros(2 * Nm - 1), torch.zeros(NB + 1), q, kw,
                            deterministic=True)
    name = "hstu_mha_relbias_bwd_det_bf16" if bf16 else "hstu_mha_relbias_bwd_det"
    assert len(calls) == 1 and calls[0][0] == name and len(calls[0]) == 1 + len(hr.ha._ARGTYPES[name])
    assert [x.count - b for x, b in zip(counters, before)] == ([0, 0, 0, 1] if bf16 else [0, 0, 1, 0])
    assert [g.dtype for g in grads] == [dtype] * 3 + [torch.float32] * 2
    assert hr._relbias_det_plan(D, D, H, B, N, Nm, NB)["partial_shape"] in allocs


def _stand_ins(monkeypatch):
    """K6's launch replaced by the plain forward on CPU tensors; the backward
    wrapper recorded as K7 or K7-det. Returns the list of calls."""
    called = []

    def fwd(q, k, v, lens, nt, ts, pos_w, ts_w, kw):
        called.append("K6")
        return hr.hstu_mha_dense_relbias_plain(
            q, k, v, lens, ts, pos_w, ts_w, num_targets=nt, num_buckets=ts_w.shape[0] - 1, **kw
        )

    bwd = hr.hstu_mha_relbias_bwd_cuda
    monkeypatch.setattr(hr, "_relbias_fwd", fwd)
    monkeypatch.setattr(
        hr, "hstu_mha_relbias_bwd_cuda",
        lambda *a, **kw: called.append("K7-det" if kw["deterministic"] else "K7") or bwd(*a, **kw),
    )
    return called


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
def test_autograd_function_takes_k7_det_under_deterministic_mode(monkeypatch, bf16):
    """`_HstuMhaRelbias` on q, k, v views of one projection: K6, then K7-det
    under deterministic algorithms (no warning, no raise), with the plain
    version's gradients for q, k, v and both tables."""
    B, N, H, D, V, Nm, nb = 2, 30, 2, 8, 8, 30, 16
    q, k, v, _, lengths, ts, pos_w, ts_w = _inputs(33, B, N, H, D, V, Nm, nb, bf16)
    dtype = torch.bfloat16 if bf16 else torch.float32
    kw = dict(alpha=1.0, max_seq_len=N, causal=True, max_attn_len=0, contextual_seq_len=0,
              min_full_attn_seq_len=0)
    weight = torch.as_tensor(np.random.default_rng(34).standard_normal((N, B, H * V)).astype(np.float32)).transpose(0, 1)
    called = _stand_ins(monkeypatch)

    def grads(apply):
        proj = torch.cat([torch.as_tensor(x).reshape(B, N, -1) for x in (v, q, k)], dim=-1).to(dtype)
        proj.requires_grad_(True)
        tables = [torch.as_tensor(x).requires_grad_(True) for x in (pos_w, ts_w)]
        v_, q_, k_ = torch.split(proj, [H * V, H * D, H * D], dim=-1)
        out = apply(q_.reshape(B, N, H, D), k_.reshape(B, N, H, D), v_.reshape(B, N, H, V), *tables)
        (out.reshape(B, N, H * V).float() * weight).sum().backward()
        return [proj.grad, *(x.grad for x in tables)]

    prev, prev_warn = torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        got = grads(lambda q_, k_, v_, pw, tw: hr._HstuMhaRelbias.apply(
            q_, k_, v_, pw, tw, torch.as_tensor(ts).float(), torch.as_tensor(lengths), None, kw))
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=prev_warn)
    assert called == ["K6", "K7-det"]
    want = grads(lambda q_, k_, v_, pw, tw: hr.hstu_mha_dense_relbias_plain(
        q_, k_, v_, torch.as_tensor(lengths), torch.as_tensor(ts), pw, tw, num_buckets=nb, **kw))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def _small_trainer(compute_dtype):
    model = t_seq.ModelConfig(
        main_module="HSTU", num_items=120, max_sequence_len=36, gr_output_length=3, item_embedding_dim=32,
        num_blocks=2, num_heads=2, dqk=16, dv=16, linear_dropout_rate=0.2, dropout_rate=0.2,
        compute_dtype=compute_dtype,
    )
    cfg = t_train.TrainConfig(model=model, local_batch_size=4, eval_batch_size=4, num_negatives=6)
    return t_train.ResearchTrainer(cfg, np.arange(1, 121), device="cpu")


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_research_step_under_deterministic_mode_equals_one_without(compute_dtype):
    """Two research train steps from one seed (dropout on), one under
    `torch.use_deterministic_algorithms(True)` (warn_only off: no operation
    of the step refuses), give the same loss and the same parameters, bit
    for bit: on the CPU every path is already the plain one, and deterministic
    mode changes no function."""
    rng = np.random.default_rng(35)
    B, L = 4, 36
    lengths = rng.integers(1, L + 1, size=(B,))
    lengths[0] = L
    live = np.arange(L)[None, :] < lengths[:, None]
    ts = 1_400_000_000 + np.cumsum(rng.integers(60, 86400, size=(B, L + 1)), axis=1)
    batch = {
        "user_id": np.arange(1, B + 1, dtype=np.int64),
        "historical_ids": rng.integers(1, 121, size=(B, L)) * live,
        "historical_ratings": rng.integers(1, 6, size=(B, L)) * live,
        "historical_timestamps": ts[:, :-1] * live,
        "history_lengths": lengths.astype(np.int64),
        "target_ids": rng.integers(1, 121, size=(B,)),
        "target_ratings": rng.integers(1, 6, size=(B,)),
        "target_timestamps": ts[np.arange(B), lengths],
    }
    results = []
    for deterministic in (False, True):
        torch.manual_seed(0)
        trainer = _small_trainer(compute_dtype)
        prev = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(deterministic)
        try:
            loss = float(trainer.train_step(batch))
        finally:
            torch.use_deterministic_algorithms(prev)
        results.append((loss, {n: p.detach().clone() for n, p in trainer.model.named_parameters()}))
    (l0, p0), (l1, p1) = results
    assert np.isfinite(l0) and l0 == l1
    assert p0.keys() == p1.keys() and all(torch.equal(p0[n], p1[n]) for n in p0)
