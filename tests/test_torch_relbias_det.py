"""K7-det, the relative-bias backward summed in one fixed order, in the
PyTorch port, on the CPU at a small size.

Its function is K7's: the CPU path of `hstu_mha_relbias_bwd_cuda` is the
plain backward whatever ``deterministic`` says, which `tests/test_torch_relbias.py`
and `tests/test_torch_bf16.py` hold against the Pallas VJP; the kernel's own
arithmetic is held to it on the card (`tests/test_torch_kernels.py`).

* `_relbias_det_plan`: K7's grid, the partial buffer of the blocks' table
  sums (1,536 x 1,150 floats at ml-3b's shape), the dQ slots (one per tile
  pair the walk visits, `_det_slot`, against a Python enumeration of the C
  walk), the sum's grid, and what it refuses; the slots' ordered sum
  emulated in plain PyTorch against the plain backward's dq.
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
    "D, V, H, B, N, Nm, NB, width, head_group, grid, partial_shape, dq_partial_shape, sum_grid",
    [
        # ml-3b/hstu-sampled-softmax-n96-seqlen500-large: 8 key tiles x 2 head
        # groups x 96 rows = 1,536 blocks of 1,150 floats (7.1 MB); 36 causal
        # tile pairs a row, each 64 x 8 heads x 32 floats (226 MB); 4 sum
        # blocks per query tile, then 36 for the tables
        (32, 32, 8, 96, 511, 511, 128, 32, 4, (8, 2, 96), (1536, 1150), (96, 36, 64, 8, 32),
         (96 * 8 * 4 + 36,)),
        # ml-1m/hstu-sampled-softmax-n128-large: D = V = 25, 2 heads in one
        # group; H D = 50 is not a multiple of 4: 1024 floats a sum block
        (25, 25, 2, 128, 211, 211, 128, 32, 4, (4, 1, 128), (512, 550), (128, 10, 64, 2, 25),
         (128 * 4 * 4 + 18,)),
        # width 64: groups of 2 heads, H = 3 leaves one unfilled
        (50, 50, 3, 2, 140, 140, 64, 64, 2, (3, 2, 2), (12, 344), (2, 6, 64, 3, 50), (2 * 3 * 10 + 11,)),
    ],
    ids=["ml-3b", "ml-1m-large", "width-64"],
)
def test_det_launch_plan(D, V, H, B, N, Nm, NB, width, head_group, grid, partial_shape, dq_partial_shape,
                         sum_grid):
    plan = hr._relbias_det_plan(D, V, H, B, N, Nm, NB)
    assert plan["width"] == width and plan["head_group"] == head_group
    assert plan["grid"] == grid and plan["partial_shape"] == partial_shape
    assert plan["partial_shape"][0] == grid[0] * grid[1] * grid[2]
    assert plan["dq_partial_shape"] == dq_partial_shape and plan["pairs"] == dq_partial_shape[1]
    assert plan["shared_bytes"] == hr._relbias_bwd_plan(D, V, H, Nm, NB)["shared_bytes"]
    assert plan["sum_grid"] == sum_grid
    assert "dq_route" not in plan and "dq_shared_bytes" not in plan  # no dq pass


@pytest.mark.parametrize("args, match", [
    ((0, 32, 2, 2, 100, 100, 128), "at least 1"),
    ((32, 32, 2, 70000, 100, 100, 128), "grid"),
])
def test_det_launch_plan_raises(args, match):
    """A width of 0 and a grid beyond CUDA's are all it refuses."""
    with pytest.raises(ValueError, match=match):
        hr._relbias_det_plan(*args)


@pytest.mark.parametrize("args, route", [
    ((136, 32, 2, 2, 100, 100, 128), "wide"),
    ((32, 32, 2, 2, 100, 20000, 128), "read"),
    ((32, 32, 2, 2, 40000, 1000, 10), "dq read"),
])
def test_det_launch_plan_admits(args, route):
    """Shapes past K7-det's staged tiling: wide heads take the wide backward
    (its dq pass, then one row of `partial` per block of its dkv pass: a
    cluster of one block per chunk of D and V per (key tile, head, batch
    row); no dQ slots); a long table is read from device memory by K7's
    body; a long N (40,000 rows) takes the narrow body, its dQ slots one
    per causal tile pair."""
    D, V, H, B, N, Nm, NB = args
    plan = hr._relbias_det_plan(*args)
    assert plan["shared_bytes"] <= 232448
    assert plan["partial_shape"][1] == 2 * Nm - 1 + NB + 1
    if route == "wide":
        assert plan["route"] == "wide" and plan["dq_shared_bytes"] <= 232448
        assert plan["partial_shape"][0] == -(-N // 64) * H * B * (-(-D // 128) + -(-V // 128))
        assert plan["dq_partial_shape"] is None
        assert plan["sum_grid"] == (-(-(2 * Nm - 1 + NB + 1) // 32),)  # the tables alone
    elif route == "read":
        assert plan["route"] == "read"
    else:
        tiles = -(-N // 64)
        assert plan["route"] == "narrow" and plan["dq_partial_shape"] == (B, tiles * (tiles + 1) // 2, 64, H, D)


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
    assert calls[0][-2] == hr.ha._ROUTES["narrow"]  # K7's body's route
    assert [x.count - b for x, b in zip(counters, before)] == ([0, 0, 0, 1] if bf16 else [0, 0, 1, 0])
    assert [g.dtype for g in grads] == [dtype] * 3 + [torch.float32] * 2
    plan = hr._relbias_det_plan(D, D, H, B, N, Nm, NB, True, 0, dtype)
    assert plan["partial_shape"] in allocs and plan["dq_partial_shape"] in allocs
    # the two scratch pointers follow dpos and dts: the table rows, the dQ
    # slots (on bfloat16 after the pre-scaled buffers, alpha q's None at
    # alpha 1, then dO / norm's)
    o = 2 if bf16 else 0
    assert all(isinstance(x, int) and x for x in calls[0][15 + o:17 + o])
    if bf16:
        assert calls[0][5] is None and isinstance(calls[0][6], int) and plan["do_scaled_shape"] in allocs


def _walk_pairs(N, lower_only, length=None):
    """The (query tile, key tile) pairs K7's walk visits at a row's
    ``length`` (default N), as csrc/hstu_mha_relbias_bwd.cu walks them: a
    block per key tile below the length, its query tiles from its own
    (``lower_only``) or the first, up to the length."""
    length = N if length is None else length
    return [(row0 // 64, col0 // 64) for col0 in range(0, length, 64)
            for row0 in range(col0 if lower_only else 0, length, 64)]


@pytest.mark.parametrize("N", [1, 63, 64, 65, 511, 4096])
@pytest.mark.parametrize("mask", ["causal", "contextual rows", "max_attn_len", "non-causal"])
def test_det_slots_hold_the_walks_pairs(N, mask):
    """`_relbias_det_plan`'s dQ slots against the C walk's pairs: every pair
    the walk visits has a slot of its own, and no slot is left for a pair it
    does not visit (a window does not shorten the walk; contextual rows and
    a non-causal mask make it take every pair); the `dq_partial` shape. At
    shorter lengths the sum reads exactly the slots the walk writes."""
    causal = mask != "non-causal"
    ctx = 3 if mask == "contextual rows" else 0
    B, H, D = 2, 8, 32
    plan = hr._relbias_det_plan(D, D, H, B, N, N, 128, causal, ctx)
    lower_only = causal and ctx == 0
    assert plan["lower_only"] == lower_only
    tiles = -(-N // 64)
    pairs = _walk_pairs(N, lower_only)
    slots = [hr._det_slot(qt, kt, tiles, lower_only) for qt, kt in pairs]
    assert sorted(slots) == list(range(plan["pairs"])) and len(set(slots)) == len(pairs)
    assert plan["dq_partial_shape"] == (B, len(pairs), 64, H, D)
    for length in sorted({1, 64, 65, N // 2 + 1, N}):
        if length > N:
            continue
        written = set(_walk_pairs(N, lower_only, length))
        # det_sums_kernel: a live query tile's key tiles 0 .. qt (lower_only)
        # or every key tile below the length, in ascending order
        read = {(qt, kt) for qt in range(-(-length // 64))
                for kt in range(qt + 1 if lower_only else -(-length // 64))}
        assert read == written


@pytest.mark.parametrize("case", [dict(), dict(num_targets=True, max_attn_len=37), dict(contextual_seq_len=3),
                                  dict(causal=False)], ids=["causal", "window", "contextual", "non-causal"])
def test_ordered_slot_sum_matches_plain_dq(case):
    """K7-det's dq as its two launches form it, emulated in plain PyTorch:
    each visited tile pair's alpha dS K stored to its slot (rows past the
    length left out), then each query tile's slots added over the key tiles
    in ascending order; against `hstu_mha_relbias_bwd_plain`'s dq within
    2e-5 of its largest entry."""
    B, N, H, D, V, Nm, nb = 3, 150, 2, 8, 8, 150, 16
    q, k, v, do, lengths, ts, pos_w, ts_w = _inputs(36, B, N, H, D, V, Nm, nb, False)
    case = dict(case)
    nt = np.minimum(np.array([2, 1, 3]), lengths - 1).astype(np.int32) if case.pop("num_targets", False) else None
    kw = dict(alpha=0.7, max_seq_len=N, causal=True, num_targets=None if nt is None else torch.as_tensor(nt),
              max_attn_len=0, contextual_seq_len=0, min_full_attn_seq_len=0)
    kw.update(case)
    T = torch.as_tensor
    want = hr.hstu_mha_relbias_bwd_plain(T(q), T(k), T(v), T(lengths), T(ts), T(pos_w), T(ts_w), T(do),
                                         num_buckets=nb, **kw)[0]
    # dS as K7 forms it
    mask = hr._plain_mask(N, T(lengths), kw)[:, None]
    bias = hr.relative_bias_plain(T(ts), T(pos_w), T(ts_w), nb)[:, None]
    s = torch.einsum("bnhd,bmhd->bhnm", T(q), T(k)) * kw["alpha"] + bias
    sig = torch.sigmoid(s)
    dp = torch.einsum("bnhv,bmhv->bhnm", T(do), T(v)) / N
    ds = torch.where(mask, dp * sig * (1 + s * (1 - sig)), 0.0)
    plan = hr._relbias_det_plan(D, V, H, B, N, Nm, nb, kw["causal"], kw["contextual_seq_len"])
    lower_only, tiles = plan["lower_only"], plan["tiles"]
    slots = torch.full(plan["dq_partial_shape"], float("nan"))
    for b in range(B):
        for qt, kt in _walk_pairs(N, lower_only, int(lengths[b])):
            r0, c0 = qt * 64, kt * 64
            rows = min(64, int(lengths[b]) - r0)
            tile = kw["alpha"] * torch.einsum("hrc,chd->rhd", ds[b, :, r0:r0 + rows, c0:c0 + 64], T(k)[b, c0:c0 + 64])
            slots[b, hr._det_slot(qt, kt, tiles, lower_only), :rows] = tile
    got = torch.zeros(B, N, H, D)
    for b in range(B):
        length = int(lengths[b])
        for qt in range(-(-length // 64)):
            rows = min(64, length - qt * 64)
            acc = torch.zeros(rows, H, D)
            for kt in range(qt + 1 if lower_only else -(-length // 64)):
                acc = acc + slots[b, hr._det_slot(qt, kt, tiles, lower_only), :rows]
            got[b, qt * 64:qt * 64 + rows] = acc
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= 2e-5 * want.abs().max().item(), err


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


def _small_trainer(compute_dtype, relbias=True):
    model = t_seq.ModelConfig(
        main_module="HSTU", num_items=120, max_sequence_len=36, gr_output_length=3, item_embedding_dim=32,
        num_blocks=2, num_heads=2, dqk=16, dv=16, linear_dropout_rate=0.2, dropout_rate=0.2,
        compute_dtype=compute_dtype, enable_relative_attention_bias=relbias,
    )
    cfg = t_train.TrainConfig(model=model, local_batch_size=4, eval_batch_size=4, num_negatives=6)
    return t_train.ResearchTrainer(cfg, np.arange(1, 121), device="cpu")


@pytest.mark.parametrize("compute_dtype, relbias", [("float32", True), ("bfloat16", True), ("bfloat16", False)],
                         ids=["float32", "bfloat16", "bfloat16-bias-free"])
def test_research_step_under_deterministic_mode_equals_one_without(compute_dtype, relbias):
    """Two research train steps from one seed (dropout on), one under
    `torch.use_deterministic_algorithms(True)` (warn_only off: no operation
    of the step refuses), give the same loss and the same parameters, bit
    for bit: on the CPU every path is already the plain one, and deterministic
    mode changes no function. Also the bias-free bfloat16 model, whose
    deterministic backward on the card is K3-bf16 + K4-bf16."""
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
        trainer = _small_trainer(compute_dtype, relbias)
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
