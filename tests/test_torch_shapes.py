"""Every shape the Pallas kernels take, in the PyTorch port, on the CPU.

* The admission grid: for every (H, N, D, V, Nm, NB) of a grid that holds
  the shapes the JAX package's VMEM gates admit (`relbias_pallas_supported`,
  `_use_resident`, `_use_resident_bwd`, `delta_pallas_supported`) and the
  3-D-grid shapes past them, every launch plan of the port (`_fwd_plan`,
  `_bwd_plan`, `_dq_plan`, `_delta_plan`, `_relbias_bwd_plan`,
  `_relbias_det_plan`) returns a plan that fits a Hopper block's 232,448
  bytes of shared memory, and raises nothing.
* The plain versions the card holds the kernels to, against the Pallas
  kernels in interpret mode, forward and gradients, at the widths and table
  lengths past the narrow CUDA tilings: dense attention at V 136 and D 320
  (float32 and bfloat16), K5 at V 192, the relative bias at D = V = 128 and
  with a position table of 2 * 2848 - 1 entries at N 16.
* Two small research encoders against the JAX package's on the same
  weights (`convert.py`): one with a position table of 2,848 rows run on
  short batches, one with two heads of 128.

Tolerances: the forward rtol = atol = 2e-5 (`tests/test_torch_relbias.py`'s
FWD_TOL), gradients within 2e-5 of each one's largest entry (float32 sums in
other orders), bfloat16 within 2^-6 of the largest entry (a sum in another
order now and then rounds to the neighbouring bfloat16); the encoders as
`tests/test_torch_research.py`'s (2e-4).
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from generative_recommenders_tpu.models import hstu as j_hstu
from generative_recommenders_tpu.ops.pallas import hstu_attention as pallas_attn
from generative_recommenders_tpu.ops.pallas.hstu_attention_relbias import (
    hstu_mha_dense_pallas_relbias,
    relbias_pallas_supported,
)
from generative_recommenders_tpu_torch.convert import params_from_flax
from generative_recommenders_tpu_torch.models import hstu as t_hstu
from generative_recommenders_tpu_torch.ops.cuda import hstu_attention as ha
from generative_recommenders_tpu_torch.ops.cuda import hstu_attention_relbias as hr

SHARED = 232448  # a Hopper block's shared memory
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = 2e-5  # of each gradient's largest entry
BF16_TOL = 2.0**-6  # of each bfloat16 output's largest entry
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
MODEL_GRAD_TOL = 2e-4

# ------------------------------------------------------------ admission grid
GRID_H = (1, 2, 8)
GRID_N = (16, 512, 2048, 8192, 16384)
GRID_W = (8, 32, 64, 100, 128, 136, 192, 256, 264, 320, 512, 1024)
GRID_NB = (0, 128, 1024)


def _grid():
    """(H, N, D, V, Nm, NB): Nm the row's own N and the longest table, as a
    model with a long maximum length sees short and long batches."""
    for H, N, D, V, NB in itertools.product(GRID_H, GRID_N, GRID_W, GRID_W, GRID_NB):
        for Nm in sorted({N, 16384}):
            yield H, N, D, V, Nm, NB


def _pallas_admits(H, N, D, V):
    """Which of the JAX package's gates take the shape, on float32 and
    bfloat16 alike."""
    return [gate.__name__ for gate in (relbias_pallas_supported, pallas_attn._use_resident,
                                       pallas_attn._use_resident_bwd, pallas_attn.delta_pallas_supported)
            if any(gate(H, N, D, V, size) for size in (4, 2))]


def test_the_grid_holds_what_the_pallas_gates_admit():
    """Each gate admits shapes of the grid (the resident kernels), and the
    grid holds shapes past every gate (the 3-D-grid kernels, which take any
    width): both kinds must get a plan."""
    admitted = {gate: 0 for gate in ("relbias_pallas_supported", "_use_resident", "_use_resident_bwd",
                                     "delta_pallas_supported")}
    past = 0
    for H, N, D, V in itertools.product(GRID_H, GRID_N, GRID_W, GRID_W):
        gates = _pallas_admits(H, N, D, V)
        for gate in gates:
            admitted[gate] += 1
        past += not gates
    assert all(n > 0 for n in admitted.values()), admitted
    assert past > 0
    # shapes past the narrow CUDA tilings that the relative-bias gate admits are in it
    for H, N, D, V in ((2, 2048, 64, 64), (1, 8192, 32, 32), (8, 512, 128, 128), (1, 512, 256, 256)):
        assert relbias_pallas_supported(H, N, D, V, 4)
        assert H in GRID_H and N in GRID_N and D in GRID_W and V in GRID_W


@pytest.mark.parametrize("plan", ["fwd", "relbias fwd", "bwd", "dq", "delta", "relbias bwd", "relbias det"])
def test_every_shape_gets_a_plan_that_fits(plan):
    """Every launch plan admits every shape of the grid within a block's
    shared memory; the narrow tilings keep their widths (D up to 256 and V
    up to 128, or D and V up to 128 for K7), the rest take the wide bodies."""
    B = 8
    seen = set()
    for H, N, D, V, Nm, NB in _grid():
        if plan == "fwd":
            key = (H, N, D, V)
            got = [ha._fwd_plan(D, V, H, 0, 0, False, B, N)]
        elif plan == "relbias fwd":
            key = (H, N, D, V, Nm, NB)
            got = [ha._fwd_plan(D, V, H, Nm, NB, True, B, N)]
        elif plan == "bwd":
            key = (H, N, D, V)
            got = [ha._bwd_plan(D, V, H, B, N)]
            if got[0]["route"] == "wide":
                got.append(got[0]["dq"])
        elif plan == "dq":
            key = (H, N, D, V)
            got = [ha._dq_plan(D, V, H, B, N)]
        elif plan == "delta":
            key = (H, N, D, V)
            got = [ha._delta_plan(B, 5, N, H, V, D)]
        elif plan == "relbias bwd":
            key = (H, D, V, Nm, NB)
            got = [hr._relbias_bwd_plan(D, V, H, Nm, NB)]
        else:
            key = (H, N, D, V, Nm, NB)
            p = hr._relbias_det_plan(D, V, H, B, N, Nm, NB)
            # the wide bodies' dq pass beside their dkv pass; the narrow route has none
            got = [p] + ([dict(shared_bytes=p["dq_shared_bytes"])] if p["route"] == "wide" else [])
        if key in seen:
            continue
        seen.add(key)
        for p in got:
            assert 0 < p["shared_bytes"] <= SHARED, (plan, H, N, D, V, Nm, NB, p)
        narrow = max(D, V) <= 128 if plan.startswith("relbias b") or plan == "relbias det" else D <= 256 and V <= 128
        if plan != "delta":  # the wide bodies: on clusters, per chunk, or the float32 tile forward
            assert (got[0]["route"] in ("wide", "wide_chunks", "wide_tile")) == (not narrow), (plan, D, V, got[0])
    assert seen


def test_narrow_plans_keep_their_tilings():
    """The shapes the narrow tilings took before keep their plans: no table
    mode and no wide body where the tables fit and the widths are narrow."""
    assert ha._fwd_plan(32, 32, 8, 511, 128, True, 96, 511) == dict(
        ha._fwd_plan(32, 32, 8, 0, 0, False, 96, 511),
        shared_bytes=ha._fwd_plan(32, 32, 8, 0, 0, False, 96, 511)["shared_bytes"] + 4 * (1021 + 129 + 512))
    assert hr._relbias_bwd_plan(32, 32, 8, 511, 128) == dict(route="narrow", width=32, head_group=4, head_groups=2,
                                                             shared_bytes=195116)
    assert ha._bwd_plan(256, 128, 4, 32, 1036)["route"] == ha._dq_plan(128, 128, 4, 32, 1036)["route"] == "narrow"


@pytest.mark.parametrize(
    "H,N,D,Nm,NB",
    [(2, 2048, 64, 2048, 128), (1, 8192, 32, 8192, 128), (2, 4096, 32, 4096, 128), (8, 4096, 32, 4096, 128)],
)
def test_long_tables_are_read_where_staged_ones_do_not_fit(H, N, D, Nm, NB):
    """The shapes `relbias_pallas_supported` admits at which K7 once asked
    for more shared memory than a block has read the position table from
    device memory; chip_smoke.py's long-history shape (H 8, N = Nm = 4096,
    width 32) among them."""
    assert relbias_pallas_supported(H, N, D, D, 4) or H == 8
    plan = hr._relbias_bwd_plan(D, D, H, Nm, NB)
    assert plan["route"] == "read" and plan["shared_bytes"] <= SHARED
    det = hr._relbias_det_plan(D, D, H, 8, N, Nm, NB)
    assert det["route"] == "read" and det["shared_bytes"] <= SHARED
    # K7-det's partial buffer: one row of both tables per block; its dQ slots:
    # one per tile pair on and below the diagonal
    assert det["partial_shape"] == (det["grid"][0] * det["grid"][1] * det["grid"][2], 2 * Nm - 1 + NB + 1)
    tiles = -(-N // 64)
    assert det["dq_partial_shape"] == (8, tiles * (tiles + 1) // 2, 64, H, D)


def test_refusals_left():
    """A width of 0 and a grid past CUDA's limits are what still raise."""
    with pytest.raises(ValueError, match="at least 1"):
        ha._fwd_plan(0, 32, 2, 0, 0, False)
    with pytest.raises(ValueError, match="at least 1"):
        hr._relbias_bwd_plan(32, 0, 2, 100, 128)
    with pytest.raises(ValueError, match="grid"):
        ha._delta_plan(2, 8 * 10000, 100, 4, 256)
    with pytest.raises(ValueError, match="grid"):
        hr._relbias_det_plan(32, 32, 2, 70000, 100, 100, 128)


# ---------------------------------------------- plain versions against Pallas
def _close_to_max(got, want, tol, what):
    got = np.asarray(torch.as_tensor(got).detach().float(), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err:.2e} of the largest entry"


def _dense_inputs(seed, B, N, H, D, V, bf16):
    """q, k, v, dO (bfloat16-exact where ``bf16``), lengths with one full
    row and one short, targets."""
    rng = np.random.default_rng(seed)
    cast = (lambda a: np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))) if bf16 else (
        lambda a: a.astype(np.float32))
    q, k = (cast(rng.standard_normal((B, N, H, D)) * 0.5) for _ in range(2))
    v = cast(rng.standard_normal((B, N, H, V)) * 0.5)
    do = cast(rng.standard_normal((B, N, H, V)))
    lengths = np.array([N] + list(rng.integers(2, N, size=B - 1)), np.int32)
    nt = np.minimum(rng.integers(0, 3, size=B), lengths - 2).clip(0).astype(np.int32)
    return q, k, v, do, lengths, nt


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("D,V", [(8, 136), (320, 8)], ids=["V136", "D320"])
def test_dense_plain_matches_pallas_at_wide_heads(D, V, bf16):
    """K1's and K2's plain versions (the CPU paths of the wrappers) against
    `hstu_mha_dense_pallas` in interpret mode and its VJP at a V and a D the
    narrow CUDA tilings do not take (the Pallas kernels lane-pad them); K1-bias's
    in float32."""
    B, N, H = 2, 16, 1
    q, k, v, do, lengths, nt = _dense_inputs(31, B, N, H, D, V, bf16)
    kw = dict(alpha=D**-0.5, max_seq_len=N + 2, causal=True, contextual_seq_len=1)
    dt = jnp.bfloat16 if bf16 else jnp.float32
    j = lambda a: jnp.asarray(a, dt)  # noqa: E731

    def fwd(q_, k_, v_):
        return pallas_attn.hstu_mha_dense_pallas(q_, k_, v_, jnp.asarray(lengths), num_targets=jnp.asarray(nt),
                                                 block_q=128, block_k=128, interpret=True, **kw)

    want_out, vjp = jax.vjp(fwd, j(q), j(k), j(v))
    want = vjp(j(do))
    tdt = torch.bfloat16 if bf16 else torch.float32
    t = lambda a: torch.as_tensor(a).to(tdt)  # noqa: E731
    tkw = dict(kw, num_targets=torch.as_tensor(nt))
    got_out = ha.hstu_mha_dense_cuda(t(q), t(k), t(v), torch.as_tensor(lengths), **tkw)
    grads = ha.hstu_mha_bwd_cuda(t(q), t(k), t(v), torch.as_tensor(lengths), t(do), **tkw)
    if bf16:
        _close_to_max(got_out, want_out, BF16_TOL, "out")
    else:
        np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), **FWD_TOL)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want, strict=True):
        assert g.dtype == tdt
        _close_to_max(g, w, BF16_TOL if bf16 else GRAD_TOL, name)
    if not bf16:
        bias = (np.random.default_rng(32).standard_normal((B, N, N)) * 0.3).astype(np.float32)
        want_b = pallas_attn.hstu_mha_dense_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths), bias=jnp.asarray(bias),
            num_targets=jnp.asarray(nt), block_q=8, block_k=8, interpret=True, **kw)
        got_b = ha.hstu_mha_dense_cuda(t(q), t(k), t(v), torch.as_tensor(lengths), bias=torch.as_tensor(bias), **tkw)
        np.testing.assert_allclose(got_b.detach().numpy(), np.asarray(want_b), **FWD_TOL)


def test_delta_plain_matches_pallas_at_v192():
    """K5's plain version against `delta_hstu_mha_pallas` in interpret mode
    at V 192 (two of the kernel's V chunks) over three key chunks."""
    rng = np.random.default_rng(33)
    B, M, N, H, D, V = 2, 3, 150, 2, 16, 192
    q = (rng.standard_normal((B, M, H, D)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, N, H, D)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B, N, H, V)) * 0.5).astype(np.float32)
    lengths = np.array([N, 97], np.int32)
    kw = dict(alpha=0.6, norm_len=N + 3)
    want = pallas_attn.delta_hstu_mha_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
                                             block_k=8, interpret=True, **kw)
    got = ha.delta_hstu_mha_cuda(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                                 torch.as_tensor(lengths), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def _relbias_case(seed, B, N, H, D, Nm, nb=128):
    rng = np.random.default_rng(seed)
    q, k, v = ((rng.standard_normal((B, N, H, D)) * 0.3).astype(np.float32) for _ in range(3))
    do = rng.standard_normal((B, N, H, D)).astype(np.float32)
    lengths = np.array([N] + list(rng.integers(1, N, size=B - 1)), np.int32)
    ts = (1_600_000_000 + np.cumsum(rng.integers(1, 90000, size=(B, N)), axis=1)).astype(np.int64)
    pos_w = (rng.standard_normal(2 * Nm - 1) * 0.05).astype(np.float32)
    ts_w = (rng.standard_normal(nb + 1) * 0.05).astype(np.float32)
    return q, k, v, do, lengths, ts, pos_w, ts_w


@pytest.mark.parametrize("B,N,H,D,Nm", [(2, 16, 1, 128, 16), (2, 16, 1, 32, 2848)], ids=["D=V=128", "Nm 2848"])
def test_relbias_plain_matches_pallas(B, N, H, D, Nm):
    """K6's and K7's plain versions against `hstu_mha_dense_pallas_relbias`
    in interpret mode and `jax.grad` through it (q, k, v and both tables)
    at heads of 128 and with a position table of 2 * 2848 - 1 entries on a
    batch of N 16 (at width 32 the smallest table K7's staged tiling cannot hold)."""
    q, k, v, do, lengths, ts, pos_w, ts_w = _relbias_case(34, B, N, H, D, Nm)
    kw = dict(alpha=D**-0.5, max_seq_len=N, num_buckets=128)

    def loss(q_, k_, v_, p_, t_):
        out = hstu_mha_dense_pallas_relbias(q_, k_, v_, jnp.asarray(lengths), jnp.asarray(ts), p_, t_,
                                            block_q=128, block_k=128, interpret=True, **kw)
        return jnp.sum(out * jnp.asarray(do)), out

    (_, want_out), want = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *map(jnp.asarray, (q, k, v, pos_w, ts_w)))
    t = torch.as_tensor
    got_out = hr.hstu_mha_dense_relbias_cuda(t(q), t(k), t(v), t(lengths), t(ts), t(pos_w), t(ts_w), **kw)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), **FWD_TOL)
    got = hr.hstu_mha_relbias_bwd_cuda(t(q), t(k), t(v), t(lengths), t(ts), t(pos_w), t(ts_w), t(do), **kw)
    for name, g, w in zip(("dq", "dk", "dv", "dpos_w", "dts_w"), got, want, strict=True):
        _close_to_max(g, w, GRAD_TOL, name)


# ------------------------------------------------------------------ encoders
@pytest.mark.parametrize(
    "heads,width,Nm",
    [(2, 8, 2848), (2, 128, 40)],
    ids=["position table of 2848 rows", "two heads of 128"],
)
def test_encoder_matches_jax(heads, width, Nm):
    """`HSTUEncoder` with the relative bias against the JAX package's on
    the same weights, its relative-bias Pallas path (interpret mode): the
    output on every row, and the gradients of every parameter of a weighted
    sum of it."""
    B, N, E = 3, 24, 2 * width if width > 8 else 16
    rng = np.random.default_rng(35)
    x = (rng.standard_normal((B, N, E)) * 0.3).astype(np.float32)
    lengths = np.array([N, 9, 17], np.int32)
    ts = 1_600_000_000 + np.cumsum(rng.integers(1, 90000, size=(B, N)), axis=1)
    w = rng.standard_normal((B, N, E)).astype(np.float32)
    kw = dict(embedding_dim=E, num_blocks=2, num_heads=heads, attention_dim=width, linear_dim=width,
              linear_dropout_rate=0.0, max_total_seq_len=Nm)
    je = j_hstu.HSTUEncoder(attn_kernel="pallas", **kw)
    params = je.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(lengths), jnp.asarray(ts), True)

    def j_loss(p):
        out = je.apply(p, jnp.asarray(x), jnp.asarray(lengths), jnp.asarray(ts), True)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, want), want_g = jax.value_and_grad(j_loss, has_aux=True)(params)
    te = t_hstu.HSTUEncoder(**kw, gen=torch.Generator().manual_seed(0))
    te.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    got = te(torch.as_tensor(x), torch.as_tensor(lengths), torch.as_tensor(ts), deterministic=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **MODEL_TOL)
    (got * torch.as_tensor(w)).sum().backward()
    want_g = params_from_flax(jax.tree_util.tree_map(np.asarray, want_g))
    for name, p in te.named_parameters():
        _close_to_max(p.grad, want_g[name].numpy(), MODEL_GRAD_TOL, name)
