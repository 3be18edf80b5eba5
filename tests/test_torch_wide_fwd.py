"""The wide forward's routes, and the wide backward's widths past 16 blocks
of two chunks, on the CPU.

* `_fwd_plan`'s wide branch (K1-, K1-bias- and K6-wide). Float32 K1 and
  K1-bias at V of 129 to 256 with D up to 256, and V up to 384 with D up to
  128, take the tile forward (route ``wide_tile``,
  csrc/hstu_attention_wide.cuh's `tile_fwd_kernel`): one block of 8 warps
  per (64-row query tile, head, batch row), its shared memory
  `hstu_wide::tile_smem_bytes` within a Hopper block's 232,448 bytes.
  Elsewhere, and on bfloat16 and with the relative bias everywhere, the
  clusters (`fwd_kernel`): one thread block cluster per (64-row query tile,
  head, batch row), a block per 128-column chunk of V or per two of D,
  whichever needs more (16 at most); block r owns D's columns [r d_cols, (r
  + 1) d_cols) and V's [r v_cols, (r + 1) v_cols), each share rounded up to
  32, in tiles of up to 128 (3 tiles a block at most); each block's shared
  memory within 232,448 bytes on both types, with and without a bias (the
  bias is read into registers); past 3 tiles a block, the per-chunk forward
  (route ``wide_chunks``); a grid past CUDA's limit raises with its sizes.
  The Python mirror of the clusters' and the tile forward's rules, of their
  constants and of their blocks' bytes against the C header.
* The port's plain backward (the function the card holds the wide
  backward's per-chunk route to) against the JAX package's
  `hstu_mha_dense_pallas` in interpret mode and its VJP at D 3968 / V 128,
  31 + 1 chunks (B 1, H 1, N 40, float32): the output within rtol = atol =
  2e-5, each gradient within 2e-5 of its largest entry (float32 sums in
  other orders), `tests/test_torch_shapes.py`'s tolerances.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from generative_recommenders_tpu.ops.pallas import hstu_attention as pallas_attn
from generative_recommenders_tpu_torch.ops.cuda import build
from generative_recommenders_tpu_torch.ops.cuda import hstu_attention as ha

SHARED = 232448  # a Hopper block's shared memory
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = 2e-5  # of each gradient's largest entry
TYPES = [torch.float32, torch.bfloat16]


def _header() -> str:
    with open(os.path.join(build.CSRC_DIR, "hstu_attention_wide.cuh")) as f:
        return f.read()


def _chunks(w):
    return -(-w // 128)


def _bytes(dw, vw, md, mv, elem, split=False):
    """A block's shared memory from the kernel's layout: Q and two stages of K
    and of V of the element type at their pitches, the float32 exchange
    buffers [2][64][40], split the P tile [64][40] of the element type (else
    in the exchange buffers), 8 live flags."""
    pd, pv = min(dw, 128) + 8, min(vw, 128) + 8
    return elem * (md * 64 * pd + 2 * md * 32 * pd + 2 * mv * 32 * pv + (64 * 40 if split else 0)) + 4 * (
        2 * 64 * 40 + 8)

# (D, V): (blocks, D columns a block, V columns a block, D tiles, V tiles)
ISSUE_SHAPES = {
    (128, 256): (2, 64, 128, 1, 1),     # the V-256 layer: D's one chunk split in halves
    (64, 256): (2, 32, 128, 1, 1),
    (512, 64): (2, 256, 32, 2, 1),      # D's 4 chunks two a block; V's one chunk in 32-column slices
    (256, 256): (2, 128, 128, 1, 1),
    (3968, 128): (16, 256, 32, 2, 1),   # 31 chunks of D in 16 blocks of two tiles
    (2048, 2049): (16, 128, 160, 1, 2),  # 17 chunks of V: 160 columns a block in two tiles
}


# the shapes above where float32 K1 and K1-bias take the tile forward
# (`_fwd_tile`), measured faster there than the clusters
TILE_F32 = {(128, 256), (64, 256), (256, 256)}


def _tile_bytes(D, V):
    """The tile forward's block's shared memory from the kernel's layout: two
    stages of K [32][Dp + 8] and of V [32][Vp + 4] float32, the exchange
    [8][32][16] float32, and at Dp past 128 Q [64][Dp + 8] float32 (Dp, Vp:
    D, V rounded up to 32)."""
    dp, vp = -(-D // 32) * 32, -(-V // 32) * 32
    return 4 * 2 * 32 * (dp + 8 + vp + 4) + 4 * 256 * 16 + (4 * 64 * (dp + 8) if dp > 128 else 0)


@pytest.mark.parametrize("dtype", TYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("D,V", list(ISSUE_SHAPES))
def test_fwd_plan_is_one_cluster_per_tile(D, V, dtype):
    """The cluster, each block's columns and tiles, the grid and the shared
    memory of K1, K1-bias and K6 (the relative bias) at the slice's shapes,
    both types; float32 K1 and K1-bias at `TILE_F32` the tile forward's: a
    block per (query tile, head, batch row)."""
    B, H, N = 4, 2, 1000
    cs, dw, vw, md, mv = ISSUE_SHAPES[D, V]
    split = cs >= 4
    assert ha._wide_fwd_cluster(D, V) == (cs, dw, vw, md, mv)
    for relbias, Nm, NB in ((False, 0, 0), (True, 4096, 128)):
        plan = ha._fwd_plan(D, V, H, Nm, NB, relbias, B, N, dtype)
        if (D, V) in TILE_F32 and dtype == torch.float32 and not relbias:
            assert plan["route"] == "wide_tile" and plan["grid"] == (-(-N // 64) * H * B,)
            assert plan["shared_bytes"] == _tile_bytes(D, V) <= SHARED
            continue
        assert plan["route"] == "wide"
        assert (plan["cluster"], plan["d_cols"], plan["v_cols"], plan["d_tiles"], plan["v_tiles"]) == (cs, dw, vw, md, mv)
        assert plan["split_work"] == split
        assert plan["grid"] == (-(-N // 64) * H * B * cs,)
        assert plan["shared_bytes"] == _bytes(dw, vw, md, mv, dtype.itemsize, split) <= SHARED
        assert cs * dw >= D and cs * vw >= V  # every column of D and of V has its block


@pytest.mark.parametrize("D,V", [(8192, 64), (64, 8192), (4096, 4096), (3000, 3000), (4352, 64)])
def test_fwd_past_the_clusters_takes_the_per_chunk_body(D, V):
    """Where a block would hold more than 3 tiles of 128 columns, the
    per-chunk forward: a block of 4 warps per (64-row query tile, head,
    batch row, V chunk), float32 tiles on either type."""
    assert ha._wide_fwd_cluster(D, V) is None
    for dtype in TYPES:
        plan = ha._fwd_plan(D, V, 2, 0, 0, False, 4, 300, dtype)
        assert plan["route"] == "wide_chunks"
        assert plan["grid"] == (5 * 2 * 4 * _chunks(V),)
        assert plan["shared_bytes"] == 4 * (64 * 136 + 32 * 136 + 32 * 132) <= SHARED


# (D, V, B, N, H, bias): whether float32 takes the tile forward (the
# per-chunk body's float32 shapes before it); the measured shapes (the
# V-256 ranker's layer, the --attn_dim 256 serving layer, B 4 / N 2048 /
# H 2) and the rule's edges, whatever the grid, with and without the bias
PER_CHUNK_CASES = {
    (128, 256, 32, 268, 4, False): True, (128, 256, 32, 268, 4, True): True,
    (256, 256, 32, 674, 4, False): True, (256, 256, 32, 674, 4, True): True,
    (128, 256, 4, 2048, 2, False): True, (256, 256, 4, 2048, 2, False): True,
    (128, 384, 4, 2048, 2, False): True, (128, 384, 4, 2048, 2, True): True,
    (256, 384, 32, 2048, 4, False): False, (64, 256, 32, 2048, 4, False): True,
    (65, 129, 1, 64, 1, False): True, (129, 129, 16, 4096, 1, False): True,
    (129, 129, 16, 4032, 1, False): True, (257, 256, 32, 2048, 4, False): False,
    (128, 640, 4, 2048, 2, False): False, (512, 64, 32, 2048, 4, False): False,
}


@pytest.mark.parametrize("D,V,B,N,H,bias", list(PER_CHUNK_CASES))
def test_fwd_per_chunk_where_measured_faster(D, V, B, N, H, bias):
    """Float32 K1 and K1-bias (the bias plans as K1) take the tile forward,
    measured faster than the per-chunk body and the clusters wherever it
    takes the widths, on every grid: V of 129 to 256 with D up to 256, V up
    to 384 with D up to 128; the clusters elsewhere. bfloat16 and K6 keep
    the clusters at every width a cluster takes."""
    tile = PER_CHUNK_CASES[D, V, B, N, H, bias]
    assert ha._wide_fwd_cluster(D, V) is not None
    plan = ha._fwd_plan(D, V, H, 0, 0, False, B, N)
    assert plan["route"] == ("wide_tile" if tile else "wide")
    if tile:
        assert plan["grid"] == (-(-N // 64) * H * B,)
        assert plan["shared_bytes"] == _tile_bytes(D, V) <= SHARED
    assert ha._fwd_plan(D, V, H, 0, 0, False, B, N, torch.bfloat16)["route"] == "wide"
    assert ha._fwd_plan(D, V, H, 1024, 128, True, B, N)["route"] == "wide"


# the tile forward at D 65 to 256 and V 129 to 384 (the two main-path
# layers' widths among them): it takes V up to 256, and to 384 at D up to
# 128
TILE_D, TILE_V = (65, 128, 129, 192, 256), (129, 256, 384)


@pytest.mark.parametrize("V", TILE_V)
@pytest.mark.parametrize("D", TILE_D)
def test_fwd_tile_route_grid_and_bytes(D, V):
    """Float32 K1 and K1-bias: the tile forward's route where it takes the
    widths, a block per (64-row query tile, head, batch row), its shared
    memory from the kernel's layout; the clusters where it does not;
    bfloat16 and K6 on the clusters either way."""
    tile = V <= 256 or D <= 128
    for B, N, H in ((32, 674, 4), (32, 268, 4), (1, 65, 1)):
        plan = ha._fwd_plan(D, V, H, 0, 0, False, B, N)
        assert plan["route"] == ("wide_tile" if tile else "wide")
        if tile:
            assert plan["grid"] == (-(-N // 64) * H * B,) and (plan["query_rows"], plan["key_tile"]) == (64, 32)
            assert (plan["d_cols"], plan["v_cols"]) == (-(-D // 32) * 32, -(-V // 32) * 32)
            assert plan["shared_bytes"] == _tile_bytes(D, V) <= SHARED
        assert ha._fwd_plan(D, V, H, 0, 0, False, B, N, torch.bfloat16)["route"] == "wide"
        assert ha._fwd_plan(D, V, H, 1024, 128, True, B, N)["route"] == "wide"


def test_fwd_tile_mirrors_the_header():
    """The tile forward's constants, its rule and its block's bytes are the C
    header's, and every block it takes fits 232,448 bytes."""
    text = _header()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert (const("kTileRows"), const("kTileStep"), const("kTileMaxD"), const("kTileMaxV")) == (
        ha._TILE_ROWS, ha._TILE_STEP, ha._TILE_MAX_D, ha._TILE_MAX_V) == (64, 32, 256, 384)
    assert "return (w + 31) / 32 * 32;" in text  # tile_width
    body = re.search(r"constexpr int tile_smem_bytes\(int D, int V\) \{(.*?)\n\}", text, re.S).group(1)
    assert "4 * 2 * kTileStep * (tile_width(D) + 8 + tile_width(V) + 4) + 16 * kBwdThreads * kTileNs" in body
    assert "(tile_width(D) > 128 ? 4 * kTileRows * (tile_width(D) + 8) : 0)" in body
    assert "return D <= kTileMaxD && V <= kTileMaxV && (D <= 128 || V <= 256);" in text  # tile_takes
    assert re.search(r"__launch_bounds__\(kBwdThreads, 1\) tile_fwd_kernel", text)
    for D in range(1, 300, 7):
        for V in range(120, 400, 11):
            takes = D <= 256 and V <= 384 and (D <= 128 or V <= 256)
            assert ha._fwd_tile(D, V, False, torch.float32) == (takes and V > 128)
            if takes:
                assert ha._tile_bytes(D, V) == _tile_bytes(D, V) <= SHARED


def test_fwd_plan_bytes_stay_within_a_block():
    """Every cluster plan over a grid of widths fits a block's shared memory on
    both types; the float32 block of two D tiles and a full V tile is the
    largest."""
    most = 0
    for D in range(1, 4200, 97):
        for V in range(1, 4200, 89):
            if max(D, V) <= 128 or ha._wide_fwd_cluster(D, V) is None:
                continue
            for dtype in TYPES:
                plan = ha._fwd_plan(max(D, 257) if V <= 128 else D, V, 2, 0, 0, False, 4, 300, dtype)
                if plan["route"] == "wide":
                    assert 0 < plan["shared_bytes"] <= SHARED
                    most = max(most, plan["shared_bytes"])
    assert most <= _bytes(256, 128, 2, 1, 4, True) <= SHARED


def test_fwd_grid_past_cuda_raises_with_its_sizes():
    with pytest.raises(ValueError, match=r"wide forward kernel \(clusters of 2 blocks\)'s grid of \d+ blocks exceeds"):
        ha._fwd_plan(512, 64, 2**16, 0, 0, False, 2**9, 2**11)
    with pytest.raises(ValueError, match=r"per-chunk wide forward kernel's grid"):
        ha._fwd_plan(8192, 8192, 2**16, 0, 0, False, 2**9, 2**10)


@pytest.mark.parametrize("D", [1, 64, 129, 640, 1100, 2048, 3968, 4096, 5000])
@pytest.mark.parametrize("V", [1, 128, 256, 700, 2049, 4096])
def test_fwd_cluster_matches_the_c_rule(D, V):
    """`_wide_fwd_cluster` against a Python transcription of
    `fwd_cluster_of` read from the header."""
    body = re.search(r"inline FwdCluster fwd_cluster_of\(int D, int V\) \{(.*?)\n\}", _header(), re.S).group(1)
    assert "const int cs = min(kMaxCluster, max((chunks(D) + 1) / 2, chunks(V)));" in body
    assert "const int dw = ((D + cs - 1) / cs + 31) / 32 * 32, vw = ((V + cs - 1) / cs + 31) / 32 * 32;" in body
    assert "if (md > kMaxOwn || mv > kMaxOwn || md + mv > kFwdMaxTiles) return {0, 0, 0, 0, 0, 0};" in body
    assert "cs >= kFwdSplitFrom ? 1 : 0" in body
    cs = min(16, max(-(-_chunks(D) // 2), _chunks(V)))
    dw, vw = (-(-(-(-w // cs)) // 32) * 32 for w in (D, V))
    md, mv = _chunks(dw), _chunks(vw)
    want = None if md > 2 or mv > 2 or md + mv > 3 else (cs, dw, vw, md, mv)
    assert ha._wide_fwd_cluster(D, V) == want


def test_fwd_python_mirrors_the_header():
    """The plan's constants and the block's bytes are the C header's."""
    text = _header()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+)", text).group(1))

    assert const("kFwdSplitFrom") == ha._WIDE_FWD_SPLIT_FROM
    assert const("kFwdMaxTiles") == ha._WIDE_FWD_MAX_TILES
    assert "return (w < kC ? w : kC) + 8;" in text  # fwd_pitch
    body = re.search(r"inline int fwd_smem_bytes\(int elem, const FwdCluster& c\) \{(.*?)\n\}", text, re.S).group(1)
    assert "elem * (c.md * kR * pd + 2 * c.md * kS * pd + 2 * c.mv * kS * pv + (c.split ? kR * kXP : 0))" in body
    assert "4 * (kXchFloats + kBwdThreads / 32)" in body
    assert re.search(r"__launch_bounds__\(kBwdThreads, MV == 1 \? 2 : 1\) fwd_kernel", text)
    for dw, vw, md, mv, split in ((64, 128, 1, 1, False), (256, 32, 2, 1, True), (128, 160, 1, 2, True)):
        assert ha._wide_fwd_bytes(dw, vw, md, mv, 4, split) == _bytes(dw, vw, md, mv, 4, split)


def _close_to_max(got, want, tol, what):
    got = np.asarray(torch.as_tensor(got).detach().float(), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err:.2e} of the largest entry"


def test_plain_backward_matches_pallas_at_d3968():
    """The plain forward and backward (what the wrappers compute on CPU
    tensors, and what the card holds the per-chunk route to) against
    `hstu_mha_dense_pallas` in interpret mode and its VJP at D 3968 / V 128."""
    rng = np.random.default_rng(21)
    B, N, H, D, V = 1, 40, 1, 3968, 128
    q, k = ((rng.standard_normal((B, N, H, D)) * 0.1).astype(np.float32) for _ in range(2))
    v = (rng.standard_normal((B, N, H, V)) * 0.5).astype(np.float32)
    do = rng.standard_normal((B, N, H, V)).astype(np.float32)
    lengths = np.array([N], np.int32)
    kw = dict(alpha=D**-0.5, max_seq_len=N, causal=True, contextual_seq_len=2)

    def fwd(q_, k_, v_):
        return pallas_attn.hstu_mha_dense_pallas(q_, k_, v_, jnp.asarray(lengths), block_q=128, block_k=128,
                                                 interpret=True, **kw)

    want_out, vjp = jax.vjp(fwd, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    t = torch.as_tensor
    np.testing.assert_allclose(ha.hstu_mha_dense_cuda(t(q), t(k), t(v), t(lengths), **kw).detach().numpy(),
                               np.asarray(want_out), **FWD_TOL)
    for split in (False, True):
        got = ha.hstu_mha_bwd_cuda(t(q), t(k), t(v), t(lengths), t(do), split=split, **kw)
        for name, g, w in zip(("dq", "dk", "dv"), got, want, strict=True):
            _close_to_max(g, w, GRAD_TOL, name)
