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
  bias is read into registers); past 3 tiles a block, the per-pair forward
  (route ``wide_chunks``: S once per 64 x 64 tile pair into a float32
  scratch, then O = P V a block per query tile and V chunk), its (batch row,
  head) slabs in groups under the scratch's cap; a grid past CUDA's limit
  raises with its sizes. The Python mirror of the clusters', the tile
  forward's and the per-pair forward's rules, of their constants and of
  their blocks' bytes and scratch against the C header.
* The port's plain backward (the function the card holds the wide
  backward's per-pair route to) against the JAX package's
  `hstu_mha_dense_pallas` in interpret mode and its VJP at D 3968 / V 128,
  31 + 1 chunks (B 1, H 1, N 40, float32): the output within rtol = atol =
  2e-5, each gradient within 2e-5 of its largest entry (float32 sums in
  other orders), `tests/test_torch_shapes.py`'s tolerances.
* The port's plain forward (the function the card holds the per-pair
  forward to), K1 and K6, against the JAX package's `hstu_mha_dense_pallas`
  and `hstu_mha_dense_pallas_relbias` in interpret mode at the per-pair
  forward's widths D 4352 / V 64 and D 128 / V 4352 (B 2, H 1, N 40,
  float32, targets and a contextual row): within rtol = atol = 2e-5.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from generative_recommenders_tpu.ops.pallas import hstu_attention as pallas_attn
from generative_recommenders_tpu.ops.pallas.hstu_attention_relbias import hstu_mha_dense_pallas_relbias
from generative_recommenders_tpu_torch.ops.cuda import build
from generative_recommenders_tpu_torch.ops.cuda import hstu_attention as ha
from generative_recommenders_tpu_torch.ops.cuda import hstu_attention_relbias as hr

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


def _fwd_pairs_bytes(group, qt, splits):
    """A group's forward scratch (as `hstu_wide::Pairs` lays it out with
    kFwdMats tiles a pair): P of every pair, the pairs' flags padded to 4,
    the splits' partial S."""
    tiles = group * qt * qt
    return 4 * (tiles * 4096 + -(-tiles // 4) * 4 + (splits * tiles * 4096 if splits > 1 else 0))


@pytest.mark.parametrize("D,V", [(8192, 64), (64, 8192), (4096, 4096), (3000, 3000), (4352, 64)])
def test_fwd_past_the_clusters_takes_the_per_chunk_body(D, V):
    """Where a block would hold more than 3 tiles of 128 columns, the
    per-pair forward (route ``wide_chunks``), both types, with and without
    the relative bias: the S pass a block per (64 x 64 tile pair, split,
    slab), 3 stages of two [64][72] tiles of q's type, its 64-column steps of
    D split 2 ways where the group's 200 pairs give fewer than 264 blocks;
    the P V pass a block per (64-row query tile, 128-column V chunk, slab),
    two stages of a float32 [64][72] P tile and a [64][136] V chunk; the
    float32 scratch of P, the flags and the splits' partial S; one group;
    no pre-scaling pass (alpha q is rounded as Q's fragments are read)."""
    assert ha._wide_fwd_cluster(D, V) is None
    B, H, N, qt = 4, 2, 300, 5
    steps = -(-D // 64)
    group, pairs = B * H, B * H * qt * qt
    want = min(-(-264 // pairs), steps // 4)
    splits = 1 if want <= 1 else -(-steps // -(-steps // want))
    for dtype in TYPES:
        elem = dtype.itemsize
        for relbias, Nm, NB in ((False, 0, 0), (True, 4096, 128)):
            plan = ha._fwd_plan(D, V, H, Nm, NB, relbias, B, N, dtype)
            assert plan["route"] == "wide_chunks"
            assert (plan["groups"], plan["group_slabs"], plan["splits"]) == (1, group, splits)
            assert splits == (1 if D == 64 else 2)
            assert plan["sdp_grid"] == (pairs * splits,)
            assert plan["sums_grid"] == ((pairs,) if splits > 1 else None)
            assert plan["grid"] == (group * qt * _chunks(V),) and plan["output_chunks"] == _chunks(V)
            assert plan["sdp_shared_bytes"] == 3 * 2 * 64 * 72 * elem <= SHARED
            assert plan["shared_bytes"] == 2 * (4 * 64 * 72 + elem * 64 * 136) <= SHARED
            assert plan["scratch_shape"] == (_fwd_pairs_bytes(group, qt, splits) // 4,)
            assert not any(k.startswith(("prescale", "q_scaled", "do_scaled", "table")) for k in plan)


@pytest.mark.parametrize("case", ["past the cap", "one slab past the cap", "the ranker's forward layer", "few pairs"])
def test_fwd_per_pair_scratch_goes_in_groups_under_the_cap(case):
    """The per-pair forward's (batch row, head) slabs run in groups whose P
    and flags stay under `_PAIR_SCRATCH_CAP` (256 MiB), each group in turn on
    one scratch: B 8, H 8, N 4096 at D 4352 / V 64 in 22 groups of 3 slabs
    (67 MB of P a slab, where the backward's P and dS take one a group); a
    slab larger than the cap (N 8192) a group of its own; the widest-heads
    ranker's forward layer (B 8, N 268, H 4) one group of 800 pairs,
    unsplit; B 1, H 1, N 300 one group of 25 pairs whose 68 steps split 10
    ways (264 blocks aimed at). K1's and K6's plans agree on both types;
    every grid of a group within CUDA's limit."""
    cap = ha._PAIR_SCRATCH_CAP
    assert cap == 256 * 2**20
    B, N, H, groups, splits = {"past the cap": (8, 4096, 8, 22, 1), "one slab past the cap": (1, 8192, 2, 2, 1),
                               "the ranker's forward layer": (8, 268, 4, 1, 1), "few pairs": (1, 300, 1, 1, 10)}[case]
    D, V, qt = 4352, 64, -(-N // 64)
    plans = [ha._fwd_plan(D, V, H, Nm, 128, rel, B, N, dtype)
             for rel, Nm in ((False, 0), (True, N)) for dtype in TYPES]
    for plan in plans:
        assert (plan["route"], plan["groups"], plan["splits"]) == ("wide_chunks", groups, splits)
        group = plan["group_slabs"]
        assert -(-(B * H) // group) == groups
        own = _fwd_pairs_bytes(group, qt, 1)
        assert own <= cap or group == 1  # under the cap, or a slab past it alone
        assert group == B * H or _fwd_pairs_bytes(group + 1, qt, 1) > cap  # as many slabs as fit
        assert plan["scratch_shape"] == (_fwd_pairs_bytes(group, qt, splits) // 4,)
        assert max(plan["sdp_grid"][0], plan["grid"][0]) < 2**31
    if case == "past the cap":
        assert plans[0]["group_slabs"] == 3 and _fwd_pairs_bytes(3, qt, 1) < cap < _fwd_pairs_bytes(4, qt, 1)
    if case == "one slab past the cap":
        assert _fwd_pairs_bytes(1, qt, 1) > cap
    if case == "the ranker's forward layer":
        assert plans[0]["group_slabs"] == 32 and plans[0]["sdp_grid"] == (800,)
        assert _fwd_pairs_bytes(32, qt, 1) < 50 * 10**6  # within the L2
    if case == "few pairs":
        assert plans[0]["sdp_grid"] == (250,) and plans[0]["sums_grid"] == (25,)


@pytest.mark.parametrize("D", [64, 128, 192, 256, 320, 512, 1000, 4352])
def test_fwd_split_runs_take_four_steps(D):
    """The S pass's 64-column steps of D split across blocks only where a run
    keeps 4 steps or more (`_SPLIT_MIN_STEPS`; every run but the last), at
    B 1, H 1, N 300 (25 pairs, 264 blocks aimed at) and V 4352: D 128 (2
    steps) unsplit, D 4352 (68 steps) in 10 runs of 7; the backward's
    splits, with V's steps too, unchanged by the rule at these widths."""
    assert ha._SPLIT_MIN_STEPS == 4
    steps = -(-D // 64)
    plan = ha._fwd_plan(D, 4352, 1, 0, 0, False, 1, 300)
    assert plan["route"] == "wide_chunks"
    splits = plan["splits"]
    per = -(-steps // splits)
    assert splits == 1 or (per >= 4 and (splits - 1) * per < steps)
    assert (splits == 1) == (steps < 8)
    assert splits == {128: 1, 4352: 10}.get(D, splits)
    assert plan["sums_grid"] == ((25,) if splits > 1 else None) and plan["sdp_grid"] == (25 * splits,)
    both = steps + 68  # the backward's steps of D and V: 11 runs, as before the rule
    assert ha._bwd_plan(D, 4352, 1, 1, 300)["splits"] == -(-both // -(-both // 11))


def test_fwd_pairs_mirror_the_header():
    """The per-pair forward's scratch layout, its steps and its launch are the
    C header's: one [64][64] float32 tile a pair (the backward's two), the
    flags after the tiles and the splits' parts after the flags, D's steps
    alone, a grid per group of (pair, split), pairs and (query tile, V
    chunk) blocks; the entry points pass the scratch and the plan's ints."""
    text = _header()
    assert re.search(r"constexpr int kFwdMats = (\d+), kBwdMats = (\d+);", text).groups() == (
        str(ha._FWD_MATS), str(ha._BWD_MATS)) == ("1", "2")
    assert "return reinterpret_cast<int*>(w.scratch + w.mats * w.tiles * kPairFloats);" in text  # pair_flags
    assert ("return w.scratch + w.mats * w.tiles * kPairFloats + (w.tiles + 3) / 4 * 4 +\n"
            "         ((long long)sp * w.tiles + tile) * w.mats * kPairFloats;") in text  # pair_part
    assert "return (D + kPK - 1) / kPK + (fwd ? 0 : (V + kPK - 1) / kPK);" in text  # sdp_steps
    body = re.search(r"cudaError_t launch_fwd_pairs\(Params<E> p, cudaStream_t stream\) \{(.*?)\n\}", text,
                     re.S).group(1)
    assert "w.mats = kFwdMats;" in body and "w.per = (sdp_steps(p.D, p.V, true) + p.splits - 1) / p.splits;" in body
    assert "{pairs * w.splits, pairs, (long long)slabs * w.qt * chunks(p.V)}" in body
    assert "grad_kernel<true, false, true, E, E>" in body
    with open(os.path.join(build.CSRC_DIR, "hstu_attention_fwd.cuh")) as f:
        fwd = f.read()
    assert "if (route == hstu::kWideChunks) return (int)hstu_wide::launch_fwd_pairs<WB, E>(w, stream);" in fwd
    assert "fwd_chunks" not in text + fwd


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
    # past the clusters the slabs go in groups: the grid that raised on the
    # per-chunk body (2^9 batch rows, 2^16 heads, N 1024) fits; one slab of
    # 2^22 rows has more pairs than a grid takes
    assert ha._fwd_plan(8192, 8192, 2**16, 0, 0, False, 2**9, 2**10)["groups"] > 1
    with pytest.raises(ValueError, match=r"per-pair wide forward kernel's grid of \d+ blocks exceeds"):
        ha._fwd_plan(8192, 64, 1, 0, 0, False, 1, 2**22)


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


FWD_CASES = {"D 4352 / V 64": (4352, 64), "D 128 / V 4352": (128, 4352)}


@pytest.mark.parametrize("kernel", ["K1", "K6"])
@pytest.mark.parametrize("case", list(FWD_CASES))
def test_plain_forward_matches_pallas_past_the_clusters(case, kernel):
    """The port's plain forward (what the wrappers compute on CPU tensors, and
    what the card holds the per-pair forward to) against the JAX package's
    Pallas forward in interpret mode at the per-pair route's widths, with
    targets and a contextual row: K1 (`hstu_mha_dense_pallas`) and K6
    (`hstu_mha_dense_pallas_relbias`, 128 buckets), float32, rtol = atol =
    2e-5; the port's plan takes the per-pair route there."""
    D, V = FWD_CASES[case]
    rng = np.random.default_rng(24)
    B, N, H = 2, 40, 1
    q, k = ((rng.standard_normal((B, N, H, D)) * 0.1).astype(np.float32) for _ in range(2))
    v = (rng.standard_normal((B, N, H, V)) * 0.5).astype(np.float32)
    lengths, nt = np.array([N, 29], np.int32), np.array([3, 2], np.int32)
    kw = dict(alpha=D**-0.5, max_seq_len=N, causal=True, contextual_seq_len=2)
    t = torch.as_tensor
    if kernel == "K1":
        assert ha._fwd_plan(D, V, H, 0, 0, False, B, N)["route"] == "wide_chunks"
        want = pallas_attn.hstu_mha_dense_pallas(*map(jnp.asarray, (q, k, v, lengths)), num_targets=jnp.asarray(nt),
                                                 block_q=128, block_k=128, interpret=True, **kw)
        got = ha.hstu_mha_dense_cuda(t(q), t(k), t(v), t(lengths), num_targets=t(nt), **kw)
    else:
        assert ha._fwd_plan(D, V, H, N, 128, True, B, N)["route"] == "wide_chunks"
        ts = np.cumsum(rng.integers(1, 86400, (B, N)), axis=1).astype(np.int64) + 1_500_000_000
        pos_w = (rng.standard_normal(2 * N - 1) * 0.1).astype(np.float32)
        ts_w = (rng.standard_normal(129) * 0.1).astype(np.float32)
        want = hstu_mha_dense_pallas_relbias(*map(jnp.asarray, (q, k, v, lengths, ts, pos_w, ts_w)),
                                             num_targets=jnp.asarray(nt), num_buckets=128, block_q=128,
                                             block_k=128, interpret=True, **kw)
        got = hr.hstu_mha_dense_relbias_cuda(t(q), t(k), t(v), t(lengths), t(ts), t(pos_w), t(ts_w),
                                             num_targets=t(nt), num_buckets=128, **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD_TOL)
