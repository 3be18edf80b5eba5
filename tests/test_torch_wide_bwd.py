"""The wide backward's plans and a ranker whose value width differs from its
query width, on the CPU.

* The plans of the wide backward (`_bwd_plan`, `_dq_plan`, the relative-bias
  plans above width 128; `csrc/hstu_attention_wide.cuh`'s `bwd_kernel`):
  one thread block cluster per 64-row tile whose blocks own the chunks of
  128 columns of D and of V, one each up to a portable cluster's 8 blocks,
  two each past it (up to 16 blocks, a non-portable cluster); each block's
  shared memory within a Hopper block's 232,448 bytes; past 16 blocks of two
  chunks the per-pair backward (route ``wide_chunks``: S and dP once per 64 x
  64 tile pair into a float32 scratch, then a gradient pass a block per
  output tile and chunk), its slabs in groups under the scratch's cap, so
  that every width the wide forward takes, the backward takes; grids past
  CUDA's limits refused with a ValueError that names the sizes. The Python
  mirror of the cluster's shape, of the block's bytes and of the per-pair
  tiling against the constants of the C header.
* The DLRM ranker (`DlrmHSTU`) with hstu_attn_linear_dim unequal to
  hstu_attn_qk_dim (32 against 16, and 16 against 32; 2 heads, 2 layers, a
  small debug batch) against the JAX package's `DlrmTrainer` on the same
  weights (`convert.py`): the loss to rtol 1e-5, every gradient to atol
  1e-5 of its largest entry and rtol 1e-4, the eval predictions to rtol
  1e-5 / atol 1e-6 (`tests/test_torch_training.py`'s tolerances). float32;
  dropout off on both sides.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from generative_recommenders_tpu.configs import dlrm as j_configs
from generative_recommenders_tpu.data.dlrm_dataset import DLRMv3RandomDataset
from generative_recommenders_tpu.parallel.mesh import make_mesh
from generative_recommenders_tpu.train import dlrm_train as j_train
from generative_recommenders_tpu_torch.configs import dlrm as t_configs
from generative_recommenders_tpu_torch.convert import params_from_flax
from generative_recommenders_tpu_torch.ops.cuda import build
from generative_recommenders_tpu_torch.ops.cuda import hstu_attention as ha
from generative_recommenders_tpu_torch.ops.cuda import hstu_attention_relbias as hr
from generative_recommenders_tpu_torch.train import dlrm_train as t_train

SHARED = 232448  # a Hopper block's shared memory


def _chunks(w):
    return -(-w // 128)


# ------------------------------------------------------------------- plans
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("D,V", [(64, 256), (128, 256), (512, 64), (320, 136), (512, 512), (256, 768)])
def test_cluster_is_one_block_per_chunk_up_to_the_cap(D, V, dtype):
    """Up to 8 chunks of D and V together, each chunk its own block: the
    cluster has chunks(D) + chunks(V) blocks, D's first; the grid is one
    cluster per (64-row tile, head, batch row) in both passes."""
    B, H, N = 4, 2, 1000
    for plan in (ha._bwd_plan(D, V, H, B, N, dtype), ha._dq_plan(D, V, H, B, N, dtype)):
        assert plan["route"] == "wide" and plan["chunks_per_block"] == 1
        assert plan["cluster"] == _chunks(D) + _chunks(V) <= 8
        assert (plan["d_blocks"], plan["v_blocks"]) == (_chunks(D), _chunks(V))
        assert plan["grid"] == (-(-N // 64) * H * B * plan["cluster"],)
        assert 0 < plan["shared_bytes"] <= SHARED


@pytest.mark.parametrize("D,V,blocks", [
    (640, 512, (3, 2)),    # 9 chunks: past the portable cap
    (1024, 8, (4, 1)),
    (1024, 1024, (4, 4)),  # 16 chunks in 8 blocks
    (1152, 1024, (5, 4)),  # 17 chunks: a non-portable cluster of 9
    (2048, 2048, (8, 8)),  # 32 chunks in 16 blocks, the most a cluster takes
])
def test_past_the_cap_a_block_takes_two_chunks(D, V, blocks):
    """Past 8 blocks of one chunk each, every block owns two chunks (the
    last of D's or V's may own one); more than 8 such blocks take a
    non-portable cluster of up to 16."""
    plan = ha._bwd_plan(D, V, 2, 4, 300)
    assert plan["chunks_per_block"] == 2
    assert (plan["d_blocks"], plan["v_blocks"]) == blocks
    assert plan["cluster"] == sum(blocks) <= 16
    assert plan["d_blocks"] * 2 >= _chunks(D) > (plan["d_blocks"] - 1) * 2
    assert plan["v_blocks"] * 2 >= _chunks(V) > (plan["v_blocks"] - 1) * 2


def test_shared_bytes_stay_within_a_block():
    """Every wide backward plan of both types, with and without the table
    sums, at one and two chunks a block, fits a block's shared memory; the
    float32 tiles at two chunks a block are the largest."""
    most = 0
    for D, V in ((129, 32), (640, 512), (2048, 2048)):
        for dtype in (torch.float32, torch.bfloat16):
            for plan in (ha._wide_dkv_plan(D, V, 2, 4, 300, relbias=True, dtype=dtype),
                         ha._wide_dkv_plan(D, V, 2, 4, 300, dtype=dtype), ha._wide_dq_plan(D, V, 2, 4, 300, dtype)):
                assert 0 < plan["shared_bytes"] <= SHARED
                most = max(most, plan["shared_bytes"])
    assert most == ha._wide_bwd_bytes(2, 4, True)
    assert ha._wide_bwd_bytes(1, 2, False) < ha._wide_bwd_bytes(1, 4, False) // 2 + 4 * 2 * 64 * 40


@pytest.mark.parametrize("args,match", [
    ((512, 512, 2**16, 2**9, 2**10), r"clusters of 8 blocks.*exceeds"),
    ((4096, 4096, 1, 1, 2**22), r"per-pair wide d.* kernel's grid of \d+ blocks exceeds"),
])
def test_plans_past_cuda_limits_raise_with_the_sizes(args, match):
    """A grid past 2^31 - 1 blocks, on clusters or per tile pair, raises a
    ValueError that names the sizes; nothing falls back. The per-pair route
    runs its slabs in groups, so only one slab's grid can pass the limit (N
    2^22: 2^32 tile pairs)."""
    for plan in (ha._bwd_plan, ha._dq_plan):
        with pytest.raises(ValueError, match=match):
            plan(*args)


def _pairs_bytes(group, qt, splits):
    """A group's scratch (as `hstu_wide::Pairs` lays it out): P and dS of
    every pair, the pairs' flags padded to 4, the splits' partial S and dP."""
    tiles = group * qt * qt
    return 4 * (2 * tiles * 4096 + -(-tiles // 4) * 4 + (splits * tiles * 2 * 4096 if splits > 1 else 0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("D,V", [(2176, 2048), (128, 4096), (3968, 128), (2048, 2049)])
def test_past_16_blocks_of_two_chunks_the_per_chunk_route(D, V, dtype):
    """Widths a cluster of 16 blocks of two chunks does not take (these raised
    before; the wide forward takes them) go to the per-pair backward, route
    ``wide_chunks``: the S / dP pass a block per (64 x 64 tile pair, split,
    slab), 3 stages of two [64][72] tiles; the gradient pass a block per
    (64-row tile, 128-column chunk, slab): dQ's chunks for K3, dK's and dV's
    for K4, all three for K2 (``fused_grid``) and K7, two stages of a float32
    [64][72] A tile and a [64][136] chunk; the float32 scratch of P, dS, the
    flags and the splits' parts; one group here; the pre-scaling pass on
    bfloat16; K7's and K7-det's table sums a block per key tile, one row of
    `partial` per key tile, head and batch row."""
    B, H, N, Nm, NB = 4, 2, 300, 300, 128
    assert ha._wide_cluster(D, V) is None
    qt, nd, nv, elem = -(-N // 64), _chunks(D), _chunks(V), dtype.itemsize
    steps = -(-D // 64) + -(-V // 64)
    dq = ha._dq_plan(D, V, H, B, N, dtype)
    dkv = ha._bwd_plan(D, V, H, B, N, dtype)
    assert dq["route"] == dkv["route"] == dkv["dq"]["route"] == "wide_chunks"
    group, pairs = B * H, B * H * qt * qt  # 200 pairs: split
    splits = -(-steps // -(-steps // -(-264 // pairs)))
    for plan in (dq, dkv):
        assert (plan["groups"], plan["group_slabs"], plan["splits"]) == (1, group, splits) and splits == 2
        assert plan["sdp_grid"] == (pairs * splits,) and plan["sums_grid"] == (pairs,)
        assert plan["sdp_shared_bytes"] == 3 * 2 * 64 * 72 * elem <= SHARED
        assert plan["shared_bytes"] == 2 * (4 * 64 * 72 + elem * 64 * 136) <= SHARED
        assert plan["scratch_shape"] == (_pairs_bytes(group, qt, splits) // 4,)
        assert ("do_scaled_shape" in plan) == (dtype == torch.bfloat16)
    assert dq["grid"] == (group * qt * nd,) and dkv["grid"] == (group * qt * (nd + nv),)
    assert dkv["fused_grid"] == (group * qt * (2 * nd + nv),)
    k7 = hr._relbias_bwd_plan(D, V, H, Nm, NB, dtype, B, N)
    assert k7["route"] == "wide_chunks" and k7["grid"] == dkv["fused_grid"]
    assert k7["tables_grid"] == (group * qt,) and k7["tables_shared_bytes"] == 4 * (64 * 65 + 128 + 8 * 296)
    det = hr._relbias_det_plan(D, V, H, B, N, Nm, NB, dtype=dtype)
    assert det["route"] == "wide_chunks" and det["grid"] == k7["grid"] and det["scratch_shape"] == dq["scratch_shape"]
    assert det["partial_shape"] == (qt * H * B, 2 * Nm - 1 + NB + 1) and det["dq_partial_shape"] is None


@pytest.mark.parametrize("case", ["past the cap", "one slab past the cap", "the ranker's layer", "few pairs"])
def test_per_pair_scratch_goes_in_groups_under_the_cap(case):
    """The per-pair backward's (batch row, head) slabs run in groups whose
    P, dS and flags stay under `_PAIR_SCRATCH_CAP` (256 MiB), each group in
    turn on one scratch: B 8, H 8, N 4096 at D 3968 / V 128 in 64 groups; a
    slab larger than the cap (N 8192) a group of its own; the widest-heads
    ranker's layer (B 8, N 268, H 4) one group, unsplit; B 1, H 1, N 300 one
    group of 25 pairs whose S / dP steps split 11 ways (264 blocks aimed
    at). The plans of K2 / K4, K3, K7 and K7-det agree; every grid of a
    group within CUDA's limit."""
    cap = ha._PAIR_SCRATCH_CAP
    assert cap == 256 * 2**20
    B, N, H, groups, splits = {"past the cap": (8, 4096, 8, 64, 1), "one slab past the cap": (1, 8192, 2, 2, 1),
                               "the ranker's layer": (8, 268, 4, 1, 1), "few pairs": (1, 300, 1, 1, 11)}[case]
    D, V, qt = 3968, 128, -(-N // 64)
    plans = [ha._bwd_plan(D, V, H, B, N), ha._dq_plan(D, V, H, B, N), hr._relbias_bwd_plan(D, V, H, N, 128, B=B, N=N),
             hr._relbias_det_plan(D, V, H, B, N, N, 128)]
    for plan in plans:
        assert (plan["route"], plan["groups"], plan["splits"]) == ("wide_chunks", groups, splits)
        group = plan["group_slabs"]
        assert -(-(B * H) // group) == groups
        own = _pairs_bytes(group, qt, 1)
        assert own <= cap or group == 1  # under the cap, or a slab past it alone
        assert group == B * H or _pairs_bytes(group + 1, qt, 1) > cap  # as many slabs as fit
        assert plan["scratch_shape"] == (_pairs_bytes(group, qt, splits) // 4,)
        assert max(plan["sdp_grid"][0], plan["grid"][0]) < 2**31
    if case == "past the cap":
        assert plans[0]["group_slabs"] == 1 and _pairs_bytes(1, qt, 1) < cap < _pairs_bytes(2, qt, 1)
    if case == "one slab past the cap":
        assert _pairs_bytes(1, qt, 1) > cap
    if case == "the ranker's layer":
        assert plans[0]["group_slabs"] == 32 and _pairs_bytes(32, qt, 1) < 50 * 10**6  # within the L2
    # the grid that raised on the per-chunk route (2^9 batch rows, 2^16 heads, N 128) goes in groups
    wide = ha._bwd_plan(4096, 4096, 2**16, 2**9, 2**7)
    assert wide["groups"] > 1 and wide["fused_grid"][0] < 2**31


def test_relative_bias_plans_take_the_clusters():
    """K7 at heads above 128 is the dkv pass with dQ and the table sums; K7-det
    its dq pass, then the dkv pass with one row of `partial` per block (on
    bfloat16 after the pre-scaling pass)."""
    D, V, H, B, N, Nm, NB = 256, 256, 2, 4, 1024, 1024, 128
    plan = hr._relbias_bwd_plan(D, V, H, Nm, NB, torch.float32, B, N)
    assert plan["route"] == "wide" and plan["cluster"] == 4 and plan["grid"] == (16 * H * B * 4,)
    assert plan["shared_bytes"] == ha._wide_bwd_bytes(1, 4, True)
    det = hr._relbias_det_plan(D, V, H, B, N, Nm, NB, dtype=torch.bfloat16)
    assert det["partial_shape"] == (16 * H * B * 4, 2 * Nm - 1 + NB + 1)
    assert det["dq_grid"] == det["grid"] and det["dq_shared_bytes"] == ha._wide_bwd_bytes(1, 2, False)
    assert det["q_scaled_shape"] == (B, N, H, D) and det["do_scaled_shape"] == (B, N, H, V)


def _header() -> str:
    with open(os.path.join(build.CSRC_DIR, "hstu_attention_wide.cuh")) as f:
        return f.read()


def test_python_mirrors_the_header():
    """The plans' constants are the C header's: rows, step, pitches, the
    cluster caps, the chunks a block owns and the buckets of dts_w."""
    text = _header()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+)", text).group(1))

    assert const("kC") == ha._WIDE_CHUNK
    assert re.search(r"constexpr int kR = (\d+)", text).group(1) == str(ha._WIDE_BWD_ROWS)
    assert const("kS") == ha._WIDE_BWD_STEP
    assert re.search(r"constexpr int kXP = kS \+ 8", text) and ha._WIDE_BWD_XP == ha._WIDE_BWD_STEP + 8
    assert const("kPortableCluster") == ha._PORTABLE_CLUSTER
    assert const("kMaxCluster") == ha._MAX_CLUSTER
    assert const("kMaxOwn") == ha._MAX_OWN
    assert const("kTsSlots") == ha._WIDE_TS_SLOTS
    assert const("kSplitFrom") == ha._SPLIT_FROM
    assert const("kRecvSlots") * 256 <= 2 * ha._WIDE_BWD_ROWS * ha._WIDE_BWD_XP  # in the exchange buffers' space
    assert const("kBwdThreads") == 256  # eight warps' live flags and dts_w copies
    # the per-pair backward's tiles, stages and split target
    assert (const("kPT"), const("kPK"), const("kSdpStages"), const("kGradStages"), const("kSplitTarget")) == (
        ha._PAIR_TILE, ha._PAIR_STEP, ha._SDP_STAGES, ha._GRAD_STAGES, ha._SPLIT_TARGET)
    assert re.search(r"constexpr int kPA = kPK \+ 8;", text) and ha._PAIR_PITCH == ha._PAIR_STEP + 8


@pytest.mark.parametrize("D", [1, 128, 129, 640, 1024, 2048, 2176])
@pytest.mark.parametrize("V", [1, 128, 256, 512, 1152, 2048])
def test_cluster_shape_matches_the_c_rule(D, V):
    """`_wide_cluster` against a Python transcription of `cluster_of`'s loop
    read from the header: one chunk a block while the blocks fit a portable
    cluster, else two while they fit 16."""
    body = re.search(r"inline Cluster cluster_of\(int D, int V\) \{(.*?)\n\}", _header(), re.S).group(1)
    assert "m <= kMaxOwn" in body and "nd + nv <= kPortableCluster || (m == kMaxOwn && nd + nv <= kMaxCluster)" in body
    assert "nd + nv >= kSplitFrom ? 1 : 0" in body
    n_dc, n_vc = _chunks(D), _chunks(V)
    want = None
    for m in (1, 2):
        nd, nv = -(-n_dc // m), -(-n_vc // m)
        if nd + nv <= 8 or (m == 2 and nd + nv <= 16):
            want = (m, nd, nv)
            break
    if want is None:  # the per-chunk route
        assert ha._wide_cluster(D, V) is None
        assert ha._dq_plan(max(D, 257), V, 2, 4, 300)["route"] == "wide_chunks"
    else:
        assert ha._wide_cluster(D, V) == want
        plan = ha._dq_plan(max(D, 257), V, 2, 4, 300)  # past the narrow widths
        assert plan["split_work"] == (plan["cluster"] >= 5)


# ------------------------------------------------- a ranker with V != D
SMALL = dict(
    hstu_attn_num_layers=2, hstu_embedding_table_dim=16, hstu_transducer_embedding_dim=32,
    hstu_num_heads=2, num_position_buckets=128, num_time_buckets=64,
    contextual_feature_to_min_uih_length=(("viewer_id", 10), ("dummy_contexual", 10)),
    hstu_input_dropout_ratio=0.0, hstu_linear_dropout_rate=0.0,
)
HASH, BATCH = 64, 4


def _flax_to_torch(tree):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, tree))


@pytest.fixture(scope="module", params=[(16, 32), (32, 16)], ids=["qk16-v32", "qk32-v16"])
def ranker(request):
    """The JAX `DlrmTrainer` on a 1 x 1 CPU mesh and the port's on the CPU,
    at hstu_attn_qk_dim and hstu_attn_linear_dim of the param, with the same
    weights, and two numpy batches."""
    qk, linear = request.param
    widths = dict(SMALL, hstu_attn_qk_dim=qk, hstu_attn_linear_dim=linear)
    jcfg = dataclasses.replace(j_configs.get_hstu_configs("debug", max_uih_len=24, max_num_candidates=6), **widths)
    tcfg = dataclasses.replace(t_configs.get_hstu_configs("debug", max_uih_len=24, max_num_candidates=6), **widths)
    jt = j_train.DlrmTrainer(
        jcfg, j_configs.get_embedding_table_config("debug", hash_size=HASH, dim=16),
        j_train.DlrmTrainConfig(batch_size=BATCH, num_batches=2),
        mesh=make_mesh(shape=(1, 1), devices=jax.devices("cpu")[:1]),
    )
    tt = t_train.DlrmTrainer(
        tcfg, t_configs.get_embedding_table_config("debug", hash_size=HASH, dim=16),
        t_train.DlrmTrainConfig(), device="cpu",
    )
    batches = list(DLRMv3RandomDataset(jcfg, hash_size=HASH, batch_size=BATCH, seed=7).batches(2))
    params, _ = jt.init_sharded(jax.random.PRNGKey(3), j_train._to_device(batches[0]))
    init = jax.tree_util.tree_map(np.array, params)
    tt.model.load_state_dict(_flax_to_torch(init))
    return jt, tt, batches, init, (qk, linear)


def test_ranker_with_other_value_width_matches_jax(ranker):
    """The loss and every parameter's gradient against `jax.value_and_grad`
    of `DlrmTrainer._loss_fn`, the attention's value projection of the
    config's linear width."""
    jt, tt, batches, init, (qk, linear) = ranker
    named = dict(tt.model.named_parameters())
    heads = SMALL["hstu_num_heads"]
    assert named["hstu_transducer.stu_module.layer_0.uvqk_weight"].shape[1] == heads * (2 * linear + 2 * qk)
    (loss, _), grads = jax.jit(jax.value_and_grad(jt._loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, init), j_train._to_device(batches[0]), jax.random.PRNGKey(1)
    )
    tt.model.zero_grad(set_to_none=True)
    got, *_ = tt.loss(t_train.to_device(batches[0], tt.device))
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    want = _flax_to_torch(grads)
    assert named.keys() == want.keys()
    for name, p in named.items():
        w = want[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * scale, err_msg=name)


def test_ranker_with_other_value_width_predicts_as_jax(ranker):
    """`eval_step`'s predictions on both batches against the JAX trainer's."""
    jt, tt, batches, init, _ = ranker
    params = jax.tree_util.tree_map(jnp.asarray, init)
    for raw in batches:
        want = jt.eval_step(params, j_train._to_device(raw))[0]
        got = tt.eval_step(t_train.to_device(raw, tt.device))[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
