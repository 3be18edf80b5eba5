"""The PyTorch port's distribution layer (`generative_recommenders_tpu_torch/parallel/`)
against the JAX package's, on the CPU over gloo.

The port's ranks run as processes of `tests/_torch_dist_worker.py` on
127.0.0.1, started once for the module (each pays for a torch import); the
JAX side runs here on conftest's 8 virtual CPU devices. Inputs come from
numpy with a seed. Tolerances: the exchange is a gather, so its rows are
equal to the plain take; gradients and row-wise Adagrad within the JAX
tests' own (rtol 1e-5 / 2e-5). A mesh against one rank: losses rtol 1e-5,
parameters rtol 5e-5 / atol 1e-6 (`tests/test_parallel.py`'s mesh parity).
The port's mesh against the JAX mesh: the tolerances of
`tests/test_torch_training.py::test_train_steps_match_jax` (the ranker) and
`tests/test_torch_research.py::test_train_steps_track_jax` (research).
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_dist_worker as W
from generative_recommenders_tpu.configs import dlrm as j_configs
from generative_recommenders_tpu.data.dataset import batch_iterator
from generative_recommenders_tpu.data.dlrm_dataset import DLRMv3RandomDataset
from generative_recommenders_tpu.models.sequential import ModelConfig as JModelConfig
from generative_recommenders_tpu.parallel import DistributedTrainer as JDistributedTrainer
from generative_recommenders_tpu.parallel import embedding as j_emb
from generative_recommenders_tpu.parallel.mesh import make_mesh as j_make_mesh
from generative_recommenders_tpu.train import dlrm_train as j_dlrm
from generative_recommenders_tpu.train.train_loop import TrainConfig as JTrainConfig
from generative_recommenders_tpu_torch.cli import train_ranker as t_cli
from generative_recommenders_tpu_torch.cli import train_research as t_research_cli
from generative_recommenders_tpu_torch.convert import params_from_flax
from generative_recommenders_tpu_torch.parallel import distributed as t_dist
from generative_recommenders_tpu_torch.parallel import mesh as t_mesh
from generative_recommenders_tpu_torch.parallel import sharding as t_sharding
from generative_recommenders_tpu_torch.train import dlrm_train as t_dlrm
from generative_recommenders_tpu_torch.train import train_loop as t_train_loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH_TOL = dict(rtol=5e-5, atol=1e-6)
MESHES = ((2, 2), (1, 4))
IMPLS = ("ragged", "dense")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    return {**os.environ, "PYTHONPATH": os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]),
            "OMP_NUM_THREADS": "1"}


def _launch(argv_of_rank, world):
    """Starts ``world`` processes (``argv_of_rank(rank, port)``); returns
    them and a function that waits for all and fails if any failed."""
    port = _free_port()
    procs = [subprocess.Popen(argv_of_rank(r, port), env=_env(), cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]

    def wait():
        outs = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=240)
                assert p.returncode == 0, err[-3000:]
                outs.append(out)
        finally:
            for p in procs:
                p.kill()
        return outs

    return wait


def _flax_to_torch(tree):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, tree))


# --------------------------------------------------------------- the runs
def _cli_argv(batch_size):
    return ["--device", "cpu", "--num_batches", "2", "--batch_size", str(batch_size), "--max_uih_len", "24",
            "--max_num_candidates", "6", "--hash_size", "100"]


# the CLI's preset with its dropout off (the ranks draw their own masks)
_CLI_WRAPPER = (
    "import dataclasses, json, sys\n"
    "from generative_recommenders_tpu_torch.cli import train_ranker as t\n"
    "get = t.get_hstu_configs\n"
    "t.get_hstu_configs = lambda *a, **k: dataclasses.replace(get(*a, **k), hstu_input_dropout_ratio=0.0, "
    "hstu_linear_dropout_rate=0.0)\n"
    "out = t.main(sys.argv[1:])\n"
    "print('LOSSES', json.dumps(out['losses']))\n"
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Writes every input, starts the 4-rank exchange + ranker job, the
    2-rank research job and two ranker CLI processes at once, and returns
    what they wrote with the JAX side's inputs."""
    work = str(tmp_path_factory.mktemp("parallel"))
    rng = np.random.default_rng(0)
    ex = {
        "table_random": rng.standard_normal((64, 16)).astype(np.float32),
        "ids_random": rng.integers(0, 64, (8, 5)),
        "ids_uneven": rng.integers(48, 64, (8, 7)),  # every id on the last shard at m = 2 and m = 4
        "table_1d": rng.standard_normal((16, 4)).astype(np.float32),
        "ids_1d": rng.integers(0, 16, (8,)),
        "table_grad": rng.standard_normal((32, 8)).astype(np.float32),
        "ids_grad": np.tile(np.array([[1, 1, 5, 31, 0], [2, 2, 2, 7, 31]]), (4, 1)),
        "table_ada": rng.standard_normal((32, 8)).astype(np.float32),
        "acc_ada": rng.random(32).astype(np.float32),
        "ids_ada": rng.integers(0, 32, (8, 6)),
        "grads_ada": rng.standard_normal((8, 6, 8)).astype(np.float32),
    }
    ex["table_uneven"] = ex["table_random"]
    np.savez(os.path.join(work, "exchange_in.npz"), **ex)

    # the ranker: the JAX trainer's weights on its (4, 2) mesh, two global batches of 8
    jcfg = dataclasses.replace(
        j_configs.get_hstu_configs("debug", max_uih_len=16, max_num_candidates=3),
        **{k: getattr(W.ranker_configs()[0], k) for k in (
            "hstu_attn_num_layers", "hstu_embedding_table_dim", "hstu_transducer_embedding_dim",
            "hstu_attn_linear_dim", "hstu_attn_qk_dim", "hstu_num_heads", "hstu_input_dropout_ratio",
            "hstu_linear_dropout_rate", "contextual_feature_to_min_uih_length")},
    )
    jt = j_dlrm.DlrmTrainer(
        jcfg, j_configs.get_embedding_table_config("debug", hash_size=W.RANKER_HASH, dim=16),
        j_dlrm.DlrmTrainConfig(batch_size=W.RANKER_BATCH), mesh=j_make_mesh((4, 2), devices=jax.devices("cpu")),
    )
    batches = list(DLRMv3RandomDataset(jcfg, hash_size=W.RANKER_HASH, batch_size=W.RANKER_BATCH, seed=0).batches(2))
    params, opt = jt.init_sharded(jax.random.PRNGKey(1), j_dlrm._to_device(batches[0]))
    ranker_init = _flax_to_torch(params)
    torch.save(ranker_init, os.path.join(work, "ranker_init_file.pt"))
    os.makedirs(os.path.join(work, "ranker_init"))
    torch.save(ranker_init, os.path.join(work, "ranker_init", "0.pt"))
    torch.save(batches, os.path.join(work, "ranker_batches.pt"))

    # research: two global batches of 8; the second's first 4 rows (rank
    # 0's at 1 x 2) are the longest histories, its last 4 the shortest
    ds = W.research_dataset()
    lengths = np.array([len(ds.get_row(i)["historical_ids"].nonzero()[0]) for i in range(len(ds))])
    by_len = np.argsort(-lengths, kind="stable")
    rows = [ds.get_row(int(i)) for i in np.concatenate([by_len[:4], by_len[-4:]])]
    research_batches = [next(batch_iterator(ds, W.RESEARCH_BATCH, shuffle=False)),
                        {k: np.stack([r[k] for r in rows]) for k in rows[0]}]
    torch.save(research_batches, os.path.join(work, "research_batches.pt"))
    jr = JDistributedTrainer(_j_research_cfg(), ds.all_item_ids(), j_make_mesh((4, 2), devices=jax.devices("cpu")))
    jr.sampler = W.FixedNegatives(jnp.asarray(ds.all_item_ids()), jr.sampler, jnp)
    jparams, jopt = jr.init_sharded(jax.random.PRNGKey(0))
    research_init = {case: _flax_to_torch(jparams) for case in ("local", "in-batch", "loss-checkpoint")}
    research_init["mol"] = _fresh_research_state("mol")  # MoL's own weights, drawn by the port
    torch.save(research_init, os.path.join(work, "research_init.pt"))

    worker = os.path.join(REPO, "tests", "_torch_dist_worker.py")
    waits = {
        "exchange": _launch(lambda r, port: [sys.executable, worker, "exchange", "4", str(r), str(port), work], 4),
        "research": _launch(lambda r, port: [sys.executable, worker, "research", "2", str(r), str(port), work], 2),
        "cli": _launch(lambda r, port: [sys.executable, "-c", _CLI_WRAPPER, *_cli_argv(2), "--distributed",
                                        "--num_processes", "2", "--process_id", str(r), "--coordinator",
                                        f"127.0.0.1:{port}", "--mesh", "1x2"], 2),
    }

    # meanwhile, the JAX side and the port's one-rank runs
    j_losses = []
    for raw in batches:
        params, opt, loss, *_ = jt.train_step(params, opt, j_dlrm._to_device(raw), jax.random.PRNGKey(7))
        j_losses.append(float(loss))
    jr_losses = []
    for i, batch in enumerate(research_batches):
        jparams, jopt, loss = jr.train_step(jparams, jopt, batch, jax.random.PRNGKey(7 + i))
        jr_losses.append(float(loss))
    one_rank = _one_rank_ranker(ranker_init, batches)
    one_research = {case: _one_rank_research(case, research_init[case], research_batches) for case in W.RESEARCH_CASES}
    cli_single = _cli_single()

    outs = {job: wait() for job, wait in waits.items()}
    load = lambda job, n: [torch.load(os.path.join(work, f"{job}_{r}.pt"), weights_only=False) for r in range(n)]  # noqa: E731
    return dict(
        work=work, ex=ex, exchange=load("exchange", 4), research=load("research", 2),
        cli=[json.loads(o.split("LOSSES", 1)[1]) for o in outs["cli"]], cli_single=cli_single,
        jax_ranker=(j_losses, _flax_to_torch(params)), ranker_init=ranker_init, one_rank=one_rank,
        jax_research=(jr_losses, _flax_to_torch(jparams)), one_research=one_research,
        research_init=research_init,
    )


def _j_research_cfg():
    w = W.research_config()
    return JTrainConfig(
        model=JModelConfig(**{**dataclasses.asdict(w.model), "attn_kernel": "xla", "mol_config": None}),
        local_batch_size=w.local_batch_size, eval_batch_size=w.eval_batch_size, num_negatives=w.num_negatives,
        sampling_strategy="local",
    )


def _fresh_research_state(case):
    cfg = W.research_config(**W.RESEARCH_CASES[case])
    return t_train_loop.ResearchTrainer(cfg, W.research_dataset().all_item_ids(), device="cpu").model.state_dict()


def _one_rank_ranker(init, batches):
    cfg, tables = W.ranker_configs()
    tt = t_dlrm.DlrmTrainer(cfg, tables, t_dlrm.DlrmTrainConfig(), device="cpu")
    tt.model.load_state_dict(init)
    losses, preds = [], None
    for raw in batches:
        loss, preds, *_ = tt.train_step(t_dlrm.to_device(raw, tt.device))
        losses.append(loss.item())
    eval_preds = tt.eval_step(t_dlrm.to_device(batches[0], tt.device))[0]
    return dict(losses=losses, preds=preds, eval_preds=eval_preds, state=tt.model.state_dict())


def _one_rank_research(case, init, batches):
    trainer = W.research_trainer(case, init)
    losses = [trainer.train_step(b).item() for b in batches]
    ranks, _ = trainer.encode_step(batches[0], trainer.item_embeddings())
    return dict(losses=losses, state=trainer.model.state_dict(), ranks=ranks)


def _cli_single():
    """The CLI in this process, one rank at twice the batch, dropout off."""
    get = t_cli.get_hstu_configs
    t_cli.get_hstu_configs = lambda *a, **k: dataclasses.replace(
        get(*a, **k), hstu_input_dropout_ratio=0.0, hstu_linear_dropout_rate=0.0
    )
    try:
        return t_cli.main(_cli_argv(4))["losses"]
    finally:
        t_cli.get_hstu_configs = get


def _assert_states_close(got, want, **tol):
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), err_msg=name, **tol)


# ---------------------------------------------------------- the exchange
_JAX_EXCHANGE = {}


def _jax_exchange(ex, shape):
    """The JAX package's lookups, gradient and row-wise Adagrad on ``shape``
    (its CPU route: the fixed-capacity exchange), jitted, once a mesh."""
    if shape in _JAX_EXCHANGE:
        return _JAX_EXCHANGE[shape]
    mesh = j_make_mesh(shape, devices=jax.devices("cpu")[:4])
    lookup = jax.jit(lambda t, i: j_emb.sharded_lookup(t, i, mesh))
    out = {case: np.asarray(lookup(jnp.asarray(ex[f"table_{case}"]), jnp.asarray(ex[f"ids_{case}"])))
           for case in ("random", "uneven", "1d")}
    ids = jnp.asarray(ex["ids_grad"])
    out["grad"] = np.asarray(jax.jit(jax.grad(lambda t: jnp.sum(j_emb.sharded_lookup(t, ids, mesh) ** 2)))(
        jnp.asarray(ex["table_grad"])))
    new = jax.jit(lambda st, i, g: j_emb.rowwise_adagrad_update(st, i, g, mesh, lr=0.1))(
        j_emb.ShardedEmbeddingState(jnp.asarray(ex["table_ada"]), jnp.asarray(ex["acc_ada"])),
        jnp.asarray(ex["ids_ada"]), jnp.asarray(ex["grads_ada"]),
    )
    out["ada_table"], out["ada_acc"] = np.asarray(new.table), np.asarray(new.accumulator)
    _JAX_EXCHANGE[shape] = out
    return out


def _whole(ranks, key, shape):
    """A row-sharded result put together from the ranks of data row 0; the
    other data rows hold the same shards."""
    d, m = shape
    for i in range(1, d):
        for j in range(m):
            torch.testing.assert_close(ranks[i * m + j][key], ranks[j][key], rtol=0, atol=0)
    return torch.cat([ranks[j][key] for j in range(m)]).numpy()


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_exchange_matches_jax(runs, shape, impl):
    """`sharded_lookup` on random ids, on ids all owned by the last shard
    and on 1-D ids: every rank's rows equal the JAX package's lookup and the
    plain take; the gradient of sum(out^2) equal to JAX's and a scatter-add
    (rtol 1e-5); `rowwise_adagrad_update` against JAX's (rtol 2e-5, atol
    2e-6 as its own test), on both routes of the port."""
    ex, ranks = runs["ex"], runs["exchange"]
    key = f"{shape[0]}x{shape[1]}"
    want = _jax_exchange(ex, shape)
    for r, out in enumerate(ranks):
        assert tuple(out[f"{key}/coords"].tolist()) == (r // shape[1], r % shape[1])
    for case in ("random", "uneven", "1d"):
        got = torch.cat([out[f"{key}/{impl}/{case}"] for out in ranks]).numpy()
        np.testing.assert_array_equal(got, ex[f"table_{case}"][ex[f"ids_{case}"]])
        np.testing.assert_array_equal(got, want[case])
    g = _whole(ranks, f"{key}/{impl}/grad", shape)
    scatter = np.zeros_like(ex["table_grad"])
    np.add.at(scatter, ex["ids_grad"].reshape(-1), 2 * ex["table_grad"][ex["ids_grad"]].reshape(-1, 8))
    np.testing.assert_allclose(g, scatter, rtol=1e-5)
    np.testing.assert_allclose(g, want["grad"], rtol=1e-5)
    np.testing.assert_allclose(_whole(ranks, f"{key}/{impl}/ada_table", shape), want["ada_table"],
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(_whole(ranks, f"{key}/{impl}/ada_acc", shape), want["ada_acc"], rtol=1e-5)


# ---------------------------------------------------------------- ranker
def test_ranker_mesh_matches_one_rank(runs):
    """Two `DlrmTrainer` steps on a 2 x 2 mesh (tables row-sharded over 2,
    the batch over 4 ranks) against one rank on the same global batches:
    losses rtol 1e-5, every parameter (tables gathered whole) rtol 5e-5 /
    atol 1e-6; the gathered predictions of the last step and of an eval
    step as one rank's."""
    ranker, ref = runs["exchange"][0]["ranker"], runs["one_rank"]
    np.testing.assert_allclose(ranker["losses"], ref["losses"], rtol=1e-5)
    _assert_states_close(ranker["state"], ref["state"], **MESH_TOL)
    for key in ("preds", "eval_preds"):
        np.testing.assert_allclose(ranker[key].numpy(), ref[key].numpy(), rtol=1e-5, atol=1e-6)
    assert all(out["ranker"]["losses"] == ranker["losses"] for out in runs["exchange"])


def test_ranker_mesh_matches_jax_mesh(runs):
    """The same 2 x 2 run against the JAX `DlrmTrainer` on its (4, 2) mesh
    from the same weights: `test_train_steps_match_jax`'s tolerances (each
    loss rtol 1e-4; each parameter's change within 1e-2 of its largest)."""
    ranker = runs["exchange"][0]["ranker"]
    j_losses, j_state = runs["jax_ranker"]
    np.testing.assert_allclose(ranker["losses"], j_losses, rtol=1e-4)
    start = runs["ranker_init"]
    assert ranker["state"].keys() == j_state.keys()
    for name, w in j_state.items():
        step = float((w - start[name]).abs().max())
        assert step > 0, f"{name} was not trained"
        np.testing.assert_allclose(ranker["state"][name].numpy(), w.numpy(), rtol=0, atol=1e-2 * step,
                                   err_msg=name)


def test_ranker_step_moves_ids_not_tables(runs):
    """The twin of `test_parallel.py::test_dlrm_train_step_no_table_allgather`:
    during a step each rank holds R / m rows of every table, no collective
    gathers a table, and the exchange moves at most ids x (2 D + 1)
    elements over all ranks (ids out and rows back, ids x (D + 1), then the
    cotangents out)."""
    cfg, tables = W.ranker_configs()
    D = cfg.hstu_embedding_table_dim
    sent, ids = 0, 0
    for out in runs["exchange"]:
        r = out["ranker"]
        for t in tables:
            assert r["shard_shapes"][f"embedding_tables_{t.name}"] == (t.num_embeddings // 2, D)
        gathers = [shape for name, shape, _ in r["calls"] if name == "all_gather_into_tensor"]
        assert gathers and all(s == (2,) or len(s) == 3 for s in gathers), gathers  # counts; [B, T, M] preds
        sent += sum(int(np.prod(shape)) for name, shape, _ in r["calls"] if name == "all_to_all_single")
        ids += sum(r["lookups"])
    # a lookup whose rows the loss does not read gets no cotangents back
    assert ids > 0 and ids * (D + 1) < sent <= ids * (2 * D + 1)


def test_ranker_checkpoint_from_two_model_ranks_restores_on_one(runs, tmp_path):
    """The mesh run's checkpoint (rank 0 gathered the shards) restores on a
    one-rank trainer to the mesh's whole parameters, bit for bit, at its
    step."""
    cfg, tables = W.ranker_configs()
    tt = t_dlrm.DlrmTrainer(cfg, tables, t_dlrm.DlrmTrainConfig(), device="cpu")
    tt.restore(os.path.join(runs["work"], "ranker_ckpt"))
    assert tt.step == 2
    _assert_states_close(tt.model.state_dict(), runs["exchange"][0]["ranker"]["state"], rtol=0, atol=0)


# -------------------------------------------------------------- research
@pytest.mark.parametrize("case", list(W.RESEARCH_CASES))
def test_research_mesh_matches_one_rank(runs, case):
    """Two `DistributedTrainer` steps on a 1 x 2 mesh (the item table
    sharded) against one rank, negatives injected; the second batch puts
    the longest histories on rank 0 and the shortest on rank 1, so the
    global normalisers differ from each rank's. Local negatives, in-batch
    negatives (the pool is the global batch's), MoL (its load balancing
    reads the global utilisation) and the loss checkpoint (the normaliser
    recomputed in the backward): losses rtol 1e-5, parameters rtol 5e-5 /
    atol 1e-6, the eval's gathered ranks equal."""
    ranks, ref = runs["research"], runs["one_research"][case]
    assert ranks[0][f"{case}/sharded"] == ("embedding_module.item_emb",)
    for r in ranks:
        np.testing.assert_allclose([r[f"{case}/loss{i}"] for i in range(2)], ref["losses"], rtol=1e-5)
    _assert_states_close(ranks[0][f"{case}/state"], ref["state"], **MESH_TOL)
    np.testing.assert_array_equal(ranks[0][f"{case}/ranks"].numpy(), ref["ranks"].numpy())


def test_research_mesh_matches_jax_mesh(runs):
    """The local-negatives case against the JAX `DistributedTrainer` on its
    (4, 2) mesh from the same weights and negatives
    (`test_train_steps_track_jax`'s tolerances: losses 1e-3 relative, each
    parameter within 2e-3 of its largest entry)."""
    j_losses, j_state = runs["jax_research"]
    got = runs["research"][0]
    np.testing.assert_allclose([got[f"local/loss{i}"] for i in range(2)], j_losses, rtol=1e-3)
    state = got["local/state"]
    assert state.keys() == j_state.keys()
    for name, w in j_state.items():
        assert (state[name] - w).abs().max().item() <= 2e-3 * w.abs().max().item(), name


# --------------------------------------------------------------- serving
@pytest.mark.parametrize("path", ["dense", "mfalcon"])
def test_serving_mesh_matches_one_rank(runs, path):
    """`HSTUModelFamily(mesh=)` on 2 x 1 ranks, each scoring its rows of the
    batch (int8 tables; M-FALCON on the float tables): every rank returns
    the whole batch's predictions, those of one rank scoring it all."""
    want = W.serve(runs["work"])[f"serve/{path}"]
    for out in runs["research"]:
        np.testing.assert_allclose(out[f"serve/{path}"].numpy(), want.numpy(), rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------------- CLI
def test_ranker_cli_on_two_ranks_matches_one(runs):
    """Two `train_ranker --distributed --num_processes 2 --mesh 1x2`
    processes (batch 2 each) train on the one-process run's global batches
    (batch 4): the same losses on both ranks, rtol 1e-5."""
    assert len(runs["cli"]) == 2 and runs["cli"][0] == runs["cli"][1]
    np.testing.assert_allclose(runs["cli"][0], runs["cli_single"], rtol=1e-5)


def test_mesh_and_bootstrap_refusals(monkeypatch):
    """A mesh that does not fit the ranks raises, as does a coordinator
    without a world or a failed rendezvous; none carries on alone."""
    with pytest.raises(ValueError, match="ranks"):
        t_mesh.make_mesh((2, 1))
    with pytest.raises(ValueError, match="num_processes"):
        t_dist.initialize_distributed("127.0.0.1:1", device="cpu")
    with pytest.raises(SystemExit):
        t_cli.main(["--device", "cpu", "--mesh", "1x2"])
    with pytest.raises(SystemExit):
        t_cli.main(["--device", "cpu", "--num_processes", "2"])
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError):  # env:// without torchrun's variables
        t_research_cli.main(["--smoke", "--device", "cpu", "--distributed"])
    assert not torch.distributed.is_initialized()


def test_sharding_rules():
    """The table rule is `param_labels`' one; the vocabulary padding and the
    batch's row blocks as the JAX package's."""
    from generative_recommenders_tpu.parallel import sharding as j_sharding

    assert t_sharding.pad_vocab_to(127, 4) == j_sharding.pad_vocab_to(127, 4) == 127
    assert t_sharding.pad_vocab_to(3706, 4) == j_sharding.pad_vocab_to(3706, 4)
    assert t_sharding.is_table_path("embedding_tables_post_id")
    assert not t_sharding.is_table_path("hstu_transducer.stu.layer_0.uvqk")
    batch = {"a": np.arange(8), "b": (np.arange(16).reshape(8, 2),)}
    got = t_sharding.rank_rows(batch, 4, 2)
    np.testing.assert_array_equal(got["a"], [4, 5])
    np.testing.assert_array_equal(got["b"][0], [[8, 9], [10, 11]])
    with pytest.raises(ValueError):
        t_sharding.rank_rows(batch, 3, 0)
