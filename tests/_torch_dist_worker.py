"""One rank of the PyTorch port's distribution tests (tests/test_torch_parallel.py),
over gloo on the CPU. Imports torch and the port, never JAX:

    python tests/_torch_dist_worker.py <job> <world> <rank> <port> <workdir>

``exchange`` (4 ranks): `sharded_lookup`, its gradient and
`rowwise_adagrad_update` on the (2, 2) and (1, 4) meshes through both
exchange routes, on the tables and ids the test wrote. ``ranker`` (4 ranks):
two `DlrmTrainer` steps on a 2 x 2 mesh from the test's weights and global
batches, the collectives of one step counted, a checkpoint. ``research`` (2
ranks): two `DistributedTrainer` steps on a 1 x 2 mesh for each research
case, then the serving family on a 2 x 1 mesh. Each rank writes
``<workdir>/<job>_<rank>.pt``.
"""

import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from generative_recommenders_tpu_torch.configs import dlrm as t_configs
from generative_recommenders_tpu_torch.data.dataset import SequenceDataset, synthetic_user_sequences
from generative_recommenders_tpu_torch.models.sequential import ModelConfig
from generative_recommenders_tpu_torch.parallel import embedding as t_emb
from generative_recommenders_tpu_torch.parallel.distributed import initialize_distributed
from generative_recommenders_tpu_torch.parallel.mesh import make_mesh
from generative_recommenders_tpu_torch.parallel.sharding import rank_rows, shard_rows
from generative_recommenders_tpu_torch.train import dlrm_train as t_dlrm
from generative_recommenders_tpu_torch.train.train_loop import ResearchTrainer, TrainConfig

RANKER_HASH, RANKER_BATCH = 128, 8
RESEARCH_ITEMS, RESEARCH_BATCH = 127, 8  # 128 table rows: they divide any model axis


def ranker_configs():
    """`tests/test_parallel.py:_tiny_dlrm_trainer`'s model (1 layer, dropout
    off) and tables, on the port's configs."""
    cfg = dataclasses.replace(
        t_configs.get_hstu_configs("debug", max_uih_len=16, max_num_candidates=3),
        hstu_attn_num_layers=1, hstu_embedding_table_dim=16, hstu_transducer_embedding_dim=32,
        hstu_attn_linear_dim=16, hstu_attn_qk_dim=16, hstu_num_heads=2,
        hstu_input_dropout_ratio=0.0, hstu_linear_dropout_rate=0.0, contextual_feature_to_min_uih_length=(),
    )
    return cfg, t_configs.get_embedding_table_config("debug", hash_size=RANKER_HASH, dim=16)


def research_config(**over):
    """`tests/test_parallel.py:_tiny_research_cfg` on the port's configs."""
    model = ModelConfig(
        num_items=RESEARCH_ITEMS, max_sequence_len=12, gr_output_length=1, item_embedding_dim=16,
        num_blocks=1, num_heads=2, dqk=8, dv=8, linear_dropout_rate=0.0, dropout_rate=0.0,
        **over.pop("model", {}),
    )
    kw = dict(local_batch_size=RESEARCH_BATCH, eval_batch_size=RESEARCH_BATCH, num_negatives=8,
              sampling_strategy="local", num_workers=0)
    kw.update(over)
    return TrainConfig(model=model, **kw)


RESEARCH_CASES = {
    "local": {},
    "in-batch": dict(sampling_strategy="in-batch"),
    "mol": dict(loss_weights=(("mi_loss", 0.001),), model=dict(interaction_module_type="MoL")),
    # the sampled softmax recomputed in the backward, its normaliser again global
    "loss-checkpoint": dict(loss_activation_checkpoint=True),
}


def research_dataset():
    seqs = synthetic_user_sequences(num_users=64, num_items=RESEARCH_ITEMS, max_len=12, seed=0)
    return SequenceDataset(seqs, max_sequence_length=12, ignore_last_n=1)


class FixedNegatives:
    """Local negatives that depend on the positives only, so that every mesh
    (and the JAX trainer) trains on the same ones."""

    def __init__(self, all_item_ids, sampler, xp):
        self.ids, self.sampler, self.xp = all_item_ids, sampler, xp

    def __call__(self, rng, positive_ids, num_to_sample, item_embedding_fn):
        offsets = (positive_ids[..., None] * 7 + self.xp.arange(num_to_sample) * 13 + 1) % self.ids.shape[0]
        sampled = self.ids[offsets]
        return sampled, self.sampler.normalize_embeddings(item_embedding_fn(sampled))


class FixedInBatchNegatives:
    """In-batch negatives at offsets that depend on the positives and the
    pool's size only."""

    def __init__(self, sampler):
        self.sampler = sampler

    def process_batch(self, **kw):
        return self.sampler.process_batch(**kw)

    def __call__(self, gen, state, positive_ids, num_to_sample):
        r = torch.arange(num_to_sample)
        offsets = (positive_ids[..., None] * 7 + r * 13 + 1) % state.count.clamp_min(1)
        return state.ids[offsets], state.embeddings[offsets]


def inject_negatives(trainer):
    if trainer.cfg.sampling_strategy == "in-batch":
        trainer.sampler = FixedInBatchNegatives(trainer.sampler)
    else:
        trainer.sampler = FixedNegatives(trainer.all_item_ids, trainer.sampler, torch)


def research_trainer(case, init, mesh=None):
    """A research trainer of ``case`` from the weights ``init`` (whole
    tables) with injected negatives; on ``mesh`` a `DistributedTrainer`."""
    from generative_recommenders_tpu_torch.parallel.train import DistributedTrainer

    cfg, ids = research_config(**RESEARCH_CASES[case]), research_dataset().all_item_ids()
    if mesh is None:
        trainer = ResearchTrainer(cfg, ids, device="cpu")
        trainer.model.load_state_dict(init)
    else:
        trainer = DistributedTrainer(cfg, ids, mesh, device="cpu")
        trainer.model.load_state_dict(
            {k: shard_rows(v, mesh) if k in trainer.sharded else v for k, v in init.items()}
        )
    inject_negatives(trainer)
    return trainer


def _exchange(workdir, mesh_shapes):
    data = dict(np.load(os.path.join(workdir, "exchange_in.npz")))
    out = {}
    for shape in mesh_shapes:
        mesh = make_mesh(shape)
        key = f"{shape[0]}x{shape[1]}"
        for impl in ("ragged", "dense"):
            def rows(x):
                return torch.as_tensor(rank_rows(x, mesh.size, mesh.rank))

            for case in ("random", "uneven", "1d"):
                table = torch.as_tensor(data[f"table_{case}"])
                got = t_emb.sharded_lookup(shard_rows(table, mesh), rows(data[f"ids_{case}"]), mesh, impl=impl)
                out[f"{key}/{impl}/{case}"] = got
            shard = shard_rows(torch.as_tensor(data["table_grad"]), mesh).clone().requires_grad_()
            y = t_emb.sharded_lookup(shard, rows(data["ids_grad"]), mesh, impl=impl)
            (y * y).sum().backward()
            out[f"{key}/{impl}/grad"] = shard.grad
            state = t_emb.ShardedEmbeddingState(
                shard_rows(torch.as_tensor(data["table_ada"]), mesh), shard_rows(torch.as_tensor(data["acc_ada"]), mesh)
            )
            new = t_emb.rowwise_adagrad_update(
                state, rows(data["ids_ada"]), rows(data["grads_ada"]), mesh, lr=0.1, impl=impl
            )
            out[f"{key}/{impl}/ada_table"], out[f"{key}/{impl}/ada_acc"] = new
        out[f"{key}/coords"] = torch.tensor(mesh.coords)
    return out


def _ranker(workdir):
    cfg, tables = ranker_configs()
    mesh = make_mesh((2, 2))
    trainer = t_dlrm.DlrmTrainer(cfg, tables, t_dlrm.DlrmTrainConfig(), device="cpu", mesh=mesh)
    trainer.restore(os.path.join(workdir, "ranker_init"), 0)  # whole tables in, this rank's rows kept
    batches = torch.load(os.path.join(workdir, "ranker_batches.pt"), weights_only=False)
    out = {"shard_shapes": {n: tuple(p.shape) for n, p in trainer.model.named_parameters()}}
    calls, lookups = [], []
    real = {name: getattr(dist, name) for name in ("all_to_all_single", "all_gather_into_tensor", "all_reduce")}

    def counting(name):
        def call(*args, **kw):
            t = args[0] if name == "all_reduce" else args[1]
            calls.append((name, tuple(t.shape), str(t.dtype)))
            return real[name](*args, **kw)

        return call

    real_route = t_emb._route

    def route(flat_ids, *args):
        lookups.append(flat_ids.numel())
        return real_route(flat_ids, *args)

    losses = []
    for step, raw in enumerate(batches):
        batch = t_dlrm.to_device(rank_rows(raw, mesh.size, mesh.rank), trainer.device)
        if step == 0:
            for name in real:
                setattr(dist, name, counting(name))
            t_emb._route = route
        loss, preds, labels, weights = trainer.train_step(batch)
        for name, fn in real.items():
            setattr(dist, name, fn)
        t_emb._route = real_route
        losses.append(loss.item())
    out.update(losses=losses, calls=calls, lookups=lookups, preds=preds, state=trainer.state_dict(),
               eval_preds=trainer.eval_step(t_dlrm.to_device(rank_rows(batches[0], mesh.size, mesh.rank),
                                                             trainer.device))[0])
    trainer.save(os.path.join(workdir, "ranker_ckpt"))
    return out


def _research(workdir):
    mesh = make_mesh((1, 2))
    inits = torch.load(os.path.join(workdir, "research_init.pt"))
    batches = torch.load(os.path.join(workdir, "research_batches.pt"), weights_only=False)
    out = {}
    for case in RESEARCH_CASES:
        trainer = research_trainer(case, inits[case], mesh)
        for i, batch in enumerate(batches):
            out[f"{case}/loss{i}"] = trainer.train_step(trainer.to_global_batch(batch)).item()
        out[f"{case}/state"] = trainer.checkpoint_state()["params"]
        out[f"{case}/sharded"] = trainer.sharded
        ranks, _ = trainer.encode_step(trainer.to_global_batch(batches[0]), trainer.item_embeddings())
        out[f"{case}/ranks"] = ranks
    out.update(serve(workdir, make_mesh((2, 1))))
    return out


def serve(workdir, mesh=None):
    """The serving family's dense (int8 tables) and M-FALCON predictions of
    the ranker's first batch, each rank scoring its rows under ``mesh``."""
    from generative_recommenders_tpu_torch.inference.model_family import HSTUModelFamily
    from generative_recommenders_tpu_torch.modules.dlrm_hstu import DlrmHSTU

    cfg, tables = ranker_configs()
    model = DlrmHSTU(cfg, tables)
    model.load_state_dict(torch.load(os.path.join(workdir, "ranker_init_file.pt")))
    family = HSTUModelFamily(model, quantize=True, mesh=mesh)
    raw = torch.load(os.path.join(workdir, "ranker_batches.pt"), weights_only=False)[0]
    uih, ul, cands, nc = family.shard_inputs(t_dlrm.to_device(raw, torch.device("cpu")))
    return {"serve/dense": family.predict(uih, ul, cands, nc),
            "serve/mfalcon": family.predict_mfalcon(uih, ul, cands, cands["item_query_time"][:, 0])}


def main():
    job, world, rank, port, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
    torch.set_num_threads(1)
    initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    if job == "exchange":
        out = {**_exchange(workdir, [(2, 2), (1, 4)]), **{"ranker": _ranker(workdir)}}
    elif job == "research":
        out = _research(workdir)
    else:
        raise ValueError(job)
    torch.save(out, os.path.join(workdir, f"{job}_{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
