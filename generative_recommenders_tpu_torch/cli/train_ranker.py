"""DLRM-v3 ranker training CLI (port of
`generative_recommenders_tpu/cli/train_ranker.py`):

    python -m generative_recommenders_tpu_torch.cli.train_ranker \\
        --dataset debug --mode train --num_batches 50 [--device cpu] \\
        [--tb_log_dir DIR] [--ckpt_dir DIR] [--output_trace] [--debug_nans] \\
        [--stochastic_depth 0.1] [--l2_max_len 128] \\
        [--mesh DxM] [--distributed --coordinator HOST:PORT --num_processes P --process_id K \\
         [--dist_backend gloo]]

    python -m generative_recommenders_tpu_torch.cli.train_ranker \\
        --dataset movielens-1m --data_file tmp/ml-1m/sasrec_format.csv \\
        --mode eval --ckpt_dir DIR

``--dataset`` is the random ``debug`` set or a preprocessed public one
(`data/dlrm_factory.py`; ``--data_file`` defaults to the preprocess CLIs'
output). With ``--ckpt_dir``, training starts from the latest checkpoint
there and saves one at its end; ``--mode eval`` restores it and evaluates
(NE, AUC or MSE per task) on the dataset in file order. Trains on the GPU;
``--device cpu`` trains on the CPU with the kernels' plain versions.
``--stochastic_depth`` and ``--l2_max_len`` wrap the STU layers
(`modules/dynamic_stu.py`); ``--output_trace`` writes a Chrome trace of
steps 30 to 34 under ``tmp/trace``; ``--debug_nans`` runs the steps under
`torch.autograd.detect_anomaly(check_nan=True)`, which stops at the first
operation whose backward gives a NaN.

``--distributed`` joins a process group of ``--num_processes`` ranks at
``--coordinator`` (without one, ``env://`` reads what ``torchrun`` sets;
`parallel/distributed.py`): NCCL on the card, gloo on the CPU, or
``--dist_backend`` (gloo runs several ranks on one card). ``--mesh DxM``
lays the ranks out as d data rows of m model ranks (default: every rank on
the data axis); the product must be the number of ranks, and a failed
initialisation raises rather than training alone. Each rank reads its own
``--batch_size`` rows of every global batch of ``--batch_size`` x ranks
(ranks share one stream and keep disjoint slices of it), so a run of P
ranks trains on the batches of a one-rank run with P times the batch size.
The attention-kernel choice is not a flag: on the card the kernels run.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import logging
from typing import Any, Dict, List, Optional

import torch

from generative_recommenders_tpu_torch.configs.dlrm import (
    get_embedding_table_config,
    get_hstu_configs,
)
from generative_recommenders_tpu_torch.data.dlrm_factory import make_dlrm_batches
from generative_recommenders_tpu_torch.parallel.distributed import host_batch_shard, initialize_distributed
from generative_recommenders_tpu_torch.parallel.mesh import make_mesh, parse_mesh
from generative_recommenders_tpu_torch.parallel.sharding import shard_batches
from generative_recommenders_tpu_torch.train.dlrm_train import (
    DlrmTrainConfig,
    DlrmTrainer,
    eval_loop,
    train_loop,
)

logger = logging.getLogger(__name__)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s"
    )
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="debug",
                   choices=["debug", "movielens-1m", "movielens-20m", "kuairand-1k"])
    p.add_argument("--mode", default="train", choices=["train", "eval"])
    p.add_argument("--data_file", default=None,
                   help="the dataset's csv (sasrec_format.csv for movielens, processed_seqs.csv "
                   "for kuairand); defaults to the preprocess CLIs' output")
    p.add_argument("--num_batches", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--max_uih_len", type=int, default=256)
    p.add_argument("--max_num_candidates", type=int, default=10)
    p.add_argument("--hash_size", type=int, default=100_000)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--tb_log_dir", default=None, help="write TensorBoard scalars here")
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--output_trace", action="store_true")
    p.add_argument("--stochastic_depth", type=float, default=0.0)
    p.add_argument("--l2_max_len", type=int, default=0)
    p.add_argument("--debug_nans", action="store_true")
    p.add_argument("--mesh", default=None, help="e.g. 4x2 (data x model)")
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--coordinator", default=None, help="HOST:PORT of rank 0")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"],
                   help="default: nccl on the card, gloo on the CPU")
    args = p.parse_args(argv)
    if args.mode == "eval" and not args.ckpt_dir:
        p.error("--mode eval needs --ckpt_dir")
    mesh = _mesh(p, args)
    world, rank = host_batch_shard()

    hstu_cfg = dataclasses.replace(
        get_hstu_configs(args.dataset, max_uih_len=args.max_uih_len, max_num_candidates=args.max_num_candidates),
        hstu_stochastic_depth_ratio=args.stochastic_depth, hstu_l2_max_len=args.l2_max_len,
    )
    tables = get_embedding_table_config(
        args.dataset, hash_size=args.hash_size, dim=hstu_cfg.hstu_embedding_table_dim
    )
    trainer = DlrmTrainer(
        hstu_cfg, tables,
        DlrmTrainConfig(tb_log_dir=args.tb_log_dir if rank == 0 else None, ckpt_dir=args.ckpt_dir,
                        output_trace=args.output_trace),
        device=args.device, mesh=mesh,
    )
    batches = shard_batches(make_dlrm_batches(
        args.dataset, hstu_cfg, data_file=args.data_file, hash_size=args.hash_size,
        batch_size=args.batch_size * world, num_batches=args.num_batches, shuffle=args.mode == "train",
    ), world, rank)
    if args.mode == "eval":
        trainer.restore(args.ckpt_dir)
        metrics = eval_loop(trainer, batches)
        logger.info("eval metrics: %s", {k: round(v, 5) for k, v in metrics.items()})
        return {"metrics": metrics}
    with torch.autograd.detect_anomaly(check_nan=True) if args.debug_nans else contextlib.nullcontext():
        out = train_loop(trainer, batches)
    logger.info(
        "done: %.1f examples/s; metrics %s",
        out["examples_per_s"], {k: round(v, 5) for k, v in out["metrics"].items()},
    )
    return {**out, "trainer": trainer}


def _mesh(p: argparse.ArgumentParser, args):
    """Joins the process group under ``--distributed`` and lays its ranks
    out as ``--mesh``; None without either flag. A mesh that does not fit the
    number of ranks is an argument error."""
    if not args.distributed and (args.coordinator or args.num_processes or args.process_id is not None):
        p.error("--coordinator, --num_processes and --process_id need --distributed")
    if args.distributed:
        initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                               backend=args.dist_backend, device=args.device)
    world = host_batch_shard()[0]
    shape = parse_mesh(args.mesh) if args.mesh else (world, 1)
    if shape[0] * shape[1] != world:
        p.error(f"--mesh {args.mesh} needs {shape[0] * shape[1]} ranks; there are {world}")
    return make_mesh(shape) if args.distributed or args.mesh else None


if __name__ == "__main__":
    main()
