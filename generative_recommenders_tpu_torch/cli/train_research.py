"""Research training CLI (port of
`generative_recommenders_tpu/cli/train_research.py`): loads a frozen preset
(or the smoke config), builds its dataset, and runs the training loop with
its periodic full-corpus eval and checkpoints.

    python -m generative_recommenders_tpu_torch.cli.train_research \\
        --preset ml-1m/hstu-sampled-softmax-n128 [--num_epochs N] [--device cpu] \\
        [--data_csv tmp/ml-1m/sasrec_format.csv | --multifile_prefix tmp/ml-3b/16x32] \\
        [--ckpt_dir ckpts/ml-1m [--save_ckpt_every_n 10]]

    python -m generative_recommenders_tpu_torch.cli.train_research --smoke [--num_epochs N]

    python -m generative_recommenders_tpu_torch.cli.train_research --preset ... --distributed \\
        --coordinator HOST:PORT --num_processes P --process_id K [--dist_backend gloo] [--max_steps S]

The dataset: a `sasrec_format.csv` (``--data_csv``), a sharded
fractal-expansion corpus (``--multifile_prefix``; its ids are 0-based, as
the registry's ml-3b reads them), or else the registry's files for the
preset's dataset under ``tmp/`` (`data/reco_dataset.py:get_reco_dataset`).
With ``--ckpt_dir`` the loop saves ``{params, opt_state}`` every
``--save_ckpt_every_n`` epochs and once more at the end (step = epochs).
Any preset trains, the SASRec baselines included; with a preset,
``--stochastic_length_alpha`` and ``--seq_len_buckets 64,128,200`` override
its stochastic length and length buckets (the smoke run keeps its own
config, as in the JAX CLI). Trains on the GPU; ``--device cpu`` trains on
the CPU with the kernels' plain versions. ``--max_steps`` ends the run
after that many steps (and its eval). The attention-kernel choice is not a
flag: on the card the kernels run.

``--distributed`` joins a process group (as `cli/train_ranker.py` does)
and trains data-parallel over all its ranks, as the JAX CLI does
(`parallel/train.py:distributed_train_loop`): the preset's batch sizes are
the global batches', of which each rank trains on its rows. A failed
initialisation raises rather than training alone.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import time
from typing import Any, Dict, List, Optional

import torch

from generative_recommenders_tpu_torch.configs.research import RESEARCH_PRESETS
from generative_recommenders_tpu_torch.data.dataset import (
    MultiFileSequenceDataset,
    SequenceDataset,
    load_sasrec_format_csv,
    synthetic_user_sequences,
)
from generative_recommenders_tpu_torch.data.reco_dataset import get_reco_dataset
from generative_recommenders_tpu_torch.models.sequential import ModelConfig
from generative_recommenders_tpu_torch.parallel.distributed import initialize_distributed
from generative_recommenders_tpu_torch.parallel.train import distributed_train_loop
from generative_recommenders_tpu_torch.train.train_loop import TrainConfig, train_loop

logger = logging.getLogger(__name__)


def run_smoke(device: str, num_epochs: int = 4, distributed: bool = False) -> Dict[str, Any]:
    """A tiny synthetic end-to-end run with the relative bias on (on every
    rank of the process group with ``distributed``)."""
    seqs = synthetic_user_sequences(num_users=256, num_items=200, max_len=32, seed=0)
    train_ds = SequenceDataset(seqs, max_sequence_length=32, ignore_last_n=1)
    eval_ds = SequenceDataset(seqs, max_sequence_length=32, ignore_last_n=0)
    cfg = TrainConfig(
        model=ModelConfig(
            num_items=200, max_sequence_len=32, gr_output_length=1,
            item_embedding_dim=32, num_blocks=2, num_heads=2, dqk=16, dv=16,
        ),
        local_batch_size=32,
        eval_batch_size=32,
        num_epochs=num_epochs,
        num_negatives=32,
    )
    loop = distributed_train_loop if distributed else train_loop
    out = loop(cfg, train_ds, eval_ds, log_every=10, device=device)
    logger.info("smoke done: %s", {k: round(float(v), 4) for k, v in out["history"][-1].items()})
    return out


def main(argv: Optional[List[str]] = None) -> Optional[Dict[str, Any]]:
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s"
    )
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default=None)
    p.add_argument("--data_csv", default=None)
    p.add_argument("--multifile_prefix", default=None,
                   help="sharded fractal-expansion corpus prefix, e.g. tmp/ml-3b/16x32")
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--save_ckpt_every_n", type=int, default=10)
    p.add_argument("--num_epochs", type=int, default=None)
    p.add_argument("--stochastic_length_alpha", type=float, default=None,
                   help="stochastic length's alpha; 0 = off")
    p.add_argument("--seq_len_buckets", default=None,
                   help="comma-separated length buckets, e.g. 64,128,200")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--list_presets", action="store_true")
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly: fail at the first NaN in a backward")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--coordinator", default=None, help="HOST:PORT of rank 0")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"],
                   help="default: nccl on the card, gloo on the CPU")
    args = p.parse_args(argv)
    if not args.distributed and (args.coordinator or args.num_processes or args.process_id is not None):
        p.error("--coordinator, --num_processes and --process_id need --distributed")

    if args.list_presets:
        for k in RESEARCH_PRESETS:
            print(k)
        return None
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    if args.distributed:
        initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                               backend=args.dist_backend, device=args.device)
    if args.smoke:
        return run_smoke(args.device, args.num_epochs or 4, distributed=args.distributed)

    if args.preset not in RESEARCH_PRESETS:
        p.error(f"unknown preset {args.preset}; use --list_presets")
    overrides: Dict[str, Any] = {}
    if args.num_epochs is not None:
        overrides["num_epochs"] = args.num_epochs
    if args.stochastic_length_alpha is not None:
        overrides["stochastic_length_alpha"] = args.stochastic_length_alpha
    if args.seq_len_buckets is not None:
        overrides["seq_len_buckets"] = tuple(int(x) for x in args.seq_len_buckets.split(","))
    cfg = dataclasses.replace(RESEARCH_PRESETS[args.preset], **overrides)
    N = cfg.model.max_sequence_len
    # train ignores each user's last item, eval targets it
    if args.multifile_prefix:
        train_ds, eval_ds = (
            MultiFileSequenceDataset(
                args.multifile_prefix, max_sequence_length=N, ignore_last_n=n, shift_id_by=1,
                num_items_hint=cfg.model.num_items,
            )
            for n in (1, 0)
        )
    elif args.data_csv:
        seqs = load_sasrec_format_csv(args.data_csv)
        train_ds, eval_ds = (SequenceDataset(seqs, max_sequence_length=N, ignore_last_n=n) for n in (1, 0))
    else:
        reco = get_reco_dataset(args.preset.split("/")[0], N)
        train_ds, eval_ds = reco.train_dataset, reco.eval_dataset
    logger.info("dataset: %d users, %d items; device %s", len(train_ds), cfg.model.num_items, args.device)
    t0 = time.time()
    out = (distributed_train_loop if args.distributed else train_loop)(
        cfg, train_ds, eval_ds, device=args.device, ckpt_dir=args.ckpt_dir, max_steps=args.max_steps,
        save_ckpt_every_n=args.save_ckpt_every_n if args.ckpt_dir else 0,
    )
    logger.info("training done in %.1fs", time.time() - t0)
    if args.ckpt_dir:
        out["trainer"].save(args.ckpt_dir, cfg.num_epochs)
        logger.info("checkpoint %d -> %s", cfg.num_epochs, args.ckpt_dir)
    for m in out["history"][-1:]:
        logger.info("final eval: %s", {k: round(float(v), 4) for k, v in m.items()})
    return out


if __name__ == "__main__":
    main()
