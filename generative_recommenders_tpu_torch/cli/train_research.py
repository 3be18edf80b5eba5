"""Research training CLI (port of
`generative_recommenders_tpu/cli/train_research.py`): loads a frozen preset
(or the smoke config), builds the dataset from a `sasrec_format.csv`, and
runs the training loop with its periodic full-corpus eval.

    python -m generative_recommenders_tpu_torch.cli.train_research \\
        --preset ml-1m/hstu-sampled-softmax-n128 \\
        --data_csv tmp/ml-1m/sasrec_format.csv [--num_epochs N] [--device cpu]

    python -m generative_recommenders_tpu_torch.cli.train_research --smoke [--num_epochs N]

Trains on the GPU; ``--device cpu`` trains on the CPU with the kernels'
plain versions. Not ported, so their flags are refused: checkpoints
(``--ckpt_dir``), the sharded multi-file corpus (``--multifile_prefix``), the
attention-kernel choice, stochastic length, sequence-length buckets and the
distributed flags. A preset needs ``--data_csv``: the dataset registry that
finds preprocessed files by name is not ported.
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
    SequenceDataset,
    load_sasrec_format_csv,
    synthetic_user_sequences,
)
from generative_recommenders_tpu_torch.models.sequential import ModelConfig
from generative_recommenders_tpu_torch.train.train_loop import TrainConfig, train_loop

logger = logging.getLogger(__name__)


def run_smoke(device: str, num_epochs: int = 4) -> Dict[str, Any]:
    """A tiny synthetic end-to-end run with the relative bias on."""
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
    out = train_loop(cfg, train_ds, eval_ds, log_every=10, device=device)
    logger.info("smoke done: %s", {k: round(float(v), 4) for k, v in out["history"][-1].items()})
    return out


def main(argv: Optional[List[str]] = None) -> Optional[Dict[str, Any]]:
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s"
    )
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default=None)
    p.add_argument("--data_csv", default=None)
    p.add_argument("--num_epochs", type=int, default=None)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--list_presets", action="store_true")
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly: fail at the first NaN in a backward")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    if args.list_presets:
        for k in RESEARCH_PRESETS:
            print(k)
        return None
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    if args.smoke:
        return run_smoke(args.device, args.num_epochs or 4)

    if args.preset not in RESEARCH_PRESETS:
        p.error(f"unknown preset {args.preset}; use --list_presets")
    if not args.data_csv:
        p.error("a preset needs --data_csv (a preprocessed sasrec_format.csv)")
    cfg = RESEARCH_PRESETS[args.preset]
    if args.num_epochs is not None:
        cfg = dataclasses.replace(cfg, num_epochs=args.num_epochs)
    N = cfg.model.max_sequence_len
    seqs = load_sasrec_format_csv(args.data_csv)
    # train ignores each user's last item, eval targets it
    train_ds = SequenceDataset(seqs, max_sequence_length=N, ignore_last_n=1)
    eval_ds = SequenceDataset(seqs, max_sequence_length=N, ignore_last_n=0)
    logger.info("dataset: %d users, %d items; device %s", len(train_ds), cfg.model.num_items, args.device)
    t0 = time.time()
    out = train_loop(cfg, train_ds, eval_ds, device=args.device)
    logger.info("training done in %.1fs", time.time() - t0)
    for m in out["history"][-1:]:
        logger.info("final eval: %s", {k: round(float(v), 4) for k, v in m.items()})
    return out


if __name__ == "__main__":
    main()
