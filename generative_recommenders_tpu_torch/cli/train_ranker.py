"""DLRM-v3 ranker training CLI (port of
`generative_recommenders_tpu/cli/train_ranker.py`):

    python -m generative_recommenders_tpu_torch.cli.train_ranker \\
        --dataset debug --mode train --num_batches 50 [--device cpu] \\
        [--tb_log_dir DIR]

Trains on the GPU; ``--device cpu`` trains on the CPU with the kernels'
plain versions. Only the random ``debug`` dataset and ``--mode train`` are
ported. The mesh, checkpoints and eval from them, the trace, the dynamic STU
wrappers, the attention-kernel choice and the distributed flags are not, so
their flags are refused.
"""

from __future__ import annotations

import argparse
import logging
from typing import Any, Dict, List, Optional

from generative_recommenders_tpu_torch.configs.dlrm import (
    get_embedding_table_config,
    get_hstu_configs,
)
from generative_recommenders_tpu_torch.data.dlrm_factory import make_dlrm_batches
from generative_recommenders_tpu_torch.train.dlrm_train import (
    DlrmTrainConfig,
    DlrmTrainer,
    train_loop,
)

logger = logging.getLogger(__name__)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s"
    )
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="debug", choices=["debug"])
    p.add_argument("--mode", default="train", choices=["train"])
    p.add_argument("--num_batches", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--max_uih_len", type=int, default=256)
    p.add_argument("--max_num_candidates", type=int, default=10)
    p.add_argument("--hash_size", type=int, default=100_000)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--tb_log_dir", default=None, help="write TensorBoard scalars here")
    args = p.parse_args(argv)

    hstu_cfg = get_hstu_configs(
        args.dataset, max_uih_len=args.max_uih_len, max_num_candidates=args.max_num_candidates
    )
    tables = get_embedding_table_config(
        args.dataset, hash_size=args.hash_size, dim=hstu_cfg.hstu_embedding_table_dim
    )
    trainer = DlrmTrainer(
        hstu_cfg, tables,
        DlrmTrainConfig(tb_log_dir=args.tb_log_dir),
        device=args.device,
    )
    out = train_loop(
        trainer,
        make_dlrm_batches(
            args.dataset, hstu_cfg, hash_size=args.hash_size,
            batch_size=args.batch_size, num_batches=args.num_batches,
        ),
    )
    logger.info(
        "done: %.1f examples/s; metrics %s",
        out["examples_per_s"], {k: round(v, 5) for k, v in out["metrics"].items()},
    )
    return out


if __name__ == "__main__":
    main()
