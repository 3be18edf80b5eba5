"""Serving benchmark harness, MLPerf style (port of
`generative_recommenders_tpu/inference/main.py`): builds the DlrmHSTU model
family (int8 sparse + dense) from a seed or a trained checkpoint, warms up,
runs the C++ load generator in the chosen scenario, and reports qps and
latency percentiles; or, with ``--accuracy``, scores every query sample once
and reports NE / AUC (MSE for a regression task) against the dataset's
supervision.

    python -m generative_recommenders_tpu_torch.inference.main \\
        --scenario Offline --num_queries 64 --batch_size 8 [--mfalcon]

    python -m generative_recommenders_tpu_torch.inference.main --accuracy \\
        --dataset movielens-1m --data_file tmp/ml-1m/sasrec_format.csv \\
        --ckpt_dir DIR --hash_size 100000 --max_uih_len 256 --batch_size 32

``--dataset`` is the random ``debug`` set or a preprocessed public one
(`data/dlrm_factory.py`); a real dataset's partial last batch is dropped.
``--ckpt_dir`` loads the ranker trainer's latest checkpoint (the tables are
quantized from it), so the model's sizes must be the trainer's. Runs on the
GPU; ``--device cpu`` runs it on the CPU with the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
from typing import Dict, List, Optional

import torch

from generative_recommenders_tpu_torch.configs.dlrm import (
    get_embedding_table_config,
    get_hstu_configs,
)
from generative_recommenders_tpu_torch.data.dlrm_factory import make_dlrm_batches
from generative_recommenders_tpu_torch.inference.data_producer import (
    MultiThreadDataProducer,
    SingleThreadDataProducer,
)
from generative_recommenders_tpu_torch.inference.loadgen import (
    Scenario,
    TestSettings,
    query_complete,
    start_test,
)
from generative_recommenders_tpu_torch.inference.model_family import HSTUModelFamily
from generative_recommenders_tpu_torch.modules.dlrm_hstu import DlrmHSTU
from generative_recommenders_tpu_torch.modules.multitask_module import (
    get_supervision_labels_and_weights,
)
from generative_recommenders_tpu_torch.ops.padded import valid_mask
from generative_recommenders_tpu_torch.train.dlrm_metrics import MetricsLogger
from generative_recommenders_tpu_torch.utils.checkpoint import restore_checkpoint

logger = logging.getLogger(__name__)

_SCENARIOS = {
    "Offline": "OFFLINE",
    "Server": "SERVER",
    "SingleStream": "SINGLE_STREAM",
    "MultiStream": "MULTI_STREAM",
}


def _parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--scenario", default="Offline", choices=list(_SCENARIOS))
    p.add_argument(
        "--samples_per_query", type=int, default=8, help="MultiStream: samples per query"
    )
    p.add_argument(
        "--target_latency_ms", type=float, default=0.0,
        help="per-query latency bound (0 = unconstrained); enables early "
        "stopping for the stream scenarios",
    )
    p.add_argument(
        "--accuracy", action="store_true",
        help="accuracy mode: every query sample once, predictions logged, NE/AUC reported",
    )
    p.add_argument("--accuracy_log", default="build/accuracy_log.json")
    p.add_argument("--target_qps", type=float, default=20.0)
    p.add_argument("--num_queries", type=int, default=64)
    p.add_argument("--min_duration_ms", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_uih_len", type=int, default=128)
    p.add_argument("--max_num_candidates", type=int, default=10)
    p.add_argument("--hash_size", type=int, default=10000)
    p.add_argument("--num_warmups", type=int, default=2)
    p.add_argument("--data_producer_threads", type=int, default=1)
    p.add_argument("--mfalcon", action="store_true", help="KV-cached scoring")
    p.add_argument(
        "--candidates_per_chunk", type=int, default=0,
        help="M-FALCON chunk size (max_num_candidates_inference); 0 = config default",
    )
    p.add_argument("--no_quantize", action="store_true")
    p.add_argument("--dataset", default="debug",
                   choices=["debug", "movielens-1m", "movielens-20m", "kuairand-1k"],
                   help="serve a preprocessed public dataset instead of the random one")
    p.add_argument("--data_file", default=None)
    p.add_argument("--ckpt_dir", default=None,
                   help="serve the ranker trainer's latest checkpoint in this directory")
    p.add_argument("--num_qsl_batches", type=int, default=8)
    # model-size overrides (0 = the preset's value)
    p.add_argument("--num_layers", type=int, default=0)
    p.add_argument("--transducer_dim", type=int, default=0)
    p.add_argument("--table_dim", type=int, default=0)
    p.add_argument("--attn_dim", type=int, default=0)
    p.add_argument("--num_heads", type=int, default=0)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s"
    )
    args = _parse(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        # never a silent fall back to the CPU
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu to run on the CPU"
        )
    cfg = get_hstu_configs(
        args.dataset, max_uih_len=args.max_uih_len, max_num_candidates=args.max_num_candidates
    )
    if args.candidates_per_chunk:
        cfg = dataclasses.replace(cfg, max_num_candidates_inference=args.candidates_per_chunk)
    overrides = {
        "hstu_attn_num_layers": args.num_layers,
        "hstu_transducer_embedding_dim": args.transducer_dim,
        "hstu_embedding_table_dim": args.table_dim,
        "hstu_attn_qk_dim": args.attn_dim,
        "hstu_attn_linear_dim": args.attn_dim,
        "hstu_num_heads": args.num_heads,
    }
    overrides = {k: v for k, v in overrides.items() if v}
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    tables = get_embedding_table_config(
        args.dataset, hash_size=args.hash_size, dim=cfg.hstu_embedding_table_dim
    )
    with torch.device(device):
        model = DlrmHSTU(cfg, tables, torch.Generator(device).manual_seed(0))
    if args.ckpt_dir:
        model.load_state_dict(restore_checkpoint(args.ckpt_dir, device))
        logger.info("restored trained parameters from %s", args.ckpt_dir)
    family = HSTUModelFamily(model, quantize=not args.no_quantize)

    # fixed query set (the QSL); queries cycle through pre-made batches
    def to_device(features):
        return {k: torch.as_tensor(v, device=device) for k, v in features.items()}

    samples, live = [], []  # live: the real (not padded) candidates of each batch
    for u, ul, c, nc in make_dlrm_batches(
        args.dataset, cfg, data_file=args.data_file, hash_size=args.hash_size,
        batch_size=args.batch_size, num_batches=args.num_qsl_batches,
    ):
        if ul.shape[0] != args.batch_size:  # a real dataset's partial last batch
            continue
        samples.append((to_device(u), torch.as_tensor(ul, device=device), to_device(c),
                        torch.as_tensor(nc, device=device)))
        live.append(int(nc.sum()))
    if not samples:
        raise ValueError(f"{args.dataset}: no full batch of {args.batch_size} samples")

    def predict(sample):
        s_uih, s_ul, s_cands, s_nc = sample
        if args.mfalcon:
            qt = s_cands[cfg.candidates_querytime_feature_name][:, 0]
            preds = family.predict_mfalcon(s_uih, s_ul, s_cands, qt)
        else:
            preds = family.predict(s_uih, s_ul, s_cands, s_nc)
        if device.type == "cuda":
            # latency covers the device's completion
            torch.cuda.synchronize(device)
        return preds

    logger.info("warmup x%d", args.num_warmups)
    for i in range(args.num_warmups):
        predict(samples[i % len(samples)])

    if args.accuracy:
        return _run_accuracy(args, cfg, samples, predict)
    if args.data_producer_threads > 1:
        producer = MultiThreadDataProducer(predict, args.data_producer_threads)
    else:
        producer = SingleThreadDataProducer(predict)

    def issue_query(qid: int) -> None:
        producer.enqueue(
            qid, samples[qid % len(samples)], lambda q, _preds: query_complete(q)
        )

    scenario = Scenario[_SCENARIOS[args.scenario]]
    batches_per_query = 1
    if scenario == Scenario.MULTI_STREAM:
        # one query = samples_per_query samples, run as consecutive batches
        # inside one completion window
        batches_per_query = max(1, -(-args.samples_per_query // args.batch_size))

        def issue_query(qid: int) -> None:  # noqa: F811
            def run_group(q):
                for j in range(1, batches_per_query):
                    predict(samples[(q + j) % len(samples)])
                query_complete(q)

            producer.enqueue(
                qid, samples[qid % len(samples)], lambda q, _preds: run_group(q)
            )

    # MLPerf latency percentiles: p90 SingleStream, p99 MultiStream/Server
    pct = 0.9 if scenario == Scenario.SINGLE_STREAM else 0.99
    try:
        result = start_test(
            TestSettings(
                scenario=scenario,
                target_qps=args.target_qps,
                min_query_count=args.num_queries,
                min_duration_ms=args.min_duration_ms,
                target_latency_ms=args.target_latency_ms,
                target_percentile=pct,
                samples_per_query=args.samples_per_query,
            ),
            issue_query,
        )
    finally:
        producer.shutdown()
    # queries are numbered 0..query_count-1 and query q serves batches
    # q .. q+batches_per_query-1; only real candidates count, not the padding
    # up to max_num_candidates
    n = int(result["query_count"])
    scored = sum(live[(q + j) % len(samples)] for q in range(n) for j in range(batches_per_query))
    result["scored_candidates_per_s"] = result["qps"] * scored / n if n else 0.0
    logger.info(
        "scenario=%s device=%s result: %s", args.scenario, device,
        {k: round(v, 3) for k, v in result.items()},
    )
    print(result)
    return result


def _run_accuracy(args, cfg, samples, predict) -> Dict[str, float]:
    """Every QSL sample once, on this thread (the reference runs accuracy
    with one producer thread); predictions logged to ``--accuracy_log`` as
    JSON, NE / AUC (MSE) against the candidates' supervision."""
    metrics = MetricsLogger(cfg.multitask_configs)
    log = []
    for qid, sample in enumerate(samples):
        _, _, s_cands, s_nc = sample
        preds = predict(sample)  # [T, B, M]
        labels_d, weights_d = get_supervision_labels_and_weights(
            s_cands[cfg.candidates_weight_feature_name],
            s_cands[cfg.candidates_watchtime_feature_name],
            cfg.multitask_configs,
        )
        valid = valid_mask(s_nc, cfg.max_num_candidates).float()
        labels = torch.stack([labels_d[t.task_name] for t in cfg.multitask_configs])
        weights = torch.stack(
            [weights_d.get(t.task_name, valid) * valid for t in cfg.multitask_configs]
        )
        metrics.update(preds, labels, weights)
        log.append({"qsl_idx": qid, "data": preds.float().reshape(-1).tolist()})
    os.makedirs(os.path.dirname(args.accuracy_log) or ".", exist_ok=True)
    with open(args.accuracy_log, "w") as f:
        json.dump(log, f)
    m = metrics.compute()
    logger.info(
        "accuracy mode: %d samples -> %s; log at %s",
        len(samples), {k: round(v, 5) for k, v in m.items()}, args.accuracy_log,
    )
    print({"accuracy": {k: round(v, 5) for k, v in m.items()}})
    return m


if __name__ == "__main__":
    main()
