"""Serving benchmark harness, MLPerf style (port of
`generative_recommenders_tpu/inference/main.py`): builds the DlrmHSTU model
family (int8 sparse + dense) from a seed, warms up, runs the C++ load
generator in the chosen scenario, and reports qps and latency percentiles.

    python -m generative_recommenders_tpu_torch.inference.main \\
        --scenario Offline --num_queries 64 --batch_size 8 [--mfalcon]

Runs on the GPU; ``--device cpu`` runs it on the CPU with the kernels'
plain versions. Accuracy mode, the real datasets and checkpoint restore are
not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
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
        "debug", max_uih_len=args.max_uih_len, max_num_candidates=args.max_num_candidates
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
        "debug", hash_size=args.hash_size, dim=cfg.hstu_embedding_table_dim
    )
    with torch.device(device):
        model = DlrmHSTU(cfg, tables, torch.Generator(device).manual_seed(0))
    family = HSTUModelFamily(model, quantize=not args.no_quantize)

    # fixed query set (the QSL); queries cycle through pre-made batches
    def to_device(features):
        return {k: torch.as_tensor(v, device=device) for k, v in features.items()}

    samples, live = [], []  # live: the real (not padded) candidates of each batch
    for u, ul, c, nc in make_dlrm_batches(
        "debug", cfg, hash_size=args.hash_size, batch_size=args.batch_size,
        num_batches=args.num_qsl_batches,
    ):
        samples.append((to_device(u), torch.as_tensor(ul, device=device), to_device(c),
                        torch.as_tensor(nc, device=device)))
        live.append(int(nc.sum()))

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


if __name__ == "__main__":
    main()
