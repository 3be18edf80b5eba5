"""Fixtures of the harness's own tests: a throwaway checkout holding a copy
of the harness, tiny configurations of both models and a `BENCHMARK.json`
naming tiny cells, so that whole runs fit on the CPU."""

import json
import os
import shutil
import sys

import pytest

HARNESS_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(HARNESS_DIR)
for path in (HARNESS_DIR, REPO_DIR):
    if path not in sys.path:
        sys.path.insert(0, path)

TINY_CELLS = {
    # cell: (config, traffic)
    "tiny-research": ("hstu-tiny", "tiny_research"),
    "tiny-offline": ("dlrm-tiny", "tiny_offline"),
    "tiny-server": ("dlrm-tiny", "tiny_server"),
    "tiny-ranker-train": ("dlrm-tiny", "tiny_ranker_train"),
}
E2E = {
    "tiny-research": "train_examples_per_s",
    "tiny-ranker-train": "train_examples_per_s",
    "tiny-offline": "serve_candidates_per_s",
    "tiny-server": "serve_p95_ms",
}


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


def _load(path):
    with open(path) as f:
        return json.load(f)


def _dump(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_checkout(root: str) -> str:
    """A checkout under ``root``: the harness copied, tiny configurations,
    mixes and cells added as new files, every per-layer metric listed."""
    hdir = os.path.join(root, "gpu_bench")
    shutil.copytree(HARNESS_DIR, hdir, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = _load(os.path.join(hdir, "configs", "hstu-ml3b-large.json"))
    cfg["model"].update(num_items=300, max_sequence_len=40, item_embedding_dim=32, num_blocks=2,
                        num_heads=2, dqk=8, dv=8)
    cfg["train"].update(local_batch_size=8, num_negatives=16)
    _dump(cfg, os.path.join(hdir, "configs", "hstu-tiny.json"))
    shutil.copy(os.path.join(hdir, "reference", "hstu-ml3b-large.py"), os.path.join(hdir, "reference", "hstu-tiny.py"))
    d = _load(os.path.join(hdir, "configs", "dlrm-v3.json"))
    d["hash_size"] = 1000
    d["hstu"].update(hstu_num_heads=2, hstu_attn_linear_dim=16, hstu_attn_qk_dim=16, hstu_attn_num_layers=2,
                     hstu_embedding_table_dim=16, hstu_transducer_embedding_dim=32)
    _dump(d, os.path.join(hdir, "configs", "dlrm-tiny.json"))
    shutil.copy(os.path.join(hdir, "reference", "dlrm-v3-train.py"), os.path.join(hdir, "reference", "dlrm-tiny.py"))
    tr = os.path.join(hdir, "traffic")
    t = _load(os.path.join(tr, "research_corpus_2k.json"))
    t.update(num_users=64, min_len=5, max_len=41, num_workers=2, prefetch_factor=4, warmup_steps=1, trace_steps=2)
    _dump(t, os.path.join(tr, "tiny_research.json"))
    small = dict(batch=4, max_uih_len=150, max_num_candidates=6)
    for src, dst, extra in (
        ("ranker_offline_q128", "tiny_offline", dict(qsl_batches=3, checked_queries=2, trace_queries=2)),
        ("ranker_server_poisson", "tiny_server", dict(qsl_batches=3, checked_queries=2, trace_seconds=0.3, qps=20.0)),
        ("ranker_train_b64", "tiny_ranker_train", dict(pool_batches=4, warmup_steps=1, trace_steps=2)),
    ):
        t = _load(os.path.join(tr, src + ".json"))
        t.update(small, **extra)
        _dump(t, os.path.join(tr, dst + ".json"))
    bench = _load(os.path.join(REPO_DIR, "BENCHMARK.json"))
    bench["configs"] += [
        {"name": n, "source": "https://arxiv.org/abs/2402.17152", "file": f"gpu_bench/configs/{n}.json",
         "reduced": [], "why": "a size the CPU tests hold"}
        for n in ("hstu-tiny", "dlrm-tiny")
    ]
    bench["workloads"] += [
        {"name": c, "config": cf, "traffic": tf, "chips": 1, "why": "CPU test"} for c, (cf, tf) in TINY_CELLS.items()
    ]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            tiny = [c for c, e in E2E.items() if e == m.get("moves", m["name"])]
            m["workloads"] = m["workloads"] + tiny
    _dump(bench, os.path.join(root, "BENCHMARK.json"))
    return root


@pytest.fixture(scope="session")
def checkout(tmp_path_factory):
    return make_checkout(str(tmp_path_factory.mktemp("checkout")))


@pytest.fixture
def run_tiny(checkout):
    """Runs a tiny cell of the checkout on the CPU; returns its result line."""
    import time

    from harness.registry import find_cell
    from harness.runner import run_cell

    def run(name, seed=2**31 + 11, seconds=1.0, trace=False):
        cell = find_cell(name, checkout=checkout, harness_dir=os.path.join(checkout, "gpu_bench"))
        return run_cell(cell, seed, seconds, trace, "cpu", time.perf_counter())

    return run
