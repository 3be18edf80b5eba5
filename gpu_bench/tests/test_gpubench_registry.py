"""Cells, traffic mixes and per-layer metrics are found by name: one added
from new files alone runs, and reports the new metric."""

import json
import os

from harness.registry import find_cell


def test_every_named_piece_has_its_file(checkout):
    bench = json.load(open(os.path.join(checkout, "BENCHMARK.json")))
    hdir = os.path.join(checkout, "gpu_bench")
    for w in bench["workloads"]:
        cell = find_cell(w["name"], checkout=checkout, harness_dir=hdir)
        assert cell.driver and cell.reference
        for m in cell.per_layer:
            mod = cell.metric_module(m["name"])
            # the metric's file states what BENCHMARK.json says of it
            assert (mod.SOURCE, mod.LAYER, mod.MOVES) == (m["source"], m["layer"], m["moves"]), m["name"]


def test_a_cell_a_mix_and_a_metric_from_new_files_only(checkout, run_tiny):
    hdir = os.path.join(checkout, "gpu_bench")
    with open(os.path.join(hdir, "traffic", "tiny_research_short.json"), "w") as f:
        t = json.load(open(os.path.join(hdir, "traffic", "tiny_research.json")))
        t.update(min_len=5, max_len=12)
        json.dump(t, f)
    with open(os.path.join(hdir, "metrics", "steps.per_window.train.py"), "w") as f:
        f.write('"""Steps that ended in the window."""\n\nSOURCE = "host_clock"\nLAYER = "whole step"\n'
                'MOVES = "train_examples_per_s"\n\n\ndef read(run):\n    return float(run.attempted)\n')
    path = os.path.join(checkout, "BENCHMARK.json")
    bench = json.load(open(path))
    bench["workloads"].append({"name": "tiny-research-short", "config": "hstu-tiny",
                               "traffic": "tiny_research_short", "chips": 1, "why": "CPU test"})
    bench["per_layer"].append({"name": "steps.per_window.train", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "whole step", "moves": "train_examples_per_s",
                               "workloads": ["tiny-research-short"]})
    for m in bench["end_to_end"]:
        if m["name"] == "train_examples_per_s":
            m["workloads"].append("tiny-research-short")
    json.dump(bench, open(path, "w"))
    line = run_tiny("tiny-research-short", trace=True)
    assert line["correct"]
    assert line["metrics"]["steps.per_window.train"]["value"] == line["attempted"] > 0
