"""On the card: each cell's control (the reference in TF32, the precision
below the configurations' float32) reads well above the program's sound
runs, at a size a test run holds. The cells' own sizes are read by
`gpu_bench/control.py` (PERF.md gives those readings)."""

import os
import time

import pytest
import torch

from harness.registry import find_cell
from harness.runner import run_cell

CELLS = ["tiny-research", "tiny-ranker-train", "tiny-offline"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_control_reads_above_the_program(checkout, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = find_cell(name, checkout=checkout, harness_dir=os.path.join(checkout, "gpu_bench"))
    seed = 2**31 + 101
    line = run_cell(cell, seed, 1.0, False, "cuda", time.perf_counter())
    assert line["correct"], line["checks"]
    control = cell.driver.control(cell, seed, "cuda")["tf32"]
    program = {k: v["value"] for k, v in line["checks"].items()}
    assert any(control[k] > 3 * program[k] for k in control), (control, program)
