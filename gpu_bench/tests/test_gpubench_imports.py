"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
references import nothing of the program. Names are compared by their whole
top-level part: the port's name begins with the JAX package's."""

import ast
import glob
import os
import subprocess
import sys

from harness.runner import FORBIDDEN, forbidden_modules

HARNESS_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "generative_recommenders_tpu_torch"


def _top_level_imports(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources():
    return [p for p in glob.glob(os.path.join(HARNESS_DIR, "**", "*.py"), recursive=True)
            if os.sep + "tests" + os.sep not in p]


def test_no_jax_in_the_harness():
    for path in _sources():
        assert not (_top_level_imports(path) & set(FORBIDDEN)), path


def test_the_references_import_nothing_of_the_program():
    for path in glob.glob(os.path.join(HARNESS_DIR, "reference", "*.py")):
        names = _top_level_imports(path)
        assert PORT not in names and not (names & set(FORBIDDEN)), path
        assert "harness" not in names, path  # the reference stands alone


def test_the_check_compares_whole_top_level_names():
    sys.modules["generative_recommenders_tpu_torch_probe"] = sys.modules[__name__]
    try:
        assert "generative_recommenders_tpu_torch_probe" not in forbidden_modules()
        sys.modules["jax.probe"] = sys.modules[__name__]
        assert "jax.probe" in forbidden_modules()
    finally:
        sys.modules.pop("generative_recommenders_tpu_torch_probe", None)
        sys.modules.pop("jax.probe", None)


def test_a_tiny_run_loads_no_jax(checkout):
    """A whole run in a process of its own, then its modules checked."""
    code = (
        "import sys, time; sys.path[:0] = [%r, %r]\n"
        "from harness.registry import find_cell\nfrom harness.runner import run_cell, forbidden_modules\n"
        "c = find_cell('tiny-offline', checkout=%r, harness_dir=%r)\n"
        "line = run_cell(c, 7, 0.5, False, 'cpu', time.perf_counter())\n"
        "assert line['correct'], line\nprint('FOUND', forbidden_modules())\n"
    ) % (HARNESS_DIR, os.path.dirname(HARNESS_DIR), checkout, os.path.join(checkout, "gpu_bench"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout


def test_without_the_program_or_a_card_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and the harness, run.py exits
    with another code than 0 and prints no result line."""
    import shutil

    shutil.copytree(HARNESS_DIR, tmp_path / "gpu_bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(os.path.dirname(HARNESS_DIR), "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "gpu_bench/run.py", "--workload", "ml3b-train", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
