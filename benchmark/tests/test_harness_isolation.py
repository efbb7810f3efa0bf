"""Nothing the benchmark runs loads JAX or the JAX package, checked by
whole top-level module names; the reference imports nothing of the
program; a run without a card prints no result."""

import ast
import subprocess
import sys
import types

from benchmark import harness

from conftest import REPO

BENCH = REPO / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "proton_tpu"}


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_of_the_benchmark_imports_jax():
    for path in BENCH.rglob("*.py"):
        assert not FORBIDDEN.intersection(top_level_imports(path)), path


def test_reference_imports_numpy_and_torch_only():
    for path in (BENCH / "reference").rglob("*.py"):
        assert set(top_level_imports(path)) <= {
            "__future__", "functools", "typing", "numpy", "torch"}, path


def test_top_level_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "proton_tpu_torch_fake",
                        types.ModuleType("proton_tpu_torch_fake"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "proton_tpu.cut",
                        types.ModuleType("proton_tpu.cut"))
    assert harness.forbidden_modules() == ["proton_tpu"]


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(harness, "measure",
                        lambda *a, **k: ({"correct": True}, []))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.main(["--workload", "x", "--seed", "1", "--seconds", "1"],
                        0.0, REPO) == 3
    out, err = capsys.readouterr()
    assert out == "" and "jax" in err


def test_without_a_card_no_result(tmp_path):
    """Here there is no CUDA device: the run refuses, prints no result,
    and has no CPU fallback; likewise from a folder holding only the
    manifest and the benchmark's files."""
    import shutil
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for root in (REPO, tmp_path):
        p = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload",
             "cuthho_1024_k1.solve", "--seed", "1", "--seconds", "1",
             "--trace", "0"], cwd=root, capture_output=True, text=True,
            timeout=120)
        assert p.returncode != 0 and p.stdout == ""
