"""A per-layer metric added as a reader file and a manifest entry, with
no existing file edited, is read in the cells it names."""

import io
import json
import time

import torch

from benchmark import harness

from conftest import SMALL_CELL


def test_new_metric_is_read(small_root):
    (small_root / "benchmark" / "metrics" / "recover_s.solve.py").write_text(
        "def read(run):\n"
        "    v = [p.outcome.timings['recover_s'] for p in run.problems]\n"
        "    return sum(v) / len(v)\n")
    manifest = json.loads((small_root / "BENCHMARK.json").read_text())
    manifest["per_layer"].append({
        "name": "recover_s.solve", "unit": "s", "better": "lower",
        "source": "program_span", "layer": "methods/cells_last.py recovery",
        "moves": "time_to_solution_s", "workloads": [SMALL_CELL]})
    (small_root / "BENCHMARK.json").write_text(json.dumps(manifest))
    result, _ = harness.measure(small_root, SMALL_CELL, 9, 0.0, True,
                                time.perf_counter(),
                                device=torch.device("cpu"),
                                stderr=io.StringIO())
    assert result["metrics"]["recover_s.solve"]["value"] > 0
    assert result["metrics"]["recover_s.solve"]["unit"] == "s"
