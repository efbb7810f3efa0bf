"""The eight per-layer metrics that read the program's CG and V-cycle
spans: read in a traced CPU run at 16^2 with the tiny cell appended to
their ``workloads`` (the manifest names only the 1024^2 cells), and left
out, without raising, on a program whose timings lack the spans."""

import io
import json
import math
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness

from conftest import REPO, SMALL_CELL

SPAN_METRICS = ("cg_wait_ms.solve", "cg_apply_ms.solve",
                "cg_vector_ms.solve", "vcycle_ms.solve",
                "vcycle_fine_ms.solve", "vcycle_smooth_ms.solve",
                "face_system_s.solve", "solve_self_s.solve")
# the phase spans of a program without the CG and V-cycle spans
PHASES_ONLY = {"classify_s": 0.5, "assembly_s": 0.2,
               "assemble_coarse_s": 0.9, "mg_setup_s": 0.4,
               "setup_s": 1.0, "cg_s": 15.0, "recover_s": 0.001,
               "h1_s": 0.2}


def test_span_metrics_are_read(small_root):
    path = small_root / "BENCHMARK.json"
    manifest = json.loads(path.read_text())
    for m in manifest["per_layer"]:
        if m["name"] in SPAN_METRICS:
            m["workloads"].append(SMALL_CELL)
    path.write_text(json.dumps(manifest))
    result, _ = harness.measure(small_root, SMALL_CELL, 2**31 + 12345, 0.0,
                                True, time.perf_counter(),
                                device=torch.device("cpu"),
                                stderr=io.StringIO())
    assert result["correct"] is True
    metrics = result["metrics"]
    units = {m["name"]: m["unit"] for m in manifest["per_layer"]}
    for name in SPAN_METRICS:
        value = metrics[name]["value"]
        assert math.isfinite(value) and value > 0, name
        assert metrics[name]["unit"] == units[name]
    assert metrics["vcycle_fine_ms.solve"]["value"] <= \
        metrics["vcycle_ms.solve"]["value"] <= \
        metrics["cg_iter_ms.solve"]["value"]
    assert metrics["vcycle_smooth_ms.solve"]["value"] <= \
        metrics["vcycle_ms.solve"]["value"]


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_metric_without_the_spans(name):
    problem = SimpleNamespace(outcome=SimpleNamespace(
        iterations=250, timings=dict(PHASES_ONLY)))
    run = harness.Run(20.0, 40.0, [problem, problem], 0)
    value = harness.load_module(
        REPO / "benchmark" / "metrics" / f"{name}.py").read(run)
    # the face system's span is one of the phases
    assert value == (PHASES_ONLY["setup_s"]
                     if name == "face_system_s.solve" else None)
