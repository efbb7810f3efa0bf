"""vcycle_graph_pct.solve, the share of the V-cycle calls that replayed
the program's CUDA graph: read from the program's counters where they
are there, and left out, without raising, where they are not (the CPU,
where no graph is captured, or a program without the graph)."""

import io
import json
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness

from conftest import REPO, SMALL_CELL

NAME = "vcycle_graph_pct.solve"


def _read(*timings):
    problems = [SimpleNamespace(outcome=SimpleNamespace(
        iterations=t.get("cg_precond_calls", 0), timings=t))
        for t in timings]
    return harness.load_module(
        REPO / "benchmark" / "metrics" / f"{NAME}.py").read(
        harness.Run(20.0, 40.0, problems, 0))


@pytest.mark.parametrize("timings,share", [
    # every call replayed, over problems of different lengths
    (({"cg_precond_calls": 248, "mg_graph_replay_calls": 248},
      {"cg_precond_calls": 282, "mg_graph_replay_calls": 282}), 100.0),
    # a problem that ran its V-cycle op by op counts its calls
    (({"cg_precond_calls": 300, "mg_graph_replay_calls": 294},
      {"cg_precond_calls": 100}), 73.5),
])
def test_share_of_replays(timings, share):
    assert _read(*timings) == pytest.approx(share)


@pytest.mark.parametrize("timings", [
    ({"cg_precond_calls": 263, "cg_s": 13.4},),       # no graph counter
    ({"mg_graph_replay_calls": 5},),                  # no V-cycle calls
    (),                                               # no problem
])
def test_left_out_without_the_counters(timings):
    assert _read(*timings) is None


def test_cpu_run_leaves_it_out(small_root):
    """A traced CPU run at 16^2 with the tiny cell in the metric's
    workloads: no graph on the CPU, so the line lacks the metric and the
    run is otherwise whole."""
    path = small_root / "BENCHMARK.json"
    manifest = json.loads(path.read_text())
    for m in manifest["per_layer"]:
        if m["name"] == NAME:
            m["workloads"].append(SMALL_CELL)
    path.write_text(json.dumps(manifest))
    result, _ = harness.measure(small_root, SMALL_CELL, 2**31 + 777, 0.0,
                                True, time.perf_counter(),
                                device=torch.device("cpu"),
                                stderr=io.StringIO())
    assert result["correct"] is True
    assert NAME not in result["metrics"]
    assert "cg_iter_ms.solve" in result["metrics"]
