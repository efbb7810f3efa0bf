"""copy_sentinel_writes.interface, read from the program's counter where
it is there and left out, without raising, where it is not: a program
that does not count it, or a problem that never built the interface
preconditioner. A 16^2 interface cell, added to a copy of the benchmark
with this metric's entry, reads 0 in a traced run."""

import io
import json
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness

from conftest import REPO, add_cell

NAME = "copy_sentinel_writes.interface"
CELL = "tiny_interface_16_k1.solve"
# test_harness_interface.py's limits of the 16^2 interface cell
LIMITS = {"cg_exit": 0, "face_res": 1e-6, "cell_res": 1e-7, "h1": 1.2e-2,
          "h1_gap": 1e-9}


def _read(*timings):
    problems = [SimpleNamespace(outcome=SimpleNamespace(
        iterations=1, timings=t)) for t in timings]
    return harness.load_module(
        REPO / "benchmark" / "metrics" / f"{NAME}.py").read(
        harness.Run(20.0, 40.0, problems, 0))


@pytest.mark.parametrize("timings,value", [
    (({"iface_copy_sentinel_writes": 0},
      {"iface_copy_sentinel_writes": 0}), 0.0),
    (({"iface_copy_sentinel_writes": 4},
      {"iface_copy_sentinel_writes": 2}), 3.0),
])
def test_mean_per_problem(timings, value):
    assert _read(*timings) == value


@pytest.mark.parametrize("timings", [
    ({"iface_face_dofs": 4196100, "cg_s": 28.4},),    # no such counter
    (),                                               # no problem
])
def test_left_out_without_the_counter(timings):
    assert _read(*timings) is None


def test_interface_run_reads_zero(small_root):
    bench = small_root / "benchmark"
    config = json.loads((bench / "configs" /
                         "cuthho_interface_1024_k1.json").read_text())
    config["N"] = 16
    trace = json.loads((bench / "workloads" /
                        "cuthho_interface_1024_k1.solve.json").read_text())[
        "trace"]
    trace.update(start=2, calls=3)
    add_cell(small_root, CELL, "tiny_interface_16_k1", config,
             "interface_circles_pool3", LIMITS, trace, ("cg_iters.solve",))
    path = small_root / "BENCHMARK.json"
    manifest = json.loads(path.read_text())
    manifest["per_layer"].append({
        "name": NAME, "unit": "entries", "better": "lower",
        "source": "program_counter",
        "layer": "cut/interface_problem.py preconditioner apply (copy maps,"
                 " V-cycle replay, cut-band Schwarz)",
        "moves": "time_to_solution_s", "workloads": [CELL]})
    path.write_text(json.dumps(manifest))
    result, _ = harness.measure(small_root, CELL, 2**31 + 20, 0.0, True,
                                time.perf_counter(),
                                device=torch.device("cpu"),
                                stderr=io.StringIO())
    assert result["correct"] is True
    assert result["metrics"][NAME] == {"value": 0.0, "unit": "entries"}
    assert "cg_iters.solve" in result["metrics"]
