"""A second deployment added as new files only, as a later change adds
one: a driver with its own control, a traffic mix that names it, a 16^2
configuration, a cell and a per-layer metric that lists only that cell.
The cell runs and is judged, reads its own metrics and none of the
``.solve`` cells', leaves what the 1024^2 cells report as it was, and
passes the manifest's checks; the readings take the new driver's
control."""

import io
import json
import time

import pytest
import torch

from benchmark import harness, readings

import test_harness_manifest as manifest_checks
from conftest import REPO, SMALL_CELL, SMALL_LIMITS, add_cell

CPU = torch.device("cpu")
CELL = "tiny_again_16_k1.run"
METRIC = "cg_iters.again"
CELLS_1024 = ("cuthho_1024_k1.solve", "cuthho_1024_k2.solve")
SOLVE_CONTROL = 'CONTROL = {"mixed": True}\n'


def add_deployment(root, control='{"mixed": True}'):
    """The driver ``solve_again`` (solve.py's text with ``CONTROL =
    <control>``), the mix ``circles_again``, the configuration
    ``tiny_again_16_k1``, the cell and its metric."""
    bench = root / "benchmark"
    solve = (bench / "drivers" / "solve.py").read_text()
    assert solve.count(SOLVE_CONTROL) == 1
    (bench / "drivers" / "solve_again.py").write_text(
        solve.replace(SOLVE_CONTROL, f"CONTROL = {control}\n"))
    mix = json.loads((bench / "traffic" / "circles_pool3.json").read_text())
    mix["driver"] = "solve_again"
    (bench / "traffic" / "circles_again.json").write_text(json.dumps(mix))
    (bench / "metrics" / f"{METRIC}.py").write_text(
        "def read(run):\n"
        "    its = [p.outcome.iterations for p in run.problems]\n"
        "    return sum(its) / len(its) if its else None\n")
    config = json.loads((bench / "configs" / "tiny_16_k1.json").read_text())
    block = json.loads((bench / "workloads" /
                        f"{SMALL_CELL}.json").read_text())["trace"]
    add_cell(root, CELL, "tiny_again_16_k1", config, "circles_again",
             SMALL_LIMITS, block)
    path = root / "BENCHMARK.json"
    manifest = json.loads(path.read_text())
    manifest["per_layer"].append({
        "name": METRIC, "unit": "iters", "better": "lower",
        "source": "program_counter", "layer": "solvers/cg.py",
        "moves": "time_to_solution_s", "workloads": [CELL]})
    path.write_text(json.dumps(manifest))


def run(root, trace):
    return harness.measure(root, CELL, 2**31 + 18, 0.0, trace,
                           time.perf_counter(), device=CPU,
                           stderr=io.StringIO())[0]


@pytest.mark.parametrize("trace", [False, True])
def test_new_cell_is_judged_and_reads_its_own_metrics(small_root, trace):
    add_deployment(small_root)
    result = run(small_root, trace)
    assert result["correct"] is True
    assert result["attempted"] == 3 and result["failed"] == 0
    assert set(result["checks"]) == set(SMALL_LIMITS)
    if trace:
        assert set(result["metrics"]) == {METRIC}
        assert result["metrics"][METRIC]["value"] > 0
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == {"time_to_solution_s", "setup_s"}


def test_the_1024_cells_report_what_they_reported(small_root):
    def names(root, cell):
        manifest = manifest_checks.load_manifest(root)
        loaded = harness.load_cell(root, cell)
        return ({m["name"] for m in manifest_checks.reported(
                    manifest["end_to_end"] + manifest["per_layer"], cell)},
                {m["name"] for m in loaded.end_to_end + loaded.per_layer})

    before = {cell: names(REPO, cell) for cell in CELLS_1024}
    add_deployment(small_root)
    assert {cell: names(small_root, cell) for cell in CELLS_1024} == before
    for cell in CELLS_1024:
        assert METRIC not in before[cell][0]


def test_manifest_checks_hold_with_the_deployment(small_root):
    add_deployment(small_root)
    manifest_checks.test_top_level_keys_and_command(small_root)
    manifest_checks.test_configs(small_root)
    manifest_checks.test_workloads_find_their_files(small_root)
    manifest_checks.test_metrics(small_root)


@pytest.mark.parametrize("control,fails", [('{"mixed": True}', True),
                                           ("{}", False)])
def test_readings_take_the_drivers_control(small_root, control, fails):
    """The same problem read sound and as the control: the control is
    whatever the new driver declares, the float32 system failing the
    cell's limits, no options reading as the sound run does."""
    add_deployment(small_root, control)
    sound, ctrl = readings.readings(small_root, CELL, [7], [7], device=CPU)
    assert (sound["kind"], ctrl["kind"]) == ("sound", "control")
    assert sound["params"] == ctrl["params"]
    assert all(sound[k] <= limit for k, limit in SMALL_LIMITS.items())
    failed = {k for k, limit in SMALL_LIMITS.items() if not ctrl[k] <= limit}
    assert ("cell_res" in failed) is fails and bool(failed) is fails

