"""The interface deployment at 16^2, added inside the test copy as files
only, as its 1024^2 cell was added: its configuration with N cut to 16,
its cell with its own limits and a short traced slice, and its name
appended to the metrics the 1024^2 interface cell names. The cell runs
and is judged by the doubled-unknown reference, reports the appended
``.solve`` metrics and its own ``.interface`` ones, leaves what the
fictitious-domain cells report as it was, and the readings take the
``interface`` driver's float32 control, which fails."""

import io
import json
import time

import pytest
import torch

from benchmark import harness, readings

import test_harness_manifest as manifest_checks
from conftest import REPO, add_cell

CPU = torch.device("cpu")
CELL_1024 = "cuthho_interface_1024_k1.solve"
CELL = "tiny_interface_16_k1.solve"
FICTDOM = ("cuthho_1024_k1.solve", "cuthho_1024_k2.solve")
# 16^2, k=1, tol 1e-9: the sound readings over seven circles are
# face_res <= 5.3e-10, cell_res <= 6.0e-13, h1 <= 8.14e-3, h1_gap <=
# 4.3e-16; the float32 control reads face_res >= 2.9e-4, cell_res >=
# 3.0e-4, h1 8.24-8.33e-3, h1_gap >= 7.8e-7
LIMITS = {"cg_exit": 0, "face_res": 1e-6, "cell_res": 1e-7, "h1": 1.2e-2,
          "h1_gap": 1e-9}
# of the interface cell's metrics, those the CPU reads: no device events
# (device_idle_pct.solve) and no CUDA graph (vcycle_graph_pct.solve)
CPU_METRICS = {"classify_s.solve", "cg_iters.solve", "cg_iter_ms.solve",
               "cg_wait_ms.solve", "cg_vector_ms.solve", "cg_apply_ms.solve",
               "vcycle_ms.solve", "assemble_s.interface",
               "condense_s.interface", "mg_setup_s.interface",
               "band_setup_s.interface", "face_dofs.interface"}


def metrics_of(root, cell):
    manifest = manifest_checks.load_manifest(root)
    return {m["name"] for m in manifest["per_layer"]
            if cell in m["workloads"]}


@pytest.fixture
def iface_root(small_root):
    bench = small_root / "benchmark"
    config = json.loads((bench / "configs" /
                         "cuthho_interface_1024_k1.json").read_text())
    config["N"] = 16
    trace = json.loads((bench / "workloads" /
                        f"{CELL_1024}.json").read_text())["trace"]
    trace.update(start=2, calls=3)
    add_cell(small_root, CELL, "tiny_interface_16_k1", config,
             "interface_circles_pool3", LIMITS, trace,
             metrics_of(small_root, CELL_1024))
    return small_root


def run(root, trace):
    return harness.measure(root, CELL, 2**31 + 19, 0.0, trace,
                           time.perf_counter(), device=CPU,
                           stderr=io.StringIO())[0]


def test_the_cell_names_the_appended_and_its_own_metrics():
    assert metrics_of(REPO, CELL_1024) == CPU_METRICS | {
        "device_idle_pct.solve", "vcycle_graph_pct.solve"}


@pytest.mark.parametrize("trace", [False, True])
def test_interface_cell_is_judged_and_reads_its_metrics(iface_root, trace):
    result = run(iface_root, trace)
    assert result["correct"] is True
    assert result["attempted"] == 3 and result["failed"] == 0
    assert set(result["checks"]) == set(LIMITS)
    if trace:
        assert set(result["metrics"]) == CPU_METRICS
        assert result["metrics"]["face_dofs.interface"]["value"] > 0
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == {"time_to_solution_s", "setup_s"}


def test_the_fictdom_cells_report_what_they_reported(iface_root):
    """Every per-layer metric the 1024^2 fictitious-domain cells report is
    a ``.solve`` one, all 15 of them, with the interface cells added."""
    for cell in FICTDOM:
        loaded = harness.load_cell(iface_root, cell)
        names = {m["name"] for m in loaded.per_layer}
        assert len(names) == 15 and all(n.endswith(".solve") for n in names)
        assert {m["name"] for m in loaded.end_to_end} == {
            "time_to_solution_s", "peak_mem_gib", "setup_s"}


def test_manifest_checks_hold_with_the_cell(iface_root):
    manifest_checks.test_top_level_keys_and_command(iface_root)
    manifest_checks.test_configs(iface_root)
    manifest_checks.test_workloads_find_their_files(iface_root)
    manifest_checks.test_metrics(iface_root)


def test_readings_take_the_float32_control(iface_root):
    """The same problem read sound and as the control: the control is the
    interface driver's, the whole solve in float32, and fails at least two
    of the cell's numbers."""
    driver = harness.load_cell(iface_root, CELL).driver()
    assert driver.CONTROL == {"dtype": "float32"}
    sound, ctrl = readings.readings(iface_root, CELL, [7], [7], device=CPU)
    assert (sound["kind"], ctrl["kind"]) == ("sound", "control")
    assert sound["params"] == ctrl["params"]
    assert all(sound[k] <= limit for k, limit in LIMITS.items())
    failed = {k for k, limit in LIMITS.items() if not ctrl[k] <= limit}
    assert {"face_res", "cell_res", "h1_gap"} <= failed
