"""A small copy of the benchmark for the CPU tests: the real files, plus a
16^2 configuration and its cell added as new files, without editing any
file of the benchmark. The cell opts in to the phase metrics that the
1024^2 cells report, as a later change that adds a cell names it in the
metrics it reads."""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

SMALL_CELL = "tiny_16_k1.solve"
# 16^2, k=1: the sound readings are face_res 2.3e-7, cell_res 1.5e-15,
# h1 4.43e-3, h1_gap 1e-15 (the mixed control: cell_res 6.0e-7)
SMALL_LIMITS = {"cg_exit": 0, "face_res": 2e-6, "cell_res": 1e-9,
                "h1": 6e-3, "h1_gap": 1e-8}
# the per-layer metrics the small cell reports
SMALL_METRICS = ("classify_s.solve", "assembly_s.solve", "mg_setup_s.solve",
                 "cg_iters.solve", "cg_iter_ms.solve",
                 "device_idle_pct.solve")


def add_cell(root: Path, name: str, config_name: str, config: dict,
             traffic: str, limits: dict, trace=None, metrics=()) -> None:
    """A configuration, a cell file and their manifest entries, as a later
    change adds them; the cell is appended to the ``workloads`` of the
    per-layer ``metrics``."""
    bench = root / "benchmark"
    (bench / "configs" / f"{config_name}.json").write_text(json.dumps(config))
    cell = {"limits": limits}
    if trace is not None:
        cell["trace"] = trace
    (bench / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    if config_name not in {c["name"] for c in manifest["configs"]}:
        manifest["configs"].append({
            "name": config_name, "source": "test", "reduced": ["N"],
            "file": f"benchmark/configs/{config_name}.json", "why": "test"})
    manifest["workloads"].append({"name": name, "config": config_name,
                                  "traffic": traffic, "chips": 1,
                                  "why": "test"})
    for m in manifest["per_layer"]:
        if m["name"] in metrics:
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))


@pytest.fixture
def small_root(tmp_path):
    """A checkout-like folder: BENCHMARK.json and benchmark/, with the
    16^2 cell added and named in ``SMALL_METRICS``."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    config = json.loads((REPO / "benchmark" / "configs" /
                         "cuthho_1024_k1.json").read_text())
    config["N"] = 16
    trace = json.loads((REPO / "benchmark" / "workloads" /
                        "cuthho_1024_k1.solve.json").read_text())["trace"]
    trace["start"] = 2
    trace["calls"] = 3
    add_cell(tmp_path, SMALL_CELL, "tiny_16_k1", config, "circles_pool3",
             SMALL_LIMITS, trace, SMALL_METRICS)
    return tmp_path


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
