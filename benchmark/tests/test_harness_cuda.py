"""On the card: one short run of each cell through the command, as the
benchmark's check makes it. Skips where there is no CUDA device:

    python -m pytest benchmark/tests/test_harness_cuda.py -q
"""

import json
import subprocess

import pytest
import torch

from conftest import REPO

MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_a_short_run_is_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; there is no CUDA device here")
    p = subprocess.run(MANIFEST["command"] + [
        "--workload", cell, "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
