"""The comparison fails what it must, through a whole run at 16^2 on the
CPU with the look for a card skipped: the control (the program's float32
system, ``mixed=True``), and the faults a solve cell can have, planted in
the program underneath the run. The exchange between chips has no fault
here: every cell runs on one card."""

import io
import json
import time

import pytest
import torch

from benchmark import harness
from proton_tpu_torch.cut import fictdom_structured as fs
from proton_tpu_torch.solvers import cg

from conftest import SMALL_CELL, SMALL_LIMITS, add_cell

CPU = torch.device("cpu")


def run(root, cell=SMALL_CELL):
    return harness.measure(root, cell, 5, 0.0, False, time.perf_counter(),
                           device=CPU, stderr=io.StringIO())


def failing_checks(result):
    return {k for k, v in result["checks"].items()
            if not v["value"] <= v["limit"]}


def test_sound_run_is_correct(small_root):
    result, _ = run(small_root)
    assert result["correct"] is True and failing_checks(result) == set()


def test_control_is_not_correct(small_root):
    """The control as a driver of its own, added as files."""
    bench = small_root / "benchmark"
    (bench / "drivers" / "solve_mixed.py").write_text(
        (bench / "drivers" / "solve.py").read_text() +
        "\n\n_run = run\n\n\ndef run(*a, **kw):\n"
        "    return _run(*a, mixed=True, **kw)\n")
    t = json.loads((bench / "traffic" / "circles_pool3.json").read_text())
    t["driver"] = "solve_mixed"
    (bench / "traffic" / "control.json").write_text(json.dumps(t))
    config = json.loads((bench / "configs" / "tiny_16_k1.json").read_text())
    add_cell(small_root, "tiny_16_k1.control", "tiny_16_k1", config,
             "control", SMALL_LIMITS)
    result, lines = run(small_root, "tiny_16_k1.control")
    assert result["correct"] is False
    assert "cell_res" in failing_checks(result)
    assert any(ln.endswith("FAIL") for ln in lines)


def test_state_returned_unchanged(small_root, monkeypatch):
    """CG hands back its starting vector and says it converged."""
    real = cg.conjugated_gradient

    def unchanged(apply_A, b, *a, **kw):
        res = real(apply_A, b, *a, **kw)
        x0 = cg._map(torch.zeros_like, b)
        return res._replace(x=x0, iterations=1, rel_residual=0.0)

    monkeypatch.setattr(cg, "conjugated_gradient", unchanged)
    result, _ = run(small_root)
    assert result["correct"] is False
    assert "face_res" in failing_checks(result)


def test_half_the_cells_left_out(small_root, monkeypatch):
    real = fs.recover_local

    def half(*a, **kw):
        local = real(*a, **kw).clone()
        local[local.shape[0] // 2:] = 0.0
        return local

    monkeypatch.setattr(fs, "recover_local", half)
    result, _ = run(small_root)
    assert result["correct"] is False
    assert {"face_res", "cell_res"} <= failing_checks(result)


@pytest.mark.parametrize("where", ["unknown", "h1"])
def test_answer_altered_where_it_is_produced(small_root, monkeypatch, where):
    real = fs.solve_fictdom_structured

    def altered(*a, **kw):
        res = real(*a, **kw)
        if where == "h1":
            return res._replace(h1_error=res.h1_error * 1.001)
        local = res.local.clone()
        local[local.shape[0] // 2 + 3, 0] += 1e-3
        return res._replace(local=local)

    monkeypatch.setattr(fs, "solve_fictdom_structured", altered)
    result, _ = run(small_root)
    assert result["correct"] is False
    assert failing_checks(result) & {"cell_res", "face_res", "h1_gap"}
