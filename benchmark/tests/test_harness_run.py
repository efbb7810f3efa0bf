"""A whole run on the CPU at 16^2: the result line's keys, the window's
accounting, the traced slice, and a cell added as files."""

import io
import json
import time

import pytest
import torch

from benchmark import harness

from conftest import SMALL_CELL

CPU = torch.device("cpu")
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device",
               "checks"}


def run(root, seconds=0.0, trace=False, seed=7, cell=SMALL_CELL):
    return harness.measure(root, cell, seed, seconds, trace,
                           time.perf_counter(), device=CPU,
                           stderr=io.StringIO())


def test_result_line_has_the_contract_keys(small_root):
    result, lines = run(small_root)
    assert set(result) == RESULT_KEYS
    assert list(result)[-1] == "checks"
    assert result["correct"] is True
    assert result["attempted"] == 3 and result["failed"] == 0
    assert set(result["metrics"]) == {"time_to_solution_s", "setup_s"}
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert set(result["checks"]) == {"cg_exit", "face_res", "cell_res",
                                     "h1", "h1_gap"}
    assert [ln.split()[1] for ln in lines] == list(result["checks"])
    assert all(ln.endswith(" ok") for ln in lines)
    json.dumps(result)


def test_traced_run_reads_the_per_layer_metrics(small_root):
    result, _ = run(small_root, trace=True)
    assert result["correct"] is True
    assert set(result["metrics"]) == {
        "classify_s.solve", "assembly_s.solve", "mg_setup_s.solve",
        "cg_iters.solve", "cg_iter_ms.solve"}
    # the CPU has no device events: the idle share is left out, not 0
    assert "device_idle_pct.solve" not in result["metrics"]
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(result["breakdown"]["idle_gaps"]) <= 10


def test_window_runs_whole_problems_until_the_time_is_up(small_root):
    one, _ = run(small_root)
    several, _ = run(small_root, seconds=1.0)
    # whole rounds of the three-problem pool
    assert one["attempted"] == 3
    assert several["attempted"] % 3 == 0 and several["attempted"] >= 3
    assert several["correct"] is True


def test_a_stalled_problem_moves_time_to_solution(small_root):
    base, _ = run(small_root, seconds=0.5)
    drivers = small_root / "benchmark" / "drivers"
    (drivers / "stall.py").write_text(
        (drivers / "solve.py").read_text() + "\n\n_run = run\n\n\n"
        "def run(*a, **kw):\n    import time\n    time.sleep(0.5)\n"
        "    return _run(*a, **kw)\n")
    traffic = small_root / "benchmark" / "traffic"
    t = json.loads((traffic / "circles_pool3.json").read_text())
    t["driver"] = "stall"
    (traffic / "stall_circles.json").write_text(json.dumps(t))
    from conftest import SMALL_LIMITS, add_cell
    config = json.loads((small_root / "benchmark" / "configs" /
                         "tiny_16_k1.json").read_text())
    add_cell(small_root, "tiny_16_k1.stall", "tiny_16_k1", config,
             "stall_circles", SMALL_LIMITS)
    stalled, _ = run(small_root, seconds=0.5, cell="tiny_16_k1.stall")
    a = base["metrics"]["time_to_solution_s"]["value"]
    b = stalled["metrics"]["time_to_solution_s"]["value"]
    assert b > a + 0.4


def test_same_seed_same_problems(small_root):
    gen = harness.load_cell(small_root, SMALL_CELL).generator()
    cell = harness.load_cell(small_root, SMALL_CELL)
    take = lambda s: [next(it)[0] for it in [gen.problems(
        cell.traffic, cell.config, s)] for _ in range(3)]
    assert take(3 * 2 ** 31 + 5) == take(3 * 2 ** 31 + 5)
    assert any(take(s) != take(11) for s in range(12, 20))
    # every seed the same set, each in its own order
    key = lambda ps: sorted(json.dumps(p) for p in ps)
    assert key(take(11)) == key(take(12)) == key(take(-5))
    for p in take(2 ** 31 + 1):
        assert 0.33 <= p["radius"] <= 0.37
        assert all(abs(c - 0.5) <= 0.5 / 16 for c in p["center"])


def test_unknown_cell_is_refused(small_root):
    with pytest.raises(harness.HarnessError):
        run(small_root, cell="no_such.cell")


def test_setup_is_split_on_stderr(small_root):
    """Standard error gives set-up by part, the parts summing to
    ``setup_s``, and the warm-up problem's spans."""
    err = io.StringIO()
    result, _ = harness.measure(small_root, SMALL_CELL, 7, 0.0, False,
                                time.perf_counter(), device=CPU, stderr=err)
    lines = err.getvalue().splitlines()

    def after(prefix):
        return json.loads(next(ln for ln in lines
                               if ln.startswith(prefix))[len(prefix):])

    parts = after("setup parts ")
    assert list(parts) == ["import_s", "context_s", "driver_s", "warm_s"]
    assert all(v >= 0 for v in parts.values())
    assert sum(parts.values()) == pytest.approx(
        result["metrics"]["setup_s"]["value"], abs=1e-3)
    warm = after("setup warm ")
    assert warm["classify_s"] > 0 and warm["assembly_s"] > 0
