"""The port's spans (proton_tpu_torch/utils/timing.py) on the CPU: a
span's totals, self times and calls in its sink; no trace without one;
the keys, counts and nesting of a 16^2 multigrid solve's spans; and the
Galerkin apply's ranges under a CPU torch.profiler. No JAX: the spans
have no counterpart in the JAX package."""

import types

import pytest
import threadpoolctl
import torch

from proton_tpu_torch.cut import fictdom_structured as fs
from proton_tpu_torch.methods.cells_last import GridVecCL
from proton_tpu_torch.methods.structured import make_structured_system
from proton_tpu_torch.solvers import multigrid
from proton_tpu_torch.utils import timing
from proton_tpu_torch.utils.timing import sink, span

CPU = torch.device("cpu")
# the phase keys the benchmark's accepted metrics and chip_smoke.py read
PHASES = ("classify", "assembly", "assemble_coarse", "mg_setup", "setup",
          "cg", "recover", "h1")


def _keys(name):
    return {f"{name}_s", f"{name}_self_s", f"{name}_calls"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """BLAS and torch on one thread (the port's test files' rule)."""
    with threadpoolctl.threadpool_limits(1):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)


@pytest.fixture
def ticks(monkeypatch):
    """The span clock advances by 1 s at every read."""
    clock = iter(range(1, 10_000))
    monkeypatch.setattr(timing, "time", types.SimpleNamespace(
        perf_counter=lambda: float(next(clock))))


@pytest.fixture(scope="module")
def mg_solve():
    return fs.solve_fictdom_structured(16, 1, precond="mg", device=CPU)


def test_nested_spans_give_totals_self_times_and_calls(ticks):
    t = {}
    with sink(t):
        with span("a"):                 # reads 1 .. 10
            with span("b"):             # 2 .. 3
                pass
            with span("b"):             # 4 .. 7, holding c
                with span("c"):         # 5 .. 6
                    pass
            with span("c"):             # 8 .. 9
                pass
    assert t == {"b_s": 4.0, "b_self_s": 3.0, "b_calls": 2,
                 "c_s": 2.0, "c_self_s": 2.0, "c_calls": 2,
                 "a_s": 9.0, "a_self_s": 4.0, "a_calls": 1}


@pytest.mark.parametrize("case", ["no_sink", "sink_none", "raises",
                                  "other_sink"])
def test_span_outside_its_sink_leaves_no_trace(ticks, case):
    """No sink (the span does not even read the clock), a sink of None
    inside one, a block that raises, and a nested sink of another dict:
    the outer dict holds the outer span and y alone, the inner dict the
    inner span alone."""
    t, inner = {}, {}
    if case == "no_sink":
        with span("x"):
            pass
        # it read no clock: the next read is the first tick
        assert timing.time.perf_counter() == 1.0
        return
    with sink(t), span("outer"):
        if case == "sink_none":
            with sink(None), span("x"):
                pass
        elif case == "raises":
            with pytest.raises(ValueError):
                with span("x"):
                    raise ValueError
        else:
            with sink(inner), span("x"):
                pass
        # the same dict again keeps the outer span as the parent
        with sink(t), span("y"):
            pass
    assert set(t) == _keys("outer") | _keys("y")
    # x is no child of outer in outer's sink
    assert t["outer_self_s"] == t["outer_s"] - t["y_s"]
    assert inner == ({} if case != "other_sink" else
                     {"x_s": 1.0, "x_self_s": 1.0, "x_calls": 1})


def test_mg_solve_returns_phase_cg_and_vcycle_spans(mg_solve):
    t, its = mg_solve.timings, mg_solve.iterations
    assert mg_solve.exit_reason == 0 and its > 1
    stages = {f"mg_{s}_n16" for s in ("smooth", "residual", "restrict",
                                      "prolong")} | {"mg_coarse_n8"}
    names = set(PHASES) | {"solve", "cg_apply", "cg_precond",
                           "cg_wait"} | stages
    assert set(t) == set().union(*map(_keys, names))
    assert t["cg_precond_calls"] == t["cg_apply_calls"] == \
        t["cg_wait_calls"] == its
    assert t["mg_smooth_n16_calls"] == 2 * its
    assert t["mg_coarse_n8_calls"] == its
    assert all(t[f"{p}_calls"] == 1 for p in PHASES + ("solve",))


def test_mg_solve_children_within_parents(mg_solve):
    t = mg_solve.timings
    mg = sum(t[k] for k in t if k.startswith("mg_") and k.endswith("_s")
             and not k.endswith("_self_s") and k != "mg_setup_s")
    assert 0 < mg <= t["cg_precond_s"]
    assert t["cg_apply_s"] + t["cg_precond_s"] + t["cg_wait_s"] <= t["cg_s"]
    assert sum(t[f"{p}_s"] for p in PHASES) <= t["solve_s"]
    for name in ("solve", "cg", "cg_precond"):
        assert 0 <= t[f"{name}_self_s"] <= t[f"{name}_s"]
    assert t["solve_self_s"] == pytest.approx(
        t["solve_s"] - sum(t[f"{p}_s"] for p in PHASES), abs=1e-9)


def _galerkin_apply():
    """A Galerkin pair-operator apply on a 4 x 4 grid, k = 1 (fbs 2): a
    random 5 x 5 stencil and two deviation pairs."""
    g = torch.Generator().manual_seed(5)
    sys = make_structured_system(4, 4, 2, device=CPU)
    nfd = 8
    kernel = torch.randn(nfd, nfd, 5, 5, generator=g, dtype=torch.float64)
    rows, cols = torch.tensor([3, 9]), torch.tensor([4, 9])
    blocks = torch.randn(2, nfd, nfd, generator=g, dtype=torch.float64)
    apply_S = multigrid.make_galerkin_operator_cl(sys, kernel, rows, cols,
                                                  blocks)
    x = GridVecCL(torch.randn(2, 5, 4, generator=g, dtype=torch.float64),
                  torch.randn(2, 4, 5, generator=g, dtype=torch.float64))
    return apply_S, x


@pytest.mark.parametrize("profiled", [False, True])
def test_galerkin_ranges_only_under_a_profiler(profiled, monkeypatch):
    """The Galerkin apply's spans are profiler ranges of their names
    while a torch.profiler runs (chip_smoke.py's galerkin_split reads
    them), open no range otherwise, and record in the sink either way."""
    from torch.profiler import ProfilerActivity, profile
    apply_S, x = _galerkin_apply()
    t = {}
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]) as prof, sink(t):
            y = apply_S(x)
        names = {e.name for e in prof.events()}
        assert {"galerkin.conv", "galerkin.pairs"} <= names
    else:
        def no_range(name):
            raise AssertionError(f"range {name} opened without a profiler")
        monkeypatch.setattr(torch.profiler, "record_function", no_range)
        with sink(t):
            y = apply_S(x)
    assert t["galerkin.conv_calls"] == t["galerkin.pairs_calls"] == 1
    assert torch.isfinite(y.H).all() and torch.isfinite(y.V).all()
