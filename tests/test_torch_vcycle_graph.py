"""The V-cycle's CUDA graph (solvers/multigrid.py: capture_vcycle,
VCycleGraph, Multigrid.precondition) on the CPU: a CPU Multigrid makes
no graph and runs the V-cycle op by op, and a solve's timings carry no
graph span; the replay protocol (copy in, replay, copy out; eager where
the graph does not fit) is held with a stand-in for the graph that runs
the V-cycle into the static output. The graph itself runs on the card:
tests/test_torch_cuda.py."""

import pytest
import threadpoolctl
import torch

from proton_tpu_torch.core.ops import HHODegreeInfo
from proton_tpu_torch.cut import fictdom_structured as fs
from proton_tpu_torch.methods.cells_last import GridVecCL
from proton_tpu_torch.solvers import multigrid
from proton_tpu_torch.utils.timing import sink

N = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with threadpoolctl.threadpool_limits(1):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)


def _multigrid(k):
    hdi, eta, problem = HHODegreeInfo(k + 1, k), fs.nitsche_eta(k), \
        fs.default_problem()
    fine = fs.build_level(N, hdi, problem, eta, 4, device="cpu",
                          fitted="lean")
    levels = {N: fine, **fs.build_coarse_levels(N, hdi, problem, eta, 4,
                                                device="cpu")}
    return fs.level_multigrid(levels, hdi)


def _residual(mg, seed, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    x = multigrid._zeros_grid(mg.levels[0].sys, dtype)
    return GridVecCL(torch.randn(x.H.shape, generator=g, dtype=dtype),
                     torch.randn(x.V.shape, generator=g, dtype=dtype))


def _graph_keys(timings):
    return [key for key in timings if key.startswith("mg_graph")]


@pytest.mark.parametrize("k", [1, 2])
def test_cpu_multigrid_makes_no_graph(k):
    """No capture on the CPU: precondition is the V-cycle run op by op,
    to the bit, its stage spans recorded and no graph span."""
    mg = _multigrid(k)
    assert mg.graph is None
    r = _residual(mg, k)
    with sink(t := {}):
        z = mg.precondition(r)
    ref = multigrid._vcycle(mg, 0, r)
    assert torch.equal(z.H, ref.H) and torch.equal(z.V, ref.V)
    assert _graph_keys(t) == []
    assert t[f"mg_smooth_n{N}_calls"] == 2 * mg.n_smooth


def test_cpu_solve_has_no_graph_spans():
    """A whole lean + multigrid solve on the CPU: the V-cycle ran op by
    op in every CG iteration, and no graph span is in its timings."""
    res = fs.solve_fictdom_structured(N, 1, device="cpu")
    t = res.timings
    assert res.exit_reason == 0
    assert _graph_keys(t) == []
    assert t["cg_precond_calls"] == res.iterations
    assert t[f"mg_smooth_n{N}_calls"] == 2 * res.iterations


class _StandIn:
    """Replays by running the V-cycle of the static input into the static
    output, as the captured graph does on the card."""

    def __init__(self, mg, x, y):
        self.mg, self.x, self.y = mg, x, y
        self.replays = 0

    def replay(self):
        z = multigrid._vcycle(self.mg, 0, self.x)
        self.y.H.copy_(z.H)
        self.y.V.copy_(z.V)
        self.replays += 1


def _with_stand_in(mg):
    x = multigrid._zeros_grid(mg.levels[0].sys, torch.float64)
    y = multigrid._zeros_grid(mg.levels[0].sys, torch.float64)
    stand_in = _StandIn(mg, x, y)
    return mg._replace(graph=multigrid.VCycleGraph(mg.levels, stand_in, x,
                                                   y)), stand_in


def test_replay_returns_a_fresh_result_held_across_calls():
    """Each replay copies its input in and returns a copy of the static
    output: equal to the eager V-cycle, not the static buffer, and a
    result held across the next call is left as it was (CG keeps the
    first call's result as its direction)."""
    mg = _multigrid(1)
    graphed, stand_in = _with_stand_in(mg)
    r1, r2 = _residual(mg, 11), _residual(mg, 12)
    with sink(t := {}):
        z1 = graphed.precondition(r1)
        held = GridVecCL(z1.H.clone(), z1.V.clone())
        z2 = graphed.precondition(r2)
    assert stand_in.replays == 2 and t["mg_graph_replay_calls"] == 2
    assert torch.equal(z1.H, held.H) and torch.equal(z1.V, held.V)
    for z, r in ((z1, r1), (z2, r2)):
        ref = multigrid._vcycle(mg, 0, r)
        assert torch.equal(z.H, ref.H) and torch.equal(z.V, ref.V)
        assert z.H.data_ptr() != stand_in.y.H.data_ptr()
        assert z.V.data_ptr() != stand_in.y.V.data_ptr()


@pytest.mark.parametrize("change", ["levels", "dtype", "shape"])
def test_graph_that_does_not_fit_runs_eager(change):
    """A graph replays only the V-cycle it captured, on inputs like the
    one it captured. With the levels replaced after the capture (a caller
    that wraps them), precondition runs the V-cycle op by op; an input of
    another dtype or shape goes op by op too, and fails there as it does
    without a graph. The graph is not replayed."""
    mg = _multigrid(1)
    graphed, stand_in = _with_stand_in(mg)
    r = _residual(mg, 13)
    if change == "levels":
        graphed = graphed._replace(levels=list(mg.levels))
    elif change == "dtype":
        r = GridVecCL(r.H.float(), r.V.float())
    else:
        r = GridVecCL(r.H[..., :-1], r.V[..., :-1])
    assert not graphed.graph.fits(graphed, r)
    with sink(t := {}):
        if change == "levels":
            z = graphed.precondition(r)
            ref = multigrid._vcycle(mg, 0, r)
            assert torch.equal(z.H, ref.H) and torch.equal(z.V, ref.V)
        else:
            with pytest.raises(RuntimeError):
                graphed.precondition(r)
    assert stand_in.replays == 0 and _graph_keys(t) == []
