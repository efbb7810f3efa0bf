"""The plain reference of the interface problem
(``benchmark/reference/interface.py``, torch and numpy only) against the
port on the CPU, float64, k=1, at 16^2 and 32^2 on circles drawn by the
benchmark's traffic law from fixed seeds: the per-cell operators and
loads agree to rounding, and the reference's judgement of the port's
solve reads the port's own CG residual and H1 error. Planted faults fail
the judgement; the result carries CG's residual, and the condensed
system's phases and sizes are in the solve's timings.

The solves stop at tol 1e-8, not below: the reference evaluates
A_FT uT + A_FF uF in float64, whose relative rounding floor (eps |A| |u|
over the condensed right-hand side) is 3e-13 at 16^2 and 3e-12 at 32^2,
so CG's residual and the reference's agree to 1e-4 only where CG's lies
1e4 above it. The cell rows hold to that floor too: ``CELL_RES``.
"""

import dataclasses
import json
from pathlib import Path

import pytest
import threadpoolctl
import torch

from benchmark.reference import interface as iref
from benchmark.traffic import generate
from proton_tpu_torch.core.mesh import make_poly_mesh
from proton_tpu_torch.core.ops import HHODegreeInfo
from proton_tpu_torch.cut import interface_problem as ip
from proton_tpu_torch.cut.classify import LOC_CUT, LOC_NEG, cut_preprocess
from proton_tpu_torch.cut.fictdom_structured import default_problem
from proton_tpu_torch.cut.methods import InterfaceParams
from proton_tpu_torch.solvers import cg
from proton_tpu_torch.utils.timing import count, sink

ROOT = Path(__file__).resolve().parent.parent
LAW = json.loads((ROOT / "benchmark" / "traffic" /
                  "interface_circles_pool3.json").read_text())
CPU = torch.device("cpu")
TOL = cg.CGParams(1e-8, 1e8, 5000, True)
# the cell rows' rounding floor (module docstring): 4.6e-13 / 3.3e-12
CELL_RES = 1e-11
CASES = [(16, 19011), (32, 19012)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """BLAS and torch on one thread (ROADMAP's rule for solving tests)."""
    with threadpoolctl.threadpool_limits(1):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)


def circle(N, seed):
    law = dict(LAW, pool={"size": 1, "seed": seed})
    p = generate.pool(law, {"N": N})[0]
    return p["radius"], tuple(p["center"])


def judge(N, r, c, res):
    return iref.judge(N, 1, r, c, 4, 1.0, 1.0, 5.0, res.local_neg,
                      res.local_pos, CPU)


def sound(res, j):
    """The judgement of a sound solve: the reference reads CG's residual,
    the cell rows at their floor, the port's H1 error."""
    return (abs(j.face_res / res.rel_residual - 1.0) < 1e-4 and
            j.cell_res < CELL_RES and
            abs(j.h1 - res.h1_error) < 1e-12 * j.h1)


@pytest.mark.parametrize("N,seed", CASES)
def test_operators_agree_with_the_port(N, seed):
    r, c = circle(N, seed)
    p = default_problem(r, c)
    mesh, cd = cut_preprocess(make_poly_mesh(Nx=N, Ny=N, device=CPU), p.ls,
                              levels=4)
    asm = ip.assemble_interface(mesh, cd, p.ls, HHODegreeInfo(2, 1),
                                p.rhs_fun, p.sol_fun, InterfaceParams())
    ref = iref.ref
    grid = ref.make_grid(N, CPU)
    phi = ref.Circle(r, *c)
    cls = ref.classify(grid, phi, 4)
    assert torch.equal(cls.cut_ids, asm.dm.cut_ids) and len(cls.cut_ids)
    cc = ref.cut_cells(grid, cls)
    g = ref.geometry(cls.points, grid, asm.dm.uncut_ids)
    kappa = torch.ones(len(asm.dm.uncut_ids), dtype=torch.float64)
    for mine, port in (
            (iref.uncut_operator(g, 1, kappa), asm.lc_uncut),
            (ref.fitted_load(g, 1, ref.exact_f), asm.f_uncut),
            (iref.interface_operator(cc, phi, 1, 1.0, 1.0, 5.0), asm.lc_cut),
            (iref.side_loads(cc, 1, ref.exact_f), asm.loads_cut[:, :12])):
        assert mine.shape == port.shape
        assert (mine - port).abs().max() <= 1e-10 * port.abs().max()
    assert torch.all(asm.loads_cut[:, 12:] == 0)


@pytest.mark.parametrize("N,seed", CASES)
def test_reference_judges_the_port(N, seed):
    r, c = circle(N, seed)
    res = ip.run_interface(N, 1, r, c, device=CPU, cg_params=TOL)
    assert res.exit_reason == 0
    j = judge(N, r, c, res)
    assert j.face_res == pytest.approx(res.rel_residual, rel=1e-4)
    assert j.cell_res < CELL_RES
    assert j.h1 == pytest.approx(res.h1_error, rel=1e-12)
    assert j.n_cut > 0


def _start_vector(monkeypatch):
    real = cg.conjugated_gradient

    def unchanged(apply_A, b, *a, **kw):
        res = real(apply_A, b, *a, **kw)
        return res._replace(x=torch.zeros_like(b), iterations=1,
                            rel_residual=res.rel_residual)

    monkeypatch.setattr(cg, "conjugated_gradient", unchanged)
    return {}


def _single_copy(monkeypatch):
    """Both copies of every cut face made one: the dof map numbers a cut
    face once, so the solve is that of a continuous, single-copy
    system."""
    real = ip.build_interface_dofmap

    def single(mesh, cutdata, hdi):
        loc = torch.where(cutdata.face_loc == LOC_CUT,
                          torch.full_like(cutdata.face_loc, LOC_NEG),
                          cutdata.face_loc)
        return real(mesh, dataclasses.replace(cutdata, face_loc=loc), hdi)

    monkeypatch.setattr(ip, "build_interface_dofmap", single)
    return {}


@pytest.mark.parametrize("fault", ["start_vector", "single_copy", "float32"])
def test_planted_faults_fail_the_judgement(monkeypatch, fault):
    N, (r, c) = 16, circle(16, 19013)
    kw = {"dtype": torch.float32} if fault == "float32" else \
        {"start_vector": _start_vector, "single_copy": _single_copy}[fault](
            monkeypatch)
    res = ip.run_interface(N, 1, r, c, device=CPU, cg_params=TOL, **kw)
    assert res.exit_reason == 0
    assert not sound(res, judge(N, r, c, res))


def test_result_spans_and_counters():
    N, (r, c) = 16, circle(16, 19014)
    t = {}
    res = ip.run_interface(N, 1, r, c, device=CPU, cg_params=TOL, timings=t)
    assert 0 < res.rel_residual < 1e-8
    assert {"condense_s", "mg_setup_s", "band_setup_s"} <= set(t)
    assert t["condense_s"] + t["mg_setup_s"] + t["band_setup_s"] <= \
        t["setup_s"]
    assert t["condense_calls"] == t["mg_setup_calls"] == \
        t["band_setup_calls"] == 1
    # the counters against the dof map of the same problem
    p = default_problem(r, c)
    mesh, cd = cut_preprocess(make_poly_mesh(Nx=N, Ny=N, device=CPU), p.ls,
                              levels=4)
    dm = ip.build_interface_dofmap(mesh, cd, HHODegreeInfo(2, 1))
    assert t["iface_cut_cells"] == len(dm.cut_ids) > 0
    assert t["iface_face_dofs"] == dm.n_dofs - dm.cbs * dm.num_all_cells


def test_count_writes_only_into_a_sink():
    count("x", 3)
    t = {}
    with sink(t):
        count("x", 3)
        count("x", 4)
    count("x", 5)
    assert t == {"x": 7}
