"""The plain reference against the port at 16^2 and 32^2 on the CPU: the
face residual of the port's unknowns in the reference's system is the
port's CG residual, the cell rows hold to rounding, the H1 errors
agree."""

import pytest
import torch

from benchmark.reference import cuthho as ref
from proton_tpu_torch.cut import fictdom_structured as fs
from proton_tpu_torch.solvers import cg


@pytest.mark.parametrize("N,k,radius,center,tol", [
    (16, 1, 0.35, (0.5, 0.5), 1e-6),
    (32, 1, 0.34, (0.51, 0.49), 1e-10),
    (32, 2, 0.36, (0.495, 0.503), 1e-6)])
def test_reference_agrees_with_the_port(N, k, radius, center, tol):
    res = fs.solve_fictdom_structured(
        N, k, fs.default_problem(radius, center),
        cg_params=cg.CGParams(tol, 1e8, 50000, True), device="cpu")
    assert res.exit_reason == 0
    j = ref.judge(N, k, radius, center, 4, fs.nitsche_eta(k), res.local,
                  torch.device("cpu"))
    assert j.face_res == pytest.approx(res.rel_residual, rel=1e-4)
    assert j.cell_res < 1e-13
    assert j.h1 == pytest.approx(res.h1_error, rel=1e-12)
    assert j.n_cut > 0


def test_grid_numbers_faces_as_the_port():
    from proton_tpu_torch.core.mesh import make_poly_mesh
    m = make_poly_mesh(Nx=8, Ny=8, device="cpu")
    g = ref.make_grid(8, torch.device("cpu"))
    assert torch.equal(g.points, m.points)
    assert torch.equal(g.cell_ptids, m.cell_ptids)
    assert torch.equal(g.cell_faces, m.cell_faces)
    assert torch.equal(g.face_ptids, m.face_ptids)
    assert torch.equal(g.face_bnd, m.face_bnd != 0)
