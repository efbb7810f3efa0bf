"""HHO Poisson on a polygonal mesh loaded from the reference text format
(JAX counterpart: proton_tpu/apps/polymesh.py; reference
apps/polymesh/polymesh.cpp): load, assemble, solve, the projection-based
L2 error, VTK export and a quadrature-point dump. Runs on CUDA unless
``--device cpu`` is given.

Usage: python -m proton_tpu_torch.apps.polymesh <meshfile> [-k K]
       [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from typing import NamedTuple

import numpy as np
import torch


class PolymeshResult(NamedTuple):
    mesh: object         # core.mesh.Mesh as loaded
    sol: object          # methods.poisson.PoissonSolution
    l2_proj: float       # L2 error against the projection (polymesh.cpp)
    load_s: float
    solve_s: float


def _sol_fun(p):
    return torch.sin(np.pi * p[..., 0]) * torch.sin(np.pi * p[..., 1])


def _rhs_fun(p):
    return 2.0 * np.pi ** 2 * _sol_fun(p)


def projection_error(mesh, geom, hdi, local) -> float:
    """sqrt(sum_T (pi u - u_T)' M (pi u - u_T)) on the cell dofs
    (polymesh.cpp:107-121)."""
    from ..core import bases, ops

    cbs = bases.cell_basis_size(hdi.cell_degree)
    mass = ops.cell_mass_matrices(mesh, geom, hdi.cell_degree)
    rhs = ops.cell_rhs(mesh, geom, hdi.cell_degree, _sol_fun)
    diff = ops.cho_solve_batched(mass, rhs[..., None])[..., 0] - \
        local[:, :cbs]
    return float(torch.sqrt(torch.sum(
        diff * torch.einsum("cij,cj->ci", mass, diff))))


def run_polymesh(meshfile: str, k: int, device=None) -> PolymeshResult:
    """Load ``meshfile`` on ``device`` (CUDA by default) and solve Poisson
    with HHODegreeInfo(k, k), Jacobi PCG at tol 1e-12."""
    from ..core.geometry import cell_geometry
    from ..core.mesh import load_poly_mesh
    from ..core.ops import HHODegreeInfo
    from ..methods import assembly, poisson
    from ..solvers import cg
    from ..utils.timing import TimeCounter

    tc = TimeCounter().tic()
    mesh = load_poly_mesh(meshfile, device=device)
    load_s = tc.toc(mesh.points)
    hdi = HHODegreeInfo(k, k)
    tc.tic()
    dofmap = assembly.build_dofmap(mesh, hdi)
    sol = poisson.solve_poisson(
        mesh, dofmap, hdi, _rhs_fun, _sol_fun, "hho",
        cg.CGParams(convergence_threshold=1e-12, divergence_threshold=1e8,
                    max_iter=3 * dofmap.n_dofs, apply_preconditioner=True))
    solve_s = tc.toc(sol.local)
    err = projection_error(mesh, cell_geometry(mesh), hdi, sol.local)
    return PolymeshResult(mesh, sol, err, load_s, solve_s)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("meshfile")
    ap.add_argument("-k", type=int, default=0, help="degree (ref uses 0)")
    ap.add_argument("--device", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from ..core import bases, quadrature
    from ..core.geometry import cell_geometry
    from ..core.ops import HHODegreeInfo
    from ..io.gnuplot import GnuplotOutput
    from ..io.vtk import VtkWriter
    from ..utils.timing import bold, green, yellow

    r = run_polymesh(args.meshfile, args.k, args.device)
    mesh = r.mesh
    print(bold(yellow(f"Mesh load: {r.load_s:.6g} seconds — "
                      f"{mesh.num_cells} cells, {mesh.num_faces} faces")))
    print(bold(yellow(f"Assembly+solve: {r.solve_s:.6g} seconds "
                      f"({r.sol.iterations} CG iterations)")))
    print(bold(green(f"L2-norm error (vs projection): {r.l2_proj}")))

    hdi = HHODegreeInfo(args.k, args.k)
    geom = cell_geometry(mesh)
    cdofs = r.sol.local[:, :bases.cell_basis_size(hdi.cell_degree)]
    w = VtkWriter(mesh)
    bar_phi = bases.eval_cell_basis(geom.bar, geom.bar, geom.diam,
                                    hdi.cell_degree)
    w.add_variable("u", torch.einsum("ci,ci->c", bar_phi, cdofs), "zonal")
    w.write_vtk("polymesh_solution.vtk")

    rule = quadrature.cell_rule(mesh, geom, 2 * hdi.cell_degree + 2)
    phi = bases.eval_cell_basis(rule.pts, geom.bar[:, None, :],
                                geom.diam[:, None], hdi.cell_degree)
    gp = GnuplotOutput("polymesh_solution.dat")
    gp.add_data(rule.pts, torch.einsum("cqi,ci->cq", phi, cdofs))
    gp.write()
    print("wrote polymesh_solution.{vtk,dat}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
