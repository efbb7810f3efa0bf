"""Uncut HHO Poisson: batched assembly, Jacobi PCG and batched error
evaluation (JAX counterpart: proton_tpu/methods/poisson.py; reference
convergence_test.cpp:200-306).

``solve_poisson`` (like condensation.solve_condensed) takes an optional
``timings`` dict: when given, the device is synchronized after each phase
and its seconds are recorded under the phase's name.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..core import bases, quadrature
from ..core.geometry import cell_geometry
from ..core.ops import HHODegreeInfo, cell_mass_matrices, cell_rhs, \
    cho_solve_batched
from ..solvers import cg
from ..utils.timing import sink, span
from . import assembly, hho

DEFAULT_CG = cg.CGParams(convergence_threshold=1e-12,
                         divergence_threshold=1e8, max_iter=200000,
                         apply_preconditioner=True)


class PoissonSolution(NamedTuple):
    x: torch.Tensor            # global solution [n_dofs]
    local: torch.Tensor        # per-cell dofs [C, d] incl. Dirichlet data
    oper: torch.Tensor         # reconstruction operators [C, rbs-1, d]
    iterations: int
    exit_reason: int
    rel_residual: float
    history: Optional[torch.Tensor]


def assemble_local(mesh, geom, hdi: HHODegreeInfo, stab: str = "hho"):
    """(oper, lc): reconstruction operator and local bilinear forms
    lc = a_T + s_T of every cell (convergence_test.cpp:204-212)."""
    if stab not in ("hho", "naive"):
        raise ValueError(f"unknown stabilization '{stab}'")
    oper, data = hho.hho_laplacian(mesh, geom, hdi)
    if stab == "hho":
        return oper, data + hho.fancy_stabilization(mesh, geom, hdi, oper)
    return oper, data + hho.naive_stabilization(mesh, geom, hdi)


def solve_poisson(mesh, dofmap: assembly.DofMap, hdi: HHODegreeInfo,
                  rhs_fun: Callable, bc_fun: Callable, stab: str = "hho",
                  cg_params: cg.CGParams = DEFAULT_CG,
                  timings: Optional[dict] = None) -> PoissonSolution:
    """Assemble and solve -lap(u) = f, u = g on the boundary, on the full
    (cell + face) system with PCG."""
    dev = mesh.points.device
    with sink(timings):
        with span("geometry", dev):
            geom = cell_geometry(mesh)
        with span("local_operators", dev):
            oper, lc = assemble_local(mesh, geom, hdi, stab)
        with span("rhs", dev):
            f = cell_rhs(mesh, geom, hdi.cell_degree, rhs_fun)
            fd = assembly.dirichlet_face_data(mesh, hdi, bc_fun)
            g_loc = assembly.local_dirichlet_data(dofmap, mesh, fd)
            rhs = assembly.assemble_rhs(dofmap, f, lc, g_loc)
            apply_A = assembly.make_operator(dofmap, lc)
            diag = assembly.operator_diagonal(dofmap, lc)
        with span("cg", dev):
            res = cg.conjugated_gradient(apply_A, rhs, diag, cg_params)
        with span("recover", dev):
            local = assembly.take_local_data(dofmap, res.x, g_loc)
    return PoissonSolution(res.x, local, oper, res.iterations,
                           res.exit_reason, res.rel_residual, res.history)


class PoissonErrors(NamedTuple):
    l2: torch.Tensor       # sqrt(sum_T int (u - u_T)^2), by quadrature
    l2_proj: torch.Tensor  # sqrt(sum_T (pi u - u_T)' M (pi u - u_T))
    energy: torch.Tensor   # sqrt(sum_T int |grad u - grad r(u_T)|^2)


def compute_errors(mesh, hdi: HHODegreeInfo, sol: PoissonSolution,
                   exact_fun: Callable, exact_grad: Callable
                   ) -> PoissonErrors:
    """The three error measures of convergence_test.cpp:254-306 in one
    batched pass.

    Deviation from the reference (documented, as in the JAX package):
    convergence_test.cpp:262-274 re-accumulates the projection error and
    re-factorizes the mass matrix inside the quadrature-point loop,
    inflating errors_mm by the number of quadrature points; here each
    cell term is accumulated once. Orders (the published quantity) are
    unaffected. The energy error uses the reconstruction-degree rule (the
    reference computes rule qps2 at :288 but then iterates the lower-order
    rule).
    """
    geom = cell_geometry(mesh)
    celdeg, recdeg = hdi.cell_degree, hdi.reconstruction_degree
    cbs = bases.cell_basis_size(celdeg)

    rule = quadrature.cell_rule(mesh, geom, 2 * celdeg)
    phi = bases.eval_cell_basis(rule.pts, geom.bar[:, None, :],
                                geom.diam[:, None], celdeg)
    cdofs = sol.local[:, :cbs]
    uh = torch.einsum("cqi,ci->cq", phi, cdofs)
    l2_sq = torch.sum(rule.w * (exact_fun(rule.pts) - uh) ** 2)

    mass = cell_mass_matrices(mesh, geom, celdeg)
    rhs = cell_rhs(mesh, geom, celdeg, exact_fun)
    diff = cho_solve_batched(mass, rhs[..., None])[..., 0] - cdofs
    mm_sq = torch.sum(diff * torch.einsum("cij,cj->ci", mass, diff))

    rrule = quadrature.cell_rule(mesh, geom, 2 * recdeg)
    dphi = bases.eval_cell_gradients(rrule.pts, geom.bar[:, None, :],
                                     geom.diam[:, None], recdeg)
    recdofs = torch.einsum("crd,cd->cr", sol.oper, sol.local)
    gh = torch.einsum("cqrx,cr->cqx", dphi[:, :, 1:, :], recdofs)
    en_sq = torch.sum(rrule.w * torch.sum((exact_grad(rrule.pts) - gh) ** 2,
                                          dim=-1))
    return PoissonErrors(torch.sqrt(l2_sq), torch.sqrt(mm_sq),
                         torch.sqrt(en_sq))


def make_jitted_pipeline(hdi: HHODegreeInfo, rhs_fun, bc_fun, exact_grad,
                         stab: str = "hho",
                         cg_params: cg.CGParams = DEFAULT_CG):
    """The (mesh, dofmap) -> (solution, errors) pipeline of the JAX
    package's function of this name, as a plain function: nothing is
    jit-compiled here. bc_fun doubles as the exact solution for the
    errors, as in convergence_test.cpp:214,266."""

    def pipeline(mesh, dofmap):
        sol = solve_poisson(mesh, dofmap, hdi, rhs_fun, bc_fun, stab,
                            cg_params)
        return sol, compute_errors(mesh, hdi, sol, bc_fun, exact_grad)

    return pipeline
