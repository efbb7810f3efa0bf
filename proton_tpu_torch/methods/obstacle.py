"""HHO obstacle problem: primal-dual active-set iteration (JAX
counterpart: proton_tpu/methods/obstacle.py; reference
obstacle_assembler, hho.hpp:471-789, and apps/obstacle/obstacle.cpp).

The reference assembles an unsymmetric square system per active-set
iteration (one Lagrange-multiplier column per active cell) and solves it
with SparseLU. As in the JAX package, the active-cell values are pinned
to the obstacle gamma and folded into the RHS like Dirichlet data, the
remaining SPD system goes through Jacobi PCG, and the multipliers are
recovered as beta_A = f_A - (A u)_A, which is what the identity rows
encode (hho.hpp:688-693).

The JAX ``lax.while_loop`` over the active-set iterations is a Python
loop here, with one scalar read per iteration (the change ``delta``)
besides the CG loop's own.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..core import bases
from ..core.geometry import cell_geometry
from ..core.mesh import MeshInitParams, make_quad_mesh
from ..core.ops import HHODegreeInfo, cell_rhs, project_function
from ..solvers import cg
from . import assembly, poisson


class ObstacleResult(NamedTuple):
    alpha: torch.Tensor         # [C*cbs + F*fbs]: all cells, then ALL
    #                             faces (hho.hpp:698-744)
    beta: torch.Tensor          # [C] Lagrange multipliers (0 on inactive)
    iterations: int             # active-set iterations performed
    converged: bool             # ||alpha_prev - alpha|| < threshold
    energy_error: torch.Tensor  # NaN without sol_fun


def _masked_dofmap_idx(dofmap: assembly.DofMap, in_A):
    """asm_idx with the cell dofs of active cells re-pointed at the
    sentinel (the reference's A_ct compress table, hho.hpp:539-550), and
    that mask."""
    mask = torch.zeros_like(dofmap.asm_idx, dtype=torch.bool)
    mask[:, :dofmap.cbs] = in_A[:, None]
    return torch.where(mask, dofmap.n_dofs, dofmap.asm_idx), mask


def solve_obstacle(mesh, degree: int, rhs_fun: Callable, bcs_fun: Callable,
                   obstacle_fun: Callable, sol_fun: Callable = None,
                   max_iter: int = 50, threshold: float = 1e-7,
                   c: float = 1.0, quadrature_degree_increase: int = 1,
                   cg_params: cg.CGParams = poisson.DEFAULT_CG,
                   iteration_callback: Callable = None,
                   initial_state=None) -> ObstacleResult:
    """run_hho_obstacle (obstacle.cpp:47-227) with hdi = (0, degree): cell
    degree 0, so alpha's cell block is one value per cell.

    ``iteration_callback(i, fields)`` is called after active-set iteration
    i (1-based) with fields alpha, beta, active (beta != 0), delta and
    cg_iterations (that iteration's). ``initial_state`` = (alpha_cells,
    beta), e.g. from utils.checkpoint.obstacle_resume, resumes the loop.
    """
    hdi = HHODegreeInfo(0, degree)
    geom = cell_geometry(mesh)
    C, F, nF = mesh.num_cells, mesh.num_faces, mesh.max_pts
    fbs = bases.face_basis_size(degree)
    dt, dev = mesh.points.dtype, mesh.points.device

    # local operators: reconstruction + HHO stabilization (obstacle.cpp:150)
    _, lc = poisson.assemble_local(mesh, geom, hdi, "hho")
    f = cell_rhs(mesh, geom, 0, rhs_fun, di=quadrature_degree_increase)
    dofmap = assembly.build_dofmap(mesh, hdi)
    fd = assembly.dirichlet_face_data(mesh, hdi, bcs_fun)
    g_dir = assembly.local_dirichlet_data(dofmap, mesh, fd)
    gamma = obstacle_fun(geom.bar)                       # obstacle.cpp:113
    zero = torch.zeros((), dtype=dt, device=dev)

    def one_iteration(alpha_cells, beta):
        in_A = beta + c * (alpha_cells - gamma) < 0      # obstacle.cpp:133
        asm_idx, Amask = _masked_dofmap_idx(dofmap, in_A)
        g_loc = g_dir + torch.where(Amask, gamma[:, None], zero)
        loads = torch.zeros((C, dofmap.d), dtype=dt, device=dev)
        # active rows leave the system; f_A feeds beta
        loads[:, :1] = torch.where(in_A[:, None], zero, f)
        loads = loads - assembly._apply_local(lc, g_loc)
        rhs = assembly.scatter_values(asm_idx, dofmap.n_dofs, loads)

        def apply_A(x):
            xl = assembly.gather_values(asm_idx, x)
            return assembly.scatter_values(asm_idx, dofmap.n_dofs,
                                           assembly._apply_local(lc, xl))

        diag = assembly.scatter_values(asm_idx, dofmap.n_dofs,
                                       torch.diagonal(lc, dim1=1, dim2=2))
        diag = torch.where(diag == 0, torch.ones_like(diag), diag)
        res = cg.conjugated_gradient(apply_A, rhs, diag, cg_params)

        # expand (obstacle.cpp:182, hho.hpp:698-744)
        u_loc = assembly.gather_values(asm_idx, res.x) + g_loc
        new_alpha = torch.where(in_A, gamma, u_loc[:, 0])
        resid = f[:, 0] - assembly._apply_local(lc, u_loc)[:, 0]
        return new_alpha, torch.where(in_A, resid, zero), u_loc, \
            res.iterations

    if initial_state is not None:
        alpha_cells, beta = (torch.as_tensor(a, dtype=dt, device=dev)
                             for a in initial_state)
    else:
        alpha_cells = torch.zeros(C, dtype=dt, device=dev)
        beta = torch.ones(C, dtype=dt, device=dev)       # obstacle.cpp:99
    u_loc = torch.zeros((C, dofmap.d), dtype=dt, device=dev)
    it, delta = 0, float("inf")
    while delta >= threshold and it < max_iter:
        new_alpha, beta, u_loc, cg_its = one_iteration(alpha_cells, beta)
        delta = float(torch.linalg.vector_norm(new_alpha - alpha_cells))
        alpha_cells = new_alpha
        it += 1
        if iteration_callback is not None:
            iteration_callback(it, {"alpha": alpha_cells, "beta": beta,
                                    "active": beta != 0, "delta": delta,
                                    "cg_iterations": cg_its})

    # alpha in the reference layout: cells, then ALL faces; all owning
    # cells agree on a shared face, so the face value is their mean
    valid = geom.edge_valid.reshape(-1)
    faces = mesh.cell_faces.reshape(-1)
    counts = torch.zeros(F, dtype=dt, device=dev).index_add_(
        0, faces, valid.to(dt))
    face_vals = u_loc[:, 1:].reshape(C * nF, fbs) * valid[:, None]
    sums = torch.zeros((F, fbs), dtype=dt, device=dev).index_add_(
        0, faces, face_vals)
    face_dofs = sums / torch.clamp(counts, min=1.0)[:, None]
    alpha = torch.cat([alpha_cells, face_dofs.reshape(-1)])

    # energy error against the projection of the exact solution
    # (obstacle.cpp:199-218)
    energy_error = torch.full((), float("nan"), dtype=dt, device=dev)
    if sol_fun is not None:
        proj = project_function(mesh, geom, hdi, sol_fun,
                                di=quadrature_degree_increase)
        local = torch.cat([alpha_cells[:, None],
                           face_dofs[mesh.cell_faces].reshape(C, nF * fbs)],
                          dim=1)
        dv = local - proj
        energy_error = torch.sqrt(torch.sum(
            dv * assembly._apply_local(lc, dv)))
    return ObstacleResult(alpha, beta, it, delta < threshold, energy_error)


def run_obstacle(N: int, degree: int, *, device=None,
                 **kw) -> ObstacleResult:
    """The reference app configuration (obstacle.cpp:229-284): N x N quads
    on [-1, 1]^2, exact radial solution max(r^2 - r0^2, 0)^2 with r0 = 0.7,
    zero obstacle. Runs on ``device`` (CUDA by default)."""
    if degree not in (0, 1):
        print("Degree can be 0 or 1. Falling back to 1")
        degree = 1
    mesh = make_quad_mesh(MeshInitParams(min_x=-1.0, min_y=-1.0, Nx=N, Ny=N),
                          device=device)
    r0 = 0.7

    def rhs_fun(p):
        r2 = p[..., 0] ** 2 + p[..., 1] ** 2
        return torch.where(r2 > r0 * r0, -16.0 * r2 + 8.0 * r0 * r0,
                           -8.0 * (r0 * r0 * (r0 * r0 + 1.0))
                           + 8.0 * r0 * r0 * r2)

    def sol_fun(p):
        r2 = p[..., 0] ** 2 + p[..., 1] ** 2
        t = torch.clamp(r2 - r0 * r0, min=0.0)
        return t * t

    def obstacle_fun(p):
        return torch.zeros_like(p[..., 0])

    return solve_obstacle(mesh, degree, rhs_fun, sol_fun, obstacle_fun,
                          sol_fun, **kw)
