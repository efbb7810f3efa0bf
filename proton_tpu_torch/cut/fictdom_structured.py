"""Fictitious-domain cutHHO Poisson on the generated N x N mesh, solved
as a cells-last condensed face-grid system (JAX counterpart:
proton_tpu/cut/fictdom_structured.py, the fitted="full" path with the
block-Jacobi or Jacobi preconditioned CG; reference run_cuthho_fictdom,
cuthho_square.cpp:806-1080).

The pipeline:

1. band classification of the circle level set (cut/classify.py);
2. fitted local operators of every cell from kernel K1
   (methods/fused_assembly.py), with the Nitsche cut-cell operators
   (cut/methods.py) overwriting the cut class;
3. static condensation onto the faces (methods/cells_last.condense_cl);
4. Dirichlet fold, then PCG on the H/V face grids with the per-face
   block-Jacobi (or Jacobi) preconditioner;
5. cell recovery and the chunked H1 error.

Not ported here: the multigrid V-cycle, the lean/uniform split systems,
the mixed-precision cut splice, the setup caches and the chunked solve
(ROADMAP.md, "Modules to port").
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..config import DEFAULT_DTYPE, resolve_device, synchronize
from ..core import bases, quadrature
from ..core.geometry import cell_geometry, cell_points
from ..core.mesh import make_poly_mesh
from ..core.ops import HHODegreeInfo, cell_rhs
from ..methods import assembly, cells_last, fused_assembly, structured
from ..solvers import cg
from . import methods as cut_methods
from .classify import LOC_CUT, LOC_NEG, CutData, cut_preprocess_band
from .levelset import LevelSet, circle_level_set
from .quadrature import side_cell_rule


def nitsche_eta(degree: int) -> float:
    """Nitsche penalty: eta = 5 as the reference hard-codes
    (cuthho_square.cpp:435) for k <= 1, scaled by (k+1)^2 above."""
    return 5.0 if degree < 2 else 5.0 * (degree + 1) ** 2


class FictdomProblem(NamedTuple):
    """Manufactured problem + geometry of the fictdom driver."""

    ls: LevelSet
    rhs_fun: Callable
    sol_fun: Callable
    sol_grad: Callable


def default_problem(radius: float = 0.35, center=(0.5, 0.5)) -> FictdomProblem:
    """The reference's defaults (cuthho_square.cpp:1940-2068): circle
    level set, u = sin(pi x) sin(pi y)."""
    pi = np.pi
    return FictdomProblem(
        ls=circle_level_set(radius, *center),
        rhs_fun=lambda p: 2.0 * pi ** 2 * torch.sin(pi * p[..., 0]) *
        torch.sin(pi * p[..., 1]),
        sol_fun=lambda p: torch.sin(pi * p[..., 0]) * torch.sin(pi * p[..., 1]),
        sol_grad=lambda p: torch.stack(
            [pi * torch.cos(pi * p[..., 0]) * torch.sin(pi * p[..., 1]),
             pi * torch.sin(pi * p[..., 0]) * torch.cos(pi * p[..., 1])],
            dim=-1))


class LevelData(NamedTuple):
    """Classified + assembled data of one mesh level."""

    mesh: object
    cutdata: CutData
    cut_ids: np.ndarray
    cond: cells_last.CondensedCL
    batch: cut_methods.CutCellBatch
    cell_loc: torch.Tensor


class StructuredFictdomResult(NamedTuple):
    local: torch.Tensor           # [C, d] per-cell (uT, uF) dofs
    iterations: int
    exit_reason: int
    rel_residual: float
    h1_error: Optional[float]
    timings: dict


def classify_level(N: int, problem: FictdomProblem, int_refsteps: int, *,
                   device, dtype=DEFAULT_DTYPE):
    """Mesh + band classification of one level; returns (mesh', CutData,
    host cut-cell ids)."""
    mesh = make_poly_mesh(Nx=N, Ny=N, device=device, dtype=dtype)
    mesh, cutdata = cut_preprocess_band(mesh, problem.ls, levels=int_refsteps)
    cut_ids = np.nonzero(cutdata.cell_loc.cpu().numpy() == LOC_CUT)[0]
    return mesh, cutdata, cut_ids


def _classify(N: int, problem: FictdomProblem, int_refsteps: int, *, device,
              dtype=DEFAULT_DTYPE):
    """Classification phase (JAX _classify_host without the disk caches
    or the host/device split): (mesh, cutdata, cut_ids, cell_loc, batch,
    distorted ids)."""
    mesh, cutdata, cut_ids = classify_level(N, problem, int_refsteps,
                                            device=device, dtype=dtype)
    batch = cut_methods.make_cut_batch(mesh, cell_geometry(mesh), cutdata,
                                       cut_ids)
    dist_ids = np.nonzero(cutdata.distorted.cpu().numpy())[0]
    return mesh, cutdata, cut_ids, cutdata.cell_loc, batch, dist_ids


def _assemble_level_cl(mesh, geom, cell_loc, batch, hdi: HHODegreeInfo,
                       problem: FictdomProblem, eta: float,
                       side: int = LOC_NEG):
    """(lc_cl [d*d, C], f_cl [cbs, C]): fitted operators of every cell
    from K1 (the uncut fallback, cuthho_square.cpp:316-317), the Nitsche
    cut operators overwriting the cut class. The JAX function condenses
    before returning; here build_level condenses, to time it apart."""
    lc_cl = fused_assembly.fitted_local_operator(mesh, geom, hdi,
                                                 cells_last=True)
    _, data_cut = cut_methods.cut_hho_laplacian(batch, problem.ls, hdi, side,
                                                eta=eta)
    lc_cut = data_cut + cut_methods.cut_stabilization(batch, hdi, side)
    d = lc_cut.shape[1]
    cells_last.set_columns(lc_cl, batch.ids,
                           lc_cut.permute(1, 2, 0).reshape(d * d, -1))

    f_std = cell_rhs(mesh, geom, hdi.cell_degree, problem.rhs_fun)
    f = torch.where((cell_loc == side)[:, None], f_std,
                    torch.zeros_like(f_std))
    f[batch.ids] = cut_methods.cut_rhs(batch, hdi.cell_degree,
                                       problem.rhs_fun, problem.ls,
                                       problem.sol_fun, side, eta=eta)
    return lc_cl, f.T


def _check_fitted(fitted: str) -> None:
    if fitted != "full":
        raise NotImplementedError(
            f"fitted={fitted!r}: the lean/uniform split systems come with "
            "the multigrid slice (ROADMAP.md, Modules to port, remaining 2)")


def _check_precond(precond: str) -> None:
    if precond not in ("block_jacobi", "jacobi"):
        raise NotImplementedError(
            f"precond={precond!r}: the multigrid V-cycle comes with the "
            "multigrid slice (ROADMAP.md, Modules to port, remaining 2)")


def build_level(N: int, hdi: HHODegreeInfo, problem: FictdomProblem,
                eta: float, int_refsteps: int, *, device,
                dtype=DEFAULT_DTYPE, fitted: str = "full",
                timings: Optional[dict] = None) -> LevelData:
    """Classify + assemble + condense one level (fitted="full": every
    cell assembled by K1). Phase times go into ``timings``."""
    _check_fitted(fitted)
    device = resolve_device(device)
    timings = {} if timings is None else timings
    t0 = time.perf_counter()
    mesh, cutdata, cut_ids, cell_loc, batch, _ = _classify(
        N, problem, int_refsteps, device=device, dtype=dtype)
    synchronize(device)
    timings["classify_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    geom = cell_geometry(mesh)
    lc_cl, f_cl = _assemble_level_cl(mesh, geom, cell_loc, batch, hdi,
                                     problem, eta)
    del geom
    synchronize(device)
    timings["assembly_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cond = cells_last.condense_cl(lc_cl, f_cl,
                                  bases.cell_basis_size(hdi.cell_degree))
    del lc_cl
    synchronize(device)
    timings["condense_s"] = time.perf_counter() - t0
    return LevelData(mesh, cutdata, cut_ids, cond, batch, cell_loc)


class FaceSystem(NamedTuple):
    """The face-grid system of one level, ready for CG."""

    sys: structured.StructuredFaceSystem
    gF_cl: torch.Tensor                  # [nfd, C] Dirichlet data, face slots
    rhs: cells_last.GridVecCL
    apply_S: Callable
    precond: Optional[Callable]          # block-Jacobi; None with Jacobi
    diag: Optional[cells_last.GridVecCL]  # the Jacobi diagonal


def face_system(level: LevelData, N: int, hdi: HHODegreeInfo,
                problem: FictdomProblem, precond: str, *,
                device) -> FaceSystem:
    """Dirichlet fold (JAX _solve_jit :1915-1917), condensed rhs and
    operator (:1932-1942) and the preconditioner (:2025-2035)."""
    _check_precond(precond)
    device = resolve_device(device)
    fbs = bases.face_basis_size(hdi.face_degree)
    cbs = bases.cell_basis_size(hdi.cell_degree)
    sys_f = structured.make_structured_system(N, N, fbs, device=device)
    dofmap = assembly.build_dofmap_structured(N, hdi, device=device)
    fd = assembly.dirichlet_face_data(level.mesh, hdi, problem.sol_fun)
    gF_cl = assembly.local_dirichlet_data(dofmap, level.mesh, fd)[:, cbs:].T
    S = level.cond.S
    rhs = cells_last.structured_rhs_cl(sys_f, level.cond, gF_cl)
    apply_S = cells_last.make_structured_operator_cl(sys_f, S)
    if precond == "block_jacobi":
        return FaceSystem(sys_f, gF_cl, rhs, apply_S,
                          cells_last.block_jacobi_preconditioner_cl(sys_f, S),
                          None)
    return FaceSystem(sys_f, gF_cl, rhs, apply_S, None,
                      cells_last.structured_diagonal_cl(sys_f, S))


def solve_fictdom_structured(
        N: int, degree: int, problem: Optional[FictdomProblem] = None,
        int_refsteps: int = 4, precond: str = "block_jacobi",
        cg_params: Optional[cg.CGParams] = None, compute_h1: bool = True,
        fitted: str = "full", side: int = LOC_NEG, *, device=None,
        dtype=DEFAULT_DTYPE) -> StructuredFictdomResult:
    """End-to-end fictdom solve on the generated N x N mesh at HHO degree
    ``degree`` (cell degree k+1, face degree k). ``precond``:
    'block_jacobi' (per-face blocks) or 'jacobi' (the reference's PCG
    preconditioner, solver_cg.hpp:63-144). Runs on CUDA unless
    ``device="cpu"``; raises without a device when CUDA is absent."""
    device = resolve_device(device)
    _check_precond(precond)
    _check_fitted(fitted)
    if problem is None:
        problem = default_problem()
    if cg_params is None:
        cg_params = cg.CGParams(convergence_threshold=1e-6,
                                divergence_threshold=1e8, max_iter=50000,
                                apply_preconditioner=True)
    hdi = HHODegreeInfo(degree + 1, degree)
    timings = {}

    fine = build_level(N, hdi, problem, nitsche_eta(degree), int_refsteps,
                       device=device, dtype=dtype, fitted=fitted,
                       timings=timings)
    mesh = fine.mesh

    t0 = time.perf_counter()
    fsys = face_system(fine, N, hdi, problem, precond, device=device)
    synchronize(device)
    timings["setup_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    res = cg.conjugated_gradient(fsys.apply_S, fsys.rhs, fsys.diag,
                                 cg_params, precond=fsys.precond)
    synchronize(device)
    timings["cg_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    local = cells_last.solve_recover_cl(fsys.sys, fine.cond, res.x,
                                        fsys.gF_cl)
    synchronize(device)
    timings["recover_s"] = time.perf_counter() - t0

    h1 = None
    if compute_h1:
        t0 = time.perf_counter()
        h1 = fictdom_h1_error_chunked(mesh, cell_geometry(mesh), fine.batch,
                                      fine.cell_loc, hdi, local,
                                      problem.sol_grad, side)
        timings["h1_s"] = time.perf_counter() - t0

    return StructuredFictdomResult(local, res.iterations, res.exit_reason,
                                   res.rel_residual, h1, timings)


def fictdom_h1_error_chunked(mesh, geom, batch, cell_loc,
                             hdi: HHODegreeInfo, local, sol_grad,
                             side: int = LOC_NEG, chunk: int = 65536
                             ) -> float:
    """H1(grad) error over the physical side (fictdom_h1_error,
    cuthho_square.cpp:1031-1050): the fitted cells of ``side`` in blocks
    of ``chunk`` cells, so no [C, Q, rbs, 2] tensor of the whole mesh
    exists, plus the cut cells on their side quadrature."""
    celdeg = hdi.cell_degree
    cbs = bases.cell_basis_size(celdeg)
    cdofs = local[:, :cbs]
    cp = cell_points(mesh)[:, :4, :]
    mask = cell_loc == side
    err = torch.zeros((), dtype=local.dtype, device=local.device)
    for s in range(0, mesh.num_cells, chunk):
        e = slice(s, s + chunk)
        rule = quadrature.quad_cell_rule(cp[e], 2 * celdeg)
        dphi = bases.eval_cell_gradients(rule.pts, geom.bar[e, None, :],
                                         geom.diam[e, None], celdeg)
        gh = torch.einsum("cqix,ci->cqx", dphi[:, :, 1:, :], cdofs[e, 1:])
        ge = sol_grad(rule.pts)
        per_cell = torch.sum(rule.w * torch.sum((ge - gh) ** 2, dim=-1),
                             dim=1)
        err = err + torch.sum(torch.where(mask[e], per_cell,
                                          torch.zeros_like(per_cell)))

    poly = cut_methods.side_polygon(batch, side)
    crule = side_cell_rule(poly, 2 * celdeg)
    g = batch.geom
    cdphi = bases.eval_cell_gradients(crule.pts, g.bar[:, None, :],
                                      g.diam[:, None], celdeg)
    cgh = torch.einsum("cqix,ci->cqx", cdphi[:, :, 1:, :],
                       cdofs[batch.ids][:, 1:])
    cge = sol_grad(crule.pts)
    err = err + torch.sum(crule.w * torch.sum((cge - cgh) ** 2, dim=-1))
    return float(torch.sqrt(err))
