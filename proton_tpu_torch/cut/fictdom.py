"""Fictitious-domain cutHHO Poisson on any classified mesh (JAX
counterpart: proton_tpu/cut/fictdom.py; reference run_cuthho_fictdom,
apps/cuthho/cuthho_square.cpp:806-1080).

Assembly by element class: the fitted HHO operators (methods/hho.py) run
over every cell, as the reference does for uncut cells of either side
(make_hho_laplacian falls back to the fitted operator there,
cuthho_square.cpp:316-317, and the cut stabilization to the naive one,
:572-573); the Nitsche cut operators run over the compact cut-cell batch
and overwrite the cut rows. The global system uses the fitted
assembler's dof layout and Dirichlet condensation (methods/assembly.py;
the reference reuses its ``assembler``, :882) and is solved with Jacobi
PCG (the reference's alternative path, :921-929). This is the solve that
runs on agglomerated, polygonal cut meshes; the generated N x N mesh has
the faster structured solve of cut/fictdom_structured.py.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..config import DEFAULT_DTYPE, resolve_device
from ..core import bases, quadrature
from ..core.geometry import cell_geometry
from ..core.ops import HHODegreeInfo, cell_rhs
from ..methods import assembly, hho
from ..solvers import cg
from ..utils.timing import sink, span
from . import methods as cut_methods
from .classify import LOC_CUT, LOC_NEG, CutData, cut_preprocess
from .levelset import LevelSet
from .methods import CutCellBatch, make_cut_batch
from .quadrature import side_cell_rule

DEFAULT_CG = cg.CGParams(convergence_threshold=1e-12,
                         divergence_threshold=1e8, max_iter=200000,
                         apply_preconditioner=True)


class FictdomResult(NamedTuple):
    x: torch.Tensor
    local: torch.Tensor                  # [C, d]
    h1_error: float
    iterations: int
    exit_reason: int
    min_eigs: Optional[torch.Tensor]     # [Cc] coercivity diagnostic
    oper_cut: Optional[torch.Tensor] = None  # [Cc, rbs, d]


def cut_cell_ids(cutdata: CutData) -> np.ndarray:
    """Host ids of the cut cells."""
    return np.nonzero(cutdata.cell_loc.cpu().numpy() == LOC_CUT)[0]


def assemble_fictdom_local(mesh, geom, batch: CutCellBatch, ls: LevelSet,
                           hdi: HHODegreeInfo, rhs_fun=None, bcs_fun=None,
                           side: int = LOC_NEG):
    """(lc [C, d, d], oper_cut [Cc, rbs, d]) of the fictitious-domain
    problem (assembly loop, cuthho_square.cpp:882-900). ``rhs_fun`` and
    ``bcs_fun`` stand where the JAX function has them, which reads
    neither; so does this one (the loads are assemble_fictdom_rhs)."""
    _, data_fit = hho.hho_laplacian(mesh, geom, hdi)
    lc = data_fit + hho.naive_stabilization(mesh, geom, hdi)
    oper_cut, data_cut = cut_methods.cut_hho_laplacian(batch, ls, hdi, side)
    lc[batch.ids] = data_cut + cut_methods.cut_stabilization(batch, hdi,
                                                             side)
    return lc, oper_cut


def assemble_fictdom_rhs(mesh, geom, batch: CutCellBatch, ls: LevelSet,
                         hdi: HHODegreeInfo, rhs_fun, bcs_fun, cell_loc,
                         side: int = LOC_NEG):
    """f [C, cbs]: the standard source on side cells, zero on off-side
    cells, the side source + Nitsche lifting on cut cells (make_rhs cut
    overload, cuthho_square.cpp:623-666)."""
    f_std = cell_rhs(mesh, geom, hdi.cell_degree, rhs_fun)
    f = torch.where((cell_loc == side)[:, None], f_std,
                    torch.zeros_like(f_std))
    f[batch.ids] = cut_methods.cut_rhs(batch, hdi.cell_degree, rhs_fun, ls,
                                       bcs_fun, side)
    return f


def solve_fictdom(mesh, cutdata: CutData, ls: LevelSet, degree: int,
                  rhs_fun: Callable, sol_fun: Callable, sol_grad: Callable,
                  cg_params: cg.CGParams = DEFAULT_CG,
                  check_coercivity: bool = False,
                  timings: Optional[dict] = None) -> FictdomResult:
    """Assemble, Jacobi-PCG solve, H1 error on the physical (negative)
    side (run_cuthho_fictdom, cuthho_square.cpp:806-1080); hdi =
    (degree+1, degree) as at :871. With a ``timings`` dict the seconds of
    each phase are recorded in it (device synchronized after each)."""
    hdi = HHODegreeInfo(degree + 1, degree)
    side = LOC_NEG
    dev = mesh.points.device

    with sink(timings):
        with span("assemble", dev):
            geom = cell_geometry(mesh)
            batch = make_cut_batch(mesh, geom, cutdata, cut_cell_ids(cutdata))
            lc, oper_cut = assemble_fictdom_local(mesh, geom, batch, ls, hdi,
                                                  side=side)
            f = assemble_fictdom_rhs(mesh, geom, batch, ls, hdi, rhs_fun,
                                     sol_fun, cutdata.cell_loc, side)
        with span("setup", dev):
            dofmap = assembly.build_dofmap(mesh, hdi)
            fd = assembly.dirichlet_face_data(mesh, hdi, sol_fun)
            g_loc = assembly.local_dirichlet_data(dofmap, mesh, fd)
            rhs = assembly.assemble_rhs(dofmap, f, lc, g_loc)
            apply_A = assembly.make_operator(dofmap, lc)
            # A face that lies off the physical side for every cell it
            # touches (two cut cells meet there on agglomerated meshes) gets
            # no contribution: its row and column are zero, and so is its
            # load. Jacobi takes 1 there, where the JAX package divides by
            # zero, so CG leaves those dofs at 0 instead of NaN.
            diag = assembly.operator_diagonal(dofmap, lc)
            diag = torch.where(diag == 0, torch.ones_like(diag), diag)
        with span("cg", dev):
            res = cg.conjugated_gradient(apply_A, rhs, diag, cg_params)
        with span("h1", dev):
            local = assembly.take_local_data(dofmap, res.x, g_loc)
            h1 = fictdom_h1_error(mesh, geom, batch, cutdata, hdi, local,
                                  sol_grad, side)

    eigs = None
    if check_coercivity:
        eigs = torch.min(cut_methods.check_eigs(batch, ls, hdi, side),
                         dim=1).values
    return FictdomResult(res.x, local, float(h1), res.iterations,
                         res.exit_reason, eigs, oper_cut)


def fictdom_h1_error(mesh, geom, batch: CutCellBatch, cutdata: CutData,
                     hdi: HHODegreeInfo, local, sol_grad,
                     side: int = LOC_NEG):
    """H1 error of the cell polynomial over the physical side
    (cuthho_square.cpp:1031-1050): the standard rule on side cells, the
    side rule on cut cells; gradient of the cell unknown (cell-degree
    basis, constant skipped). A 0-d tensor."""
    cbs = bases.cell_basis_size(hdi.cell_degree)
    cdofs = local[:, :cbs]

    rule = quadrature.cell_rule(mesh, geom, 2 * hdi.cell_degree)
    dphi = bases.eval_cell_gradients(rule.pts, geom.bar[:, None, :],
                                     geom.diam[:, None], hdi.cell_degree)
    gh = torch.einsum("cqix,ci->cqx", dphi[:, :, 1:, :], cdofs[:, 1:])
    per_cell = torch.sum(rule.w * torch.sum((sol_grad(rule.pts) - gh) ** 2,
                                            dim=-1), dim=1)
    err = torch.sum(torch.where(cutdata.cell_loc == side, per_cell,
                                torch.zeros_like(per_cell)))

    poly = cut_methods.side_polygon(batch, side)
    crule = side_cell_rule(poly, 2 * hdi.cell_degree)
    g = batch.geom
    cdphi = bases.eval_cell_gradients(crule.pts, g.bar[:, None, :],
                                      g.diam[:, None], hdi.cell_degree)
    cgh = torch.einsum("cqix,ci->cqx", cdphi[:, :, 1:, :],
                       cdofs[batch.ids][:, 1:])
    err = err + torch.sum(crule.w * torch.sum(
        (sol_grad(crule.pts) - cgh) ** 2, dim=-1))
    return torch.sqrt(err)


def fictdom_fields(mesh, cutdata: CutData, ls: LevelSet, degree: int,
                   result: FictdomResult, sol_fun, plot_degree: int = 5):
    """Point-cloud fields of the fictdom postprocess
    (cuthho_square.cpp:1010-1029): uT (cell polynomial), Ru (potential
    reconstruction) and the relative difference against the exact
    solution, at a degree-``plot_degree`` rule of every cell. Returns
    (pts [C, Q, 2], uT [C, Q], Ru [C, Q], diff [C, Q])."""
    hdi = HHODegreeInfo(degree + 1, degree)
    geom = cell_geometry(mesh)
    cbs = bases.cell_basis_size(hdi.cell_degree)

    rule = quadrature.cell_rule(mesh, geom, plot_degree)
    rphi = bases.eval_cell_basis(rule.pts, geom.bar[:, None, :],
                                 geom.diam[:, None],
                                 hdi.reconstruction_degree)
    uT = torch.einsum("cqi,ci->cq", rphi[..., :cbs], result.local[:, :cbs])

    # reconstruction dofs: fitted (rbs-1, constant from cell dof 0) for
    # uncut cells, the full-rbs Nitsche operator for cut cells
    # (cuthho_square.cpp:970-976, 1019-1024)
    oper_fit, _ = hho.hho_laplacian(mesh, geom, hdi)
    rec_fit = torch.einsum("crd,cd->cr", oper_fit, result.local)
    Ru = torch.einsum("cqr,cr->cq", rphi[..., 1:], rec_fit) + \
        result.local[:, :1]

    cut_ids = cut_cell_ids(cutdata)
    if len(cut_ids) and result.oper_cut is not None:
        ids = torch.as_tensor(cut_ids, device=Ru.device)
        rec_cut = torch.einsum("crd,cd->cr", result.oper_cut,
                               result.local[ids])
        Ru[ids] = torch.einsum("cqr,cr->cq", rphi[ids], rec_cut)

    exact = sol_fun(rule.pts)
    diff = torch.abs(Ru - exact) * 100.0 / torch.where(
        exact == 0, torch.ones_like(exact), exact)
    return rule.pts, uT, Ru, diff


def run_fictdom(N: int, degree: int, radius: float = 0.35,
                center=(0.5, 0.5), int_refsteps: int = 4,
                agglomeration: bool = False, *, device=None,
                dtype=DEFAULT_DTYPE, timings: Optional[dict] = None, **kw):
    """End-to-end ``cuthho_square -f`` (cuthho_square.cpp:1940-2068): the
    N x N polygonal mesh, the circle level set of radius 0.35 at (0.5,
    0.5), u = sin(pi x) sin(pi y). Runs on CUDA unless ``device`` is
    given; raises without one when CUDA is absent."""
    from ..core.mesh import make_poly_mesh
    from .fictdom_structured import default_problem

    device = resolve_device(device)
    p = default_problem(radius, center)
    with sink(timings), span("classify", device):
        mesh = make_poly_mesh(Nx=N, Ny=N, device=device, dtype=dtype)
        mesh, cutdata = cut_preprocess(mesh, p.ls, levels=int_refsteps,
                                       agglomeration=agglomeration)
    return solve_fictdom(mesh, cutdata, p.ls, degree, p.rhs_fun, p.sol_fun,
                         p.sol_grad, timings=timings, **kw)
