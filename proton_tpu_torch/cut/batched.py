"""Geometry families: the fictitious-domain problem solved for many
level-set geometries on one shared N x N mesh (JAX counterpart:
proton_tpu/cut/batched.py; the BASELINE.md stretch configuration, which
the reference reaches by looping ``cuthho_square`` invocations,
cuthho_square.cpp:2030-2031).

The geometries run one after another in a Python loop. The mesh, the
dofmap and the face-grid system are built once and shared; one
geometry's tensors are live at a time. Per geometry:

1. classification with node displacement (classify._preprocess_core),
   which moves the nodes of badly cut cells;
2. the fitted local operators of every cell of the displaced mesh, all
   quads, from kernel K1 (methods/fused_assembly.py), one launch over
   all C cells; the Nitsche operators of the cut class overwrite their
   columns (cut/methods.py);
3. the cells-last condensed solve with Jacobi PCG
   (structured.solve_condensed_structured_cl), the reference's
   preconditioner;
4. the H1 error over the physical side.

The cut class has the JAX package's fixed capacity (``padded_cut_ids``):
cut cells beyond it keep the fitted operator with a zero load, so the
system is wrong, ``n_cut_overflow`` says so and the H1 error is NaN. The
JAX package computes the cut operators on all ``capacity`` rows, the
padding rows on clamped ids, and its scatter drops them; here the cut
batch holds only the valid rows (the first min(n_cut, capacity) cut
cells, ascending), which gives the same system.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import DEFAULT_DTYPE, resolve_device
from ..core import bases
from ..core.geometry import cell_geometry
from ..core.mesh import make_poly_mesh
from ..core.ops import HHODegreeInfo
from ..methods import assembly, fused_assembly, structured
from ..solvers import cg
from ..utils.timing import sink, span
from . import methods as cut_methods
from .classify import LOC_CUT, LOC_NEG, _preprocess_core
from .fictdom_structured import (FictdomProblem, _cut_loads_cl,
                                 _cut_operators_cl, _loads_cl,
                                 default_problem, fictdom_h1_error_chunked,
                                 nitsche_eta)
from .levelset import ellipse_level_set, flower_level_set


class FamilyResult(NamedTuple):
    """Per-geometry results, [B] tensors on the host."""

    h1_error: torch.Tensor        # [B] float64, NaN after an overflow
    iterations: torch.Tensor      # [B]
    exit_reason: torch.Tensor     # [B]
    rel_residual: torch.Tensor    # [B]
    n_cut: torch.Tensor           # [B] number of cut cells
    n_cut_overflow: torch.Tensor  # [B] cut cells beyond capacity (0 = ok)
    n_bad_cuts: torch.Tensor      # [B] cells with an invalid cut count
    concave: torch.Tensor         # [B] node displacement made a concave cell


def padded_cut_ids(cell_loc, capacity: int):
    """Fixed-capacity cut-cell ids: the cells with ``cell_loc == LOC_CUT``
    at the front in ascending order, the tail padded with the sentinel C.
    Returns (ids [min(capacity, C)] int64, valid bool, n_cut, n_overflow),
    the counts as 0-d tensors."""
    C = cell_loc.shape[0]
    is_cut = cell_loc == LOC_CUT
    order = torch.argsort((~is_cut).to(torch.int32), stable=True)
    ids = order[:capacity]
    valid = is_cut[ids]
    ids = torch.where(valid, ids, torch.full_like(ids, C))
    n_cut = is_cut.sum()
    return ids, valid, n_cut, torch.clamp(n_cut - capacity, min=0)


def circle_family(params) -> FictdomProblem:
    """params = (radius, cx, cy) -> the reference's circle problem."""
    radius, cx, cy = params
    return default_problem(float(radius), (float(cx), float(cy)))


def ellipse_family(params) -> FictdomProblem:
    """params = (a, b, cx, cy) -> the fictdom problem on an ellipse level
    set with the reference's manufactured solution."""
    a, b, cx, cy = (float(p) for p in params)
    base = default_problem()
    return FictdomProblem(ellipse_level_set(a, b, cx, cy), base.rhs_fun,
                          base.sol_fun, base.sol_grad)


def flower_family(petals: int) -> Callable:
    """``family((r0, amp, cx, cy)) -> FictdomProblem`` on the non-convex
    flower level set of ``petals`` petals, with the reference's
    manufactured solution."""

    def family(params) -> FictdomProblem:
        r0, amp, cx, cy = (float(p) for p in params)
        base = default_problem()
        return FictdomProblem(flower_level_set(r0, amp, petals, cx, cy),
                              base.rhs_fun, base.sol_fun, base.sol_grad)

    return family


def _solve_one_geometry(mesh, dofmap, sys_f, params, *, family,
                        hdi: HHODegreeInfo, eta: float, capacity: int,
                        int_refsteps: int, chunk: int,
                        cg_params: cg.CGParams, side: int = LOC_NEG,
                        timings: Optional[dict] = None) -> tuple:
    """One geometry of the family (module docstring): returns its
    FamilyResult row as Python numbers. Phase seconds are added to
    ``timings`` (classify_s, fitted_s, cut_s, condense_s, cg_s,
    recover_s, h1_s)."""
    problem = family(params)
    cbs = bases.cell_basis_size(hdi.cell_degree)
    dev = mesh.points.device

    with sink(timings):
        with span("classify", dev):
            pts, cutdata, concave, n_bad = _preprocess_core(
                mesh, problem.ls, int_refsteps, agglomeration=False,
                displacement=True)
            mesh2 = mesh.with_points(pts)
            geom = cell_geometry(mesh2)
            ids, _, n_cut, n_over = padded_cut_ids(cutdata.cell_loc, capacity)
            n_cut, n_over = int(n_cut), int(n_over)
            vids = ids[:n_cut - n_over]
            batch = cut_methods.make_cut_batch(mesh2, geom, cutdata, vids)
        with span("fitted", dev):
            lc_cl = fused_assembly.fitted_local_operator(mesh2, geom, hdi,
                                                         cells_last=True)
        with span("cut", dev):
            f_cl = _loads_cl(mesh2, geom, cutdata.cell_loc, hdi, problem, True,
                             side)
            if len(vids):
                lc_cl[:, vids] = _cut_operators_cl(batch, hdi, problem, eta,
                                                   side)
                f_cl[:, vids] = _cut_loads_cl(batch, hdi, problem, eta, True,
                                              side)
            fd = assembly.dirichlet_face_data(mesh2, hdi, problem.sol_fun)
            gF_cl = assembly.local_dirichlet_data(dofmap, mesh2, fd)[:, cbs:].T

        local, res = structured.solve_condensed_structured_cl(
            sys_f, lc_cl, f_cl, cbs, gF_cl, cg_params, timings=timings)
        del lc_cl, f_cl
        with span("h1", dev):
            h1 = fictdom_h1_error_chunked(mesh2, geom, batch, cutdata.cell_loc,
                                          hdi, local, problem.sol_grad, side,
                                          chunk=chunk)
    # an overflowed cut class solved a wrong system: poison its error
    if n_over > 0:
        h1 = math.nan
    return (h1, res.iterations, res.exit_reason, res.rel_residual, n_cut,
            n_over, n_bad, concave)


def _param_rows(params: Sequence) -> list:
    """A tuple of [B] array-likes -> B tuples of Python floats."""
    cols = [np.asarray(p.cpu() if isinstance(p, torch.Tensor) else p,
                       dtype=np.float64).reshape(-1) for p in params]
    if len({len(c) for c in cols}) != 1:
        raise ValueError("every parameter needs the same number of "
                         f"geometries, got {[len(c) for c in cols]}")
    return [tuple(float(c[b]) for c in cols) for b in range(len(cols[0]))]


def solve_fictdom_family_params(N: int, degree: int, params: Sequence,
                                family: Callable,
                                capacity: Optional[int] = None,
                                int_refsteps: int = 4, chunk: int = 16384,
                                geom_chunk: Optional[int] = None,
                                cg_params: Optional[cg.CGParams] = None, *,
                                device=None, dtype=DEFAULT_DTYPE,
                                timings: Optional[dict] = None
                                ) -> FamilyResult:
    """Solve the fictdom Poisson problem for a family of level-set
    geometries on the shared N x N mesh at HHO degree ``degree``.
    ``params`` is a tuple of [B] arrays, geometry b taking entry b of
    each; ``family(row) -> FictdomProblem`` (circle_family,
    ellipse_family, flower_family(petals)). ``capacity`` (default 6N) is
    the fixed size of the cut class. The CG default is the JAX package's:
    Jacobi PCG, tol 1e-6.

    ``geom_chunk`` tiles the JAX package's vmap over geometries. Here the
    geometries run one at a time whatever the tile, so it is validated
    and changes no result and no memory. Runs on CUDA unless
    ``device="cpu"``. With a ``timings`` dict, each phase's seconds,
    summed over the geometries, are added to it."""
    device = resolve_device(device)
    if geom_chunk is not None and (not isinstance(geom_chunk, int) or
                                   geom_chunk < 1):
        raise ValueError(f"geom_chunk={geom_chunk!r}: expected a positive "
                         "int or None")
    rows = _param_rows(params)
    if capacity is None:
        capacity = 6 * N
    if cg_params is None:
        cg_params = structured.DEFAULT_CG
    hdi = HHODegreeInfo(degree + 1, degree)
    mesh = make_poly_mesh(Nx=N, Ny=N, device=device, dtype=dtype)
    dofmap = assembly.build_dofmap(mesh, hdi)
    sys_f = structured.make_structured_system(
        N, N, bases.face_basis_size(hdi.face_degree), device=device)

    out = [_solve_one_geometry(
        mesh, dofmap, sys_f, row, family=family, hdi=hdi,
        eta=nitsche_eta(degree), capacity=capacity,
        int_refsteps=int_refsteps, chunk=chunk, cg_params=cg_params,
        timings=timings) for row in rows]
    dtypes = (torch.float64, torch.int64, torch.int64, torch.float64,
              torch.int64, torch.int64, torch.int64, torch.bool)
    return FamilyResult(*(torch.tensor([row[i] for row in out], dtype=dt)
                          for i, dt in enumerate(dtypes)))


def solve_fictdom_family(N: int, degree: int, radii, centers,
                         **kw) -> FamilyResult:
    """Circle family (the reference's geometry,
    cuthho_square.cpp:2030-2031): radii [B], centers [B, 2]."""
    centers = np.asarray(centers.cpu() if isinstance(centers, torch.Tensor)
                         else centers, dtype=np.float64)
    return solve_fictdom_family_params(
        N, degree, (radii, centers[:, 0], centers[:, 1]), circle_family,
        **kw)
