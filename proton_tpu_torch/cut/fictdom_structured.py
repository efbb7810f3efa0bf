"""Fictitious-domain cutHHO Poisson on the generated N x N mesh, solved
as a cells-last condensed face-grid system (JAX counterpart:
proton_tpu/cut/fictdom_structured.py; reference run_cuthho_fictdom,
cuthho_square.cpp:806-1080).

The pipeline:

1. band classification of the circle level set (cut/classify.py);
2. the local operators. ``fitted="lean"`` (the default): one unit-cell
   operator from kernel K1 (methods/fused_assembly.py) stands for every
   uncut, undisplaced cell, and K1 assembles only the O(N) cells whose
   nodes the bad-cut displacement moved. ``fitted="uniform"`` (the JAX
   default) builds the same lean system: JAX's form broadcasts the unit
   cell into O(N^2) planes, which changes no number. ``fitted="full"``:
   K1 assembles every cell. Either way the Nitsche cut-cell operators
   (cut/methods.py) overwrite the cut class;
3. static condensation onto the faces (methods/cells_last.condense_cl);
   in the lean form only the irregular columns are condensed and stored;
4. Dirichlet fold, then PCG on the H/V face grids, preconditioned by the
   reconstruction-transfer multigrid V-cycle (solvers/multigrid.py, the
   default; Chebyshev, damped block-Jacobi or damped Jacobi smoothing),
   per-face block-Jacobi, or Jacobi;
5. cell recovery and the chunked H1 error.

``mg_galerkin=True`` replaces the rediscretized coarse operators by the
exact Galerkin ones (band_galerkin_levels), and ``mg_gamma`` > 1 then
re-visits the coarse problems W-style.

The JAX package's precision modes:

- ``mixed=True``: a float32 system (the classified mesh rounded to
  float32, K1 in float32 on the displaced cells, or on every cell with
  fitted="full") with the O(N) cut class assembled and condensed in
  float64 from the upcast float32 batch and rounded to float32 columns
  (cut64_condensed). Sliver-cut Nitsche blocks have a local condition
  number near 1/eps_f32 and round indefinite in float32 at k >= 2;
- ``mg_f32=True``: the V-cycle built and applied in float32 around a
  float64 (or float32) system;
- ``cg_f64``: CG's recurrences in float64 around a float32 operator and
  preconditioner;
- ``cg_segment=m``: CG as warm-started segments of m iterations, each
  restarting from the true residual.

The multigrid options the JAX package keeps off by default (measured as
no gain there): ``mg_transfer="smoothed" | "cut"``, ``mg_deflate`` and
``cheb_ops``.

Not ported: W-cycles on the rediscretized hierarchy and every disk cache
(ROADMAP.md, "Not ported").
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..config import DEFAULT_DTYPE, resolve_device
from ..core import bases, quadrature
from ..core.geometry import cell_geometry, cell_points
from ..core.mesh import make_poly_mesh, unit_cell_mesh
from ..core.ops import HHODegreeInfo, cell_rhs, robust_spd_solve
from ..methods import (assembly, cells_last, condensation, fused_assembly,
                       structured)
from ..solvers import cg, multigrid
from ..utils.timing import sink, span
from . import methods as cut_methods
from .classify import (LOC_CUT, LOC_NEG, CutData, cut_preprocess,
                       cut_preprocess_band)
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
    """Classified + assembled data of one mesh level. ``cond`` is a
    CondensedCL (fitted="full") or a UniformCondCL (fitted="lean", with
    ``S_u`` the unit-cell Schur block and ``irr_ids`` the sorted ids of
    the cut or displaced cells)."""

    mesh: object
    cutdata: CutData
    cut_ids: np.ndarray
    cond: object
    batch: cut_methods.CutCellBatch
    cell_loc: torch.Tensor
    S_u: Optional[torch.Tensor] = None
    irr_ids: Optional[np.ndarray] = None
    drec: Optional[torch.Tensor] = None   # [rbs*nfd, Ci] reconstruction-map
    #                                       deviations at the irregular
    #                                       columns (mg_transfer="cut";
    #                                       coarse levels only)


class StructuredFictdomResult(NamedTuple):
    local: torch.Tensor           # [C, d] per-cell (uT, uF) dofs
    iterations: int
    exit_reason: int
    rel_residual: float
    h1_error: Optional[float]
    timings: dict
    history: Optional[torch.Tensor] = None  # CG's, with record_history


def _cast(tree, dtype):
    """``tree`` (a tensor, or a NamedTuple or dataclass of them, nested)
    with every floating tensor cast to ``dtype``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _cast(getattr(tree, f.name), dtype)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_cast(a, dtype) for a in tree))
    return tree


def _check_mixed(mixed: bool, dtype) -> None:
    if mixed and dtype != torch.float64:
        raise ValueError("mixed precision splices a float64 cut class "
                         "into a float32 system: it needs "
                         f"dtype=torch.float64, not {dtype}")


def classify_level(N: int, problem: FictdomProblem, int_refsteps: int, *,
                   device, dtype=DEFAULT_DTYPE, method: str = "band",
                   mixed: bool = False, classify_f32: bool = False):
    """Mesh + classification of one level; returns (mesh', CutData, host
    cut-cell ids). ``method``: 'band' (cut_preprocess_band, the O(band)
    pipeline) or 'full' (cut_preprocess on every cell); the two give the
    same result.

    ``classify_f32``: classify as ``dtype=torch.float32`` does, whatever
    ``dtype``. The JAX package does so by default on the TPU, where
    float64 is emulated; here the default is False. ``mixed``: return the
    float32 copy of the mesh and the classification, the float32
    system's pipeline (needs dtype=torch.float64, as JAX's needs x64).
    Either flag returns float32 arrays."""
    if method not in ("band", "full"):
        raise ValueError(f"method={method!r}: expected 'band' or 'full'")
    _check_mixed(mixed, dtype)
    mesh = make_poly_mesh(Nx=N, Ny=N, device=device,
                          dtype=torch.float32 if classify_f32 else dtype)
    pre = cut_preprocess_band if method == "band" else cut_preprocess
    mesh, cutdata = pre(mesh, problem.ls, levels=int_refsteps)
    if mixed:
        mesh, cutdata = _cast(mesh, torch.float32), \
            _cast(cutdata, torch.float32)
    cut_ids = np.nonzero(cutdata.cell_loc.cpu().numpy() == LOC_CUT)[0]
    return mesh, cutdata, cut_ids


def classify_cells(N: int, problem: FictdomProblem, int_refsteps: int, *,
                   device, dtype=DEFAULT_DTYPE, mixed: bool = False,
                   classify_f32: bool = False):
    """Classification phase (JAX _classify_host without the disk caches
    or the host/device split): (mesh, cutdata, cut_ids, cell_loc, batch,
    distorted ids), the ``classified`` tuple of lean_level. ``mixed``,
    ``classify_f32``: classify_level's; the cut batch is gathered from
    the float32 arrays then."""
    mesh, cutdata, cut_ids = classify_level(
        N, problem, int_refsteps, device=device, dtype=dtype, mixed=mixed,
        classify_f32=classify_f32)
    batch = cut_methods.make_cut_batch(mesh, cell_geometry(mesh), cutdata,
                                       cut_ids)
    dist_ids = np.nonzero(cutdata.distorted.cpu().numpy())[0]
    return mesh, cutdata, cut_ids, cutdata.cell_loc, batch, dist_ids


def _cut_operators(batch, hdi: HHODegreeInfo, problem: FictdomProblem,
                   eta: float, side: int):
    """lc [Cc, d, d] of the cut class: the Nitsche cut operators plus the
    cut stabilization."""
    _, data_cut = cut_methods.cut_hho_laplacian(batch, problem.ls, hdi, side,
                                                eta=eta)
    return data_cut + cut_methods.cut_stabilization(batch, hdi, side)


def _cut_operators_cl(batch, hdi: HHODegreeInfo, problem: FictdomProblem,
                      eta: float, side: int):
    """lc [d*d, Cc] of the cut class (_cut_operators, cells-last)."""
    lc_cut = _cut_operators(batch, hdi, problem, eta, side)
    d = lc_cut.shape[1]
    return lc_cut.permute(1, 2, 0).reshape(d * d, -1)


def _loads_cl(mesh, geom, cell_loc, hdi: HHODegreeInfo,
              problem: FictdomProblem, with_rhs: bool, side: int):
    """fT [cbs, C]: the fitted load vectors on the cells of ``side``
    (zeros without a right-hand side; the cut columns are set by the
    caller)."""
    if not with_rhs:
        return mesh.points.new_zeros(
            (bases.cell_basis_size(hdi.cell_degree), mesh.num_cells))
    f_std = cell_rhs(mesh, geom, hdi.cell_degree, problem.rhs_fun)
    return torch.where((cell_loc == side)[:, None], f_std,
                       torch.zeros_like(f_std)).T.contiguous()


def _cut_loads_cl(batch, hdi: HHODegreeInfo, problem: FictdomProblem,
                  eta: float, with_rhs: bool, side: int):
    """[cbs, Cc] loads of the cut class."""
    if not with_rhs:
        return batch.pts.new_zeros(
            (bases.cell_basis_size(hdi.cell_degree), len(batch.ids)))
    return cut_methods.cut_rhs(batch, hdi.cell_degree, problem.rhs_fun,
                               problem.ls, problem.sol_fun, side, eta=eta).T


def assemble_level_cl(mesh, geom, cell_loc, batch, hdi: HHODegreeInfo,
                      problem: FictdomProblem, eta: float,
                      side: int = LOC_NEG, with_rhs: bool = True,
                      cut_class: bool = True):
    """(lc_cl [d*d, C], f_cl [cbs, C]): fitted operators of every cell
    from K1 (the uncut fallback, cuthho_square.cpp:316-317), the Nitsche
    cut operators overwriting the cut class. The JAX function
    (_assemble_level_cl) condenses before returning; here the caller
    condenses, to time it apart. ``cut_class=False`` leaves the cut
    columns fitted: the mixed-precision system overwrites them after the
    condensation with the float64 cut class (cut64_condensed), where the
    JAX package first assembles them in float32, whose Cholesky can fail
    on a sliver block at k >= 2."""
    lc_cl = fused_assembly.fitted_local_operator(mesh, geom, hdi,
                                                 cells_last=True)
    f_cl = _loads_cl(mesh, geom, cell_loc, hdi, problem, with_rhs, side)
    if cut_class:
        cells_last.set_columns(lc_cl, batch.ids, _cut_operators_cl(
            batch, hdi, problem, eta, side))
        f_cl[:, batch.ids] = _cut_loads_cl(batch, hdi, problem, eta,
                                           with_rhs, side)
    return lc_cl, f_cl


def cut64_condensed(batch, hdi: HHODegreeInfo, problem: FictdomProblem,
                    eta: float, with_rhs: bool, side: int = LOC_NEG,
                    keep_f64: bool = False) -> cells_last.CondensedCL:
    """The cut class of the mixed-precision system (JAX _cut64_impl and
    cut64_condensed_cached, without its disk cache): the gathered float32
    cut batch upcast to float64, the Nitsche operators and loads
    assembled and condensed there (robust_spd_solve), the
    back-substitution operators X, y taken in float64 (from_row_major),
    and every column rounded to float32 unless ``keep_f64``. The float32
    geometry moves the domain by O(eps_f32 h); what needs float64 is the
    arithmetic on the sliver blocks."""
    batch64 = _cast(batch, torch.float64)
    lc_cut = _cut_operators(batch64, hdi, problem, eta, side)
    f_cut = _cut_loads_cl(batch64, hdi, problem, eta, with_rhs, side).T
    ccl = cells_last.from_row_major(condensation.condense(
        lc_cut, f_cut, bases.cell_basis_size(hdi.cell_degree), robust=True))
    return ccl if keep_f64 else _cast(ccl, torch.float32)


def _gather_cells(mesh, geom, ids):
    """Sub-batch of the cells ``ids``: the mesh with gathered cell arrays
    (points kept whole) and the gathered geometry."""
    sub = dataclasses.replace(mesh, cell_ptids=mesh.cell_ptids[ids],
                              cell_npts=mesh.cell_npts[ids],
                              cell_faces=mesh.cell_faces[ids])
    return sub, type(geom)(*(a[ids] for a in geom))


def _unit_cell_core(hdi: HHODegreeInfo, h: float, device):
    """(S_u [nfd, nfd], X_u = ATT^-1 ATF [cbs, nfd], ATT_u, ATF_u) of the
    square cell of side ``h``, float64: K1 on a one-cell mesh, then the
    condensation."""
    cbs = bases.cell_basis_size(hdi.cell_degree)
    mesh1 = unit_cell_mesh(h, device=device)
    lc = fused_assembly.fitted_local_operator(mesh1, cell_geometry(mesh1),
                                              hdi)[0]
    ATT, ATF = lc[:cbs, :cbs], lc[:cbs, cbs:]
    X = torch.cholesky_solve(ATF, torch.linalg.cholesky(ATT))
    return lc[cbs:, cbs:] - lc[cbs:, :cbs] @ X, X, ATT, ATF


@functools.lru_cache(maxsize=64)
def _unit_cell_host(hdi: HHODegreeInfo, h: float, device: torch.device):
    """The condensed pieces of the uniform cell, computed once per
    (hdi, h, device) in float64 and kept on the device. The generated
    mesh's cells are congruent squares and the scaled-monomial bases are
    translation-invariant, so every uncut, undisplaced cell shares them.
    The same tensors feed the constant stencil and the dS = S - S_u
    splice, so the two agree exactly. Callers must not write to them."""
    return _unit_cell_core(hdi, h, device)


def _set_cells_lean(ucond, S_u_cl, irr_ids, ids, sub):
    """Overwrite the cells ``ids`` of a lean uniform system, in place,
    with a small condensed batch (CondensedCL columns). ``ids`` is a
    sorted subset of the sorted ``irr_ids`` (host arrays)."""
    dev = ucond.dS.device
    pos = torch.as_tensor(np.searchsorted(irr_ids, ids), device=dev)
    cells_last.set_columns(ucond.dS, pos, sub.S - S_u_cl)
    cells_last.set_columns(ucond.bF, torch.as_tensor(ids, device=dev),
                           sub.bF)
    cells_last.set_columns(ucond.X_i, pos, sub.X)
    cells_last.set_columns(ucond.y_i, pos, sub.y)
    return ucond


def _assemble_level_uniform_lean(mesh, geom, cell_loc, batch, dist_ids,
                                 irr_ids, cut_ids, unit,
                                 hdi: HHODegreeInfo, problem: FictdomProblem,
                                 eta: float, with_rhs: bool,
                                 side: int = LOC_NEG, cut_cond=None):
    """Lean-uniform fictdom assembly: the unit-cell operator stands for
    every regular cell, and exact per-cell assembly is spliced over (a)
    the ``dist_ids`` cells whose nodes the bad-cut displacement moved
    (K1 on the gathered batch) and (b) the cut class (Nitsche kernels,
    or ``cut_cond``, its condensed columns made by the caller).
    ``irr_ids`` = union(dist_ids, cut_ids), sorted; all three are host
    arrays. No O(N^2) operator plane is formed."""
    dtype = mesh.points.dtype
    cbs = bases.cell_basis_size(hdi.cell_degree)
    S_u, X_u = (a.to(dtype) for a in unit[:2])
    nfd = S_u.shape[0]
    Ci = len(irr_ids)
    S_u_cl = S_u.reshape(nfd * nfd, 1)

    fT = _loads_cl(mesh, geom, cell_loc, hdi, problem, with_rhs, side)
    # every irregular column (dist + cut) is overwritten below
    ucond = cells_last.UniformCondCL(
        fT.new_zeros((nfd * nfd, Ci)), -(X_u.T @ fT), fT,
        fT.new_zeros((cbs * nfd, Ci)), fT.new_zeros((cbs, Ci)))

    if len(dist_ids) > 0:
        dist_d = torch.as_tensor(dist_ids, device=fT.device)
        sub, gsub = _gather_cells(mesh, geom, dist_d)
        lc_d = fused_assembly.fitted_local_operator(sub, gsub, hdi,
                                                    cells_last=True)
        _set_cells_lean(ucond, S_u_cl, irr_ids, dist_ids,
                        cells_last.condense_cl(lc_d, fT[:, dist_d], cbs))

    if cut_cond is None:
        cut_cond = cells_last.condense_cl(
            _cut_operators_cl(batch, hdi, problem, eta, side),
            _cut_loads_cl(batch, hdi, problem, eta, with_rhs, side), cbs)
    return _set_cells_lean(ucond, S_u_cl, irr_ids, cut_ids,
                           _cast(cut_cond, dtype))


@functools.lru_cache(maxsize=64)
def _unit_recmap_host(hdi: HHODegreeInfo, h: float, device: torch.device):
    """multigrid._unit_recmap of the square cell of side ``h`` in float64,
    computed once per (hdi, h, device): the uniform cell's
    harmonic-extension reconstruction map [rbs, nfd], which the cut-aware
    transfer deviations are taken against. Callers must not write to
    it."""
    return multigrid._unit_recmap(hdi, h, device=device)


def _cut_recdev(batch, recmap_u, hdi: HHODegreeInfo, problem: FictdomProblem,
                eta: float, side: int = LOC_NEG) -> torch.Tensor:
    """[rbs*nfd, Cc] deviations of each cut cell's harmonic-extension
    reconstruction map from the uniform cell's ``recmap_u``: rec_i =
    oper_i @ [[T_i], [I]] with T_i = -ATT_i^-1 ATF_i of the Nitsche cut
    operator (cut_hho_laplacian + cut_stabilization), row r*nfd + n. The
    cut-aware transfers (multigrid.make_reconstruction_prolongation_cl
    ``corr``) read them. Computed in float64 from the upcast batch (sliver
    ATT blocks round indefinite in float32), returned in the batch's
    dtype."""
    batch64 = _cast(batch, torch.float64)
    oper, data = cut_methods.cut_hho_laplacian(batch64, problem.ls, hdi,
                                               side, eta=eta)
    lc = data + cut_methods.cut_stabilization(batch64, hdi, side)
    cbs = bases.cell_basis_size(hdi.cell_degree)
    T = -robust_spd_solve(lc[:, :cbs, :cbs], lc[:, :cbs, cbs:])
    rec = torch.einsum("crt,ctn->crn", oper[:, :, :cbs], T) + \
        oper[:, :, cbs:]
    drec = rec - recmap_u.to(rec.device, torch.float64)[None]
    Cc, rbs, nfd = drec.shape
    return drec.permute(1, 2, 0).reshape(rbs * nfd, Cc).to(batch.pts.dtype)


def _level_recdev(batch, cut_ids, irr_ids, hdi: HHODegreeInfo,
                  problem: FictdomProblem, eta: float, n: int,
                  side: int = LOC_NEG) -> torch.Tensor:
    """drec [rbs*nfd, Ci] column-aligned with ``irr_ids`` (host arrays, as
    ``cut_ids``): the cut columns carry their reconstruction-map deviation
    (_cut_recdev); the columns of cells that are only displaced stay zero
    (their operator deviates by O(node displacement), immaterial next to
    the Nitsche terms)."""
    dev = batch.pts.device
    d_cut = _cut_recdev(batch, _unit_recmap_host(hdi, 1.0 / n, dev), hdi,
                        problem, eta, side)
    drec = d_cut.new_zeros((d_cut.shape[0], len(irr_ids)))
    pos = np.searchsorted(np.asarray(irr_ids), np.asarray(cut_ids))
    drec[:, torch.as_tensor(pos, device=dev)] = d_cut
    return drec


def _check_fitted(fitted: str) -> None:
    if fitted not in ("lean", "uniform", "full"):
        raise ValueError(f"fitted={fitted!r}: expected 'lean', 'uniform' "
                         "or 'full'")


def _check_precond(precond: str) -> None:
    if precond not in ("mg", "block_jacobi", "jacobi"):
        raise ValueError(f"precond={precond!r}: expected 'mg', "
                         "'block_jacobi' or 'jacobi'")


def lean_level(classified, geom, N: int, hdi: HHODegreeInfo,
               problem: FictdomProblem, eta: float, *,
               with_rhs: bool = True, mixed: bool = False,
               cut_cond=None) -> LevelData:
    """The lean system of one level from its classification (the tuple of
    classify_cells) and cell geometry: the unit-cell operator for every
    regular cell, exact assembly on the O(N) displaced and cut cells, in
    the mesh's dtype. ``mixed`` (a float32 classification): the cut
    class comes from cut64_condensed, unless the caller passes its
    columns as ``cut_cond``."""
    mesh, cutdata, cut_ids, cell_loc, batch, dist_ids = classified
    unit = _unit_cell_host(hdi, 1.0 / N, mesh.points.device)
    irr_ids = np.union1d(dist_ids, cut_ids)
    if cut_cond is None and mixed:
        cut_cond = cut64_condensed(batch, hdi, problem, eta, with_rhs)
    cond = _assemble_level_uniform_lean(
        mesh, geom, cell_loc, batch, dist_ids, irr_ids, cut_ids, unit, hdi,
        problem, eta, with_rhs, cut_cond=cut_cond)
    return LevelData(mesh, cutdata, cut_ids, cond, batch, cell_loc,
                     unit[0].to(mesh.points.dtype), irr_ids)


def build_level(N: int, hdi: HHODegreeInfo, problem: FictdomProblem,
                eta: float, int_refsteps: int, *, device,
                dtype=DEFAULT_DTYPE, fitted: str = "full",
                with_rhs: bool = True, timings: Optional[dict] = None,
                mixed: bool = False,
                classify_f32: bool = False) -> LevelData:
    """Classify + assemble + condense one level. ``fitted``: 'full'
    assembles every cell with K1; 'lean' (and 'uniform', the same system)
    assembles only the O(N) displaced and cut cells around the unit-cell
    operator (exact on the generated mesh up to basis
    translation-invariance). ``with_rhs=False``
    (the multigrid coarse levels) skips the load vectors. ``mixed``: the
    float32 system with the float64 cut class spliced in
    (cut64_condensed); ``classify_f32``: classify_level's. Phase times go
    into ``timings``; the lean assembly condenses as it goes, so its time
    is all in ``assembly_s``."""
    _check_fitted(fitted)
    device = resolve_device(device)
    timings = {} if timings is None else timings
    lean = fitted in ("lean", "uniform")
    with sink(timings):
        with span("classify", device):
            classified = classify_cells(N, problem, int_refsteps,
                                        device=device, dtype=dtype,
                                        mixed=mixed,
                                        classify_f32=classify_f32)
        mesh, cutdata, cut_ids, cell_loc, batch, _ = classified

        with span("assembly", device):
            geom = cell_geometry(mesh)
            if lean:
                level = lean_level(classified, geom, N, hdi, problem, eta,
                                   with_rhs=with_rhs, mixed=mixed)
            else:
                lc_cl, f_cl = assemble_level_cl(
                    mesh, geom, cell_loc, batch, hdi, problem, eta,
                    with_rhs=with_rhs, cut_class=not mixed)
            del geom
        if lean:
            return level

        with span("condense", device):
            cond = cells_last.condense_cl(
                lc_cl, f_cl, bases.cell_basis_size(hdi.cell_degree))
            del lc_cl
            if mixed:
                cells_last.set_cells(cond, batch.ids, cut64_condensed(
                    batch, hdi, problem, eta, with_rhs))
    return LevelData(mesh, cutdata, cut_ids, cond, batch, cell_loc)


def expand_ring(ids: np.ndarray, n: int, ring: int = 1) -> np.ndarray:
    """Cell ids on the n x n grid grown by ``ring`` layers of neighbours
    (the patch smoother's support: the cut cells plus the cells whose
    faces see the Nitsche coupling)."""
    ids = np.asarray(ids, dtype=np.int64)
    if ring == 0 or len(ids) == 0:
        return ids
    jj, ii = ids // n, ids % n
    out = []
    for dj in range(-ring, ring + 1):
        for di in range(-ring, ring + 1):
            j2, i2 = jj + dj, ii + di
            ok = (j2 >= 0) & (j2 < n) & (i2 >= 0) & (i2 < n)
            out.append(j2[ok] * n + i2[ok])
    return np.unique(np.concatenate(out))


def build_coarse_levels(N: int, hdi: HHODegreeInfo, problem: FictdomProblem,
                        eta: float, int_refsteps: int, *, device,
                        dtype=DEFAULT_DTYPE, fitted: str = "lean",
                        mg_coarsest: int = 8, mixed: bool = False,
                        drec: bool = False,
                        timings: Optional[dict] = None
                        ) -> Dict[int, LevelData]:
    """{n: LevelData} of the rediscretized levels N/2, ..., mg_coarsest,
    in the fine level's form and without right-hand sides (JAX
    build_coarse_level, without its disk cache): the V-cycle needs only
    (dS or S, S_u, irr_ids, cut_ids) of each. ``mixed``: build_level's.
    ``drec``: each level also carries its reconstruction-map deviations
    (_level_recdev, for mg_transfer="cut"; lean levels only), their
    seconds summed into ``timings["drec_setup_s"]``."""
    if drec and fitted == "full":
        raise ValueError("the cut-aware transfers need lean coarse levels "
                         "(fitted='lean' or 'uniform')")
    timings = {} if timings is None else timings
    levels = {}
    for n in multigrid._mg_sizes(N, mg_coarsest)[1:]:
        lev = build_level(n, hdi, problem, eta, int_refsteps, device=device,
                          dtype=dtype, fitted=fitted, with_rhs=False,
                          mixed=mixed)
        if drec:
            with sink(timings), span("drec_setup", device):
                lev = lev._replace(drec=_level_recdev(
                    lev.batch, lev.cut_ids, lev.irr_ids, hdi, problem, eta,
                    n))
        levels[n] = lev
    return levels


def band_galerkin_levels(levels: Dict[int, LevelData], hdi: HHODegreeInfo,
                         dtype=DEFAULT_DTYPE
                         ) -> Dict[int, multigrid.GalerkinLevel]:
    """{n: GalerkinLevel} of every coarse level of ``levels`` ({n:
    LevelData}, lean): the exact Galerkin hierarchy, recursed on the host
    in float64 from the finest level's (S_u, dS, irr_ids) by the
    multigrid pair-operator engine, then placed on the finest level's
    device in ``dtype``. The coarsest level carries the host eigh
    pseudo-inverse of its dense operator, in float64. The JAX function's
    disk cache, keyed by its problem, eta and int_refsteps arguments, is
    not ported."""
    sizes = sorted(levels)
    N = sizes[-1]
    fine = levels[N]
    if not isinstance(fine.cond, cells_last.UniformCondCL):
        raise ValueError("the Galerkin hierarchy is built from the lean "
                         "system (fitted='lean' or 'uniform')")
    device = fine.cond.dS.device
    fbs = bases.face_basis_size(hdi.face_degree)
    const, corr = multigrid.finest_pair_op(N, fine.S_u, fine.cond.dS,
                                           fine.irr_ids)

    def put(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)

    out = {}
    for nf in reversed(sizes[1:]):
        nc = nf // 2
        if nc not in levels:
            break
        # the fine level's domain-boundary masking, folded in before the
        # triple product (what the masked apply and transfers realize)
        corr = multigrid.mask_pair_op(nf, const, corr)
        const, corr = multigrid.galerkin_coarsen_pair_op(hdi, nc, const,
                                                         corr)
        Bu, cells, cblocks = multigrid.pair_op_cell_face_blocks(nc, const,
                                                                corr, fbs)
        factor = (None, None)
        if nc == sizes[0]:
            # kept in float64 whatever ``dtype``: the coarsest Galerkin
            # operator's condition number is ~1e5, and a float32 factor
            # floors the outer CG (multigrid._coarse_solve casts)
            factor = tuple(put(a, torch.float64)
                           for a in multigrid.pinv_factor_host(
                               multigrid.pair_op_dense(nc, const, corr,
                                                       fbs)))
        out[nc] = multigrid.GalerkinLevel(
            put(multigrid.pair_op_kernel(const)), put(corr[0], torch.int64),
            put(corr[1], torch.int64), put(corr[2]), put(cells, torch.int64),
            put(cblocks), put(Bu), *factor)
    return out


def _level_S(level: LevelData) -> torch.Tensor:
    """dS of a lean level, S of a full one."""
    cond = level.cond
    return cond.dS if isinstance(cond, cells_last.UniformCondCL) else cond.S


def level_multigrid(levels: Dict[int, LevelData], hdi: HHODegreeInfo, *,
                    mg_coarsest: int = 8, n_smooth: int = 1,
                    patch_ring: int = 1, patch_colors: int = 1,
                    cheb_degree: int = 4, patch_sweeps: int = 1,
                    smoother: str = "chebyshev", galerkin=None,
                    gamma: int = 1, dtype=None, cheb_ops: str = "exact",
                    mg_transfer: str = "uniform") -> multigrid.Multigrid:
    """The V-cycle over ``levels`` ({n: LevelData}, the finest included):
    ``smoother`` (multigrid.build_multigrid: Chebyshev(cheb_degree) over
    block-Jacobi, or damped block-Jacobi or Jacobi), then the
    interface-patch smoother on the cut cells grown by ``patch_ring``.
    ``galerkin`` ({n: GalerkinLevel} of band_galerkin_levels), ``gamma``
    and ``cheb_ops`` go to build_multigrid. ``mg_transfer``: 'uniform',
    'smoothed' (operator-smoothed transfers) or 'cut' (the cut-aware
    correction from each coarse level's ``drec``, which every coarse
    level must carry). ``dtype``: the V-cycle's (every level's operator is
    cast to it), by default the finest level's."""
    _check_mg_transfer(mg_transfer)
    N = max(levels)
    rec_dev = None
    if mg_transfer == "cut":
        rec_dev = {n: lev.drec for n, lev in levels.items() if n != N}
        if any(d is None for d in rec_dev.values()):
            raise ValueError("mg_transfer='cut' needs the reconstruction-map "
                             "deviations of every coarse level "
                             "(build_coarse_levels(drec=True))")
    lean = {n: isinstance(lev.cond, cells_last.UniformCondCL)
            for n, lev in levels.items()}
    dtype = _level_S(levels[N]).dtype if dtype is None else dtype
    return multigrid.build_multigrid(
        N, bases.face_basis_size(hdi.face_degree),
        {n: _level_S(lev).to(dtype) for n, lev in levels.items()},
        hdi=hdi, coarsest=mg_coarsest, n_smooth=n_smooth,
        cut_ids_per_level={n: expand_ring(lev.cut_ids, n, patch_ring)
                           for n, lev in levels.items()},
        cheb_degree=cheb_degree, patch_colors=patch_colors,
        patch_sweeps=patch_sweeps, smoother=smoother,
        uniform_per_level={n: (lev.S_u, lev.irr_ids)
                           for n, lev in levels.items() if lean[n]},
        galerkin_per_level=galerkin, gamma=gamma, cheb_ops=cheb_ops,
        rec_dev_per_level=rec_dev, smooth_transfers=mg_transfer == "smoothed")


class FaceSystem(NamedTuple):
    """The face-grid system of one level, ready for CG."""

    sys: structured.StructuredFaceSystem
    gF_cl: torch.Tensor                  # [nfd, C] Dirichlet data, face slots
    rhs: cells_last.GridVecCL
    apply_S: Callable
    precond: Optional[Callable]          # block-Jacobi; None otherwise
    diag: Optional[cells_last.GridVecCL]  # the Jacobi diagonal


def face_system(level: LevelData, N: int, hdi: HHODegreeInfo,
                problem: FictdomProblem, precond: str, *,
                device) -> FaceSystem:
    """Dirichlet fold, condensed rhs and operator of the fine level, in
    its lean or its full form, and the block-Jacobi preconditioner or the
    Jacobi diagonal. With ``precond="mg"`` neither is built: the V-cycle
    comes from level_multigrid."""
    _check_precond(precond)
    device = resolve_device(device)
    fbs = bases.face_basis_size(hdi.face_degree)
    cbs = bases.cell_basis_size(hdi.cell_degree)
    sys_f = structured.make_structured_system(N, N, fbs, device=device)
    dofmap = assembly.build_dofmap_structured(N, hdi, device=device)
    fd = assembly.dirichlet_face_data(level.mesh, hdi, problem.sol_fun)
    gF_cl = assembly.local_dirichlet_data(dofmap, level.mesh, fd)[:, cbs:].T
    cond = level.cond
    if isinstance(cond, cells_last.UniformCondCL):
        S_u, irr = level.S_u, level.irr_ids
        rhs = cells_last.uniform_rhs_cl(sys_f, cond, S_u, irr, gF_cl)
        apply_S = cells_last.make_uniform_operator_cl(sys_f, S_u, irr,
                                                      cond.dS)
        if precond == "jacobi":
            return FaceSystem(sys_f, gF_cl, rhs, apply_S, None,
                              cells_last.uniform_diagonal_cl(
                                  sys_f, S_u, irr, cond.dS))
        bj = None
        if precond == "block_jacobi":
            hf, vf = cells_last.uniform_face_block_deltas(sys_f, cond.dS,
                                                          irr)
            bj = cells_last.make_uniform_block_jacobi_cl(
                sys_f, *cells_last.uniform_block_jacobi_blocks(sys_f, S_u),
                *cells_last.uniform_bj_from_deltas(sys_f, S_u, hf, vf,
                                                   cond.dS.dtype))
        return FaceSystem(sys_f, gF_cl, rhs, apply_S, bj, None)
    rhs = cells_last.structured_rhs_cl(sys_f, cond, gF_cl)
    apply_S = cells_last.make_structured_operator_cl(sys_f, cond.S)
    if precond == "block_jacobi":
        return FaceSystem(
            sys_f, gF_cl, rhs, apply_S,
            cells_last.block_jacobi_preconditioner_cl(sys_f, cond.S), None)
    diag = cells_last.structured_diagonal_cl(sys_f, cond.S) \
        if precond == "jacobi" else None
    return FaceSystem(sys_f, gF_cl, rhs, apply_S, None, diag)


def recover_local(fsys: FaceSystem, level: LevelData, hdi: HHODegreeInfo,
                  x: cells_last.GridVecCL):
    """Face solution -> per-cell local dofs [C, d], through the level's
    lean or full back-substitution."""
    if isinstance(level.cond, cells_last.UniformCondCL):
        N = fsys.sys.Nx
        unit = _unit_cell_host(hdi, 1.0 / N, x.H.device)
        return cells_last.uniform_recover_cl(
            fsys.sys, level.cond, unit[1], unit[2], level.irr_ids, x,
            fsys.gF_cl)
    return cells_last.solve_recover_cl(fsys.sys, level.cond, x, fsys.gF_cl)


def _in_dtype(fn: Callable, dtype) -> Callable:
    """fn run in ``dtype``: its argument (a tensor or a NamedTuple of
    them) is cast to ``dtype`` and its result back to the argument's
    dtype. Where the two agree, the casts are no-ops."""
    def call(x):
        back = cg._leaves(x)[0].dtype
        return cg._map(lambda a: a.to(back),
                       fn(cg._map(lambda a: a.to(dtype), x)))
    return call


def mg_preconditioner(fine: LevelData, N: int, hdi: HHODegreeInfo,
                      problem: FictdomProblem, eta: float, int_refsteps: int,
                      *, device, dtype=DEFAULT_DTYPE, fitted: str = "lean",
                      mg_coarsest: int = 8, mg_galerkin: bool = False,
                      mg_gamma: int = 1, timings: Optional[dict] = None,
                      mixed: bool = False, mg_f32: bool = False,
                      mg_transfer: str = "uniform", mg_deflate: int = 0,
                      patch_ring: int = 1, **vcycle) -> Callable:
    """The V-cycle of solve_fictdom_structured over ``fine`` and its
    rediscretized coarse levels N/2, ..., ``mg_coarsest`` (built in
    ``dtype``, with the float64 cut splice if ``mixed``; with
    ``mg_galerkin`` the exact Galerkin coarse operators instead), as the
    preconditioner callable of CG. The V-cycle runs in the fine level's
    dtype, or in float32 with ``mg_f32``; the callable casts a residual
    of another dtype to it and the result back. ``mg_transfer``:
    level_multigrid's ('cut' builds the coarse levels with their drec).
    ``mg_deflate`` = K > 0 adds the interface-band deflation of 2K+1
    modes on the fine level's patch cells (the cut cells grown by
    ``patch_ring``), built on the fine level's operator in the V-cycle's
    dtype: z = V(r) + D(r), inside the precision cast (the JAX package's
    _solve_jit); without cut cells there is no band and nothing is added.
    ``vcycle``: level_multigrid's smoother keywords. Phase times go into
    ``timings``: assemble_coarse_s (drec_setup_s included), drec_setup_s,
    galerkin_setup_s, mg_setup_s (on CUDA with the V-cycle's graph
    capture, mg_graph_capture_s), deflate_setup_s."""
    _check_mg_transfer(mg_transfer)
    if mg_deflate < 0:
        raise ValueError(f"mg_deflate={mg_deflate!r}: expected 0 or more")
    timings = {} if timings is None else timings
    with sink(timings):
        with span("assemble_coarse", device):
            levels = {N: fine}
            levels.update(build_coarse_levels(
                N, hdi, problem, eta, int_refsteps, device=device,
                dtype=dtype, fitted=fitted, mg_coarsest=mg_coarsest,
                mixed=mixed, drec=mg_transfer == "cut", timings=timings))
        mg_dtype = torch.float32 if mg_f32 else _level_S(fine).dtype
        galerkin = None
        if mg_galerkin and len(levels) > 1:
            with span("galerkin_setup", device):
                galerkin = band_galerkin_levels(levels, hdi, dtype=mg_dtype)
        with span("mg_setup", device):
            mg = level_multigrid(levels, hdi, mg_coarsest=mg_coarsest,
                                 galerkin=galerkin, gamma=mg_gamma,
                                 dtype=mg_dtype, mg_transfer=mg_transfer,
                                 patch_ring=patch_ring, **vcycle)
        band = expand_ring(fine.cut_ids, N, patch_ring)
        if mg_deflate == 0 or len(band) == 0:
            return _in_dtype(mg.precondition, mg_dtype)
        with span("deflate_setup", device):
            fine_level = mg.levels[0]
            _, deflate = multigrid.make_band_deflation(
                fine_level.sys, fine_level.apply_S, band, mg_deflate,
                mg_dtype)

    def precondition(r):
        z, d = mg.precondition(r), deflate(r)
        return cells_last.GridVecCL(z.H + d.H, z.V + d.V)

    return _in_dtype(precondition, mg_dtype)


def segmented_cg(apply_A: Callable, b, diag, params: cg.CGParams,
                 segment: int, precond: Optional[Callable] = None
                 ) -> cg.CGResult:
    """PCG as warm-started segments of ``segment`` iterations (JAX
    solve_segments): each segment restarts from the true residual of the
    last one's x and tests against the first residual's norm, until one
    converges or diverges or the segments' counts sum to at least
    params.max_iter. Returns the last segment's result with the summed
    count (and no history)."""
    seg = dataclasses.replace(params, max_iter=segment)
    nr0 = torch.sqrt(cg._vdot(b, b))
    x, total = None, 0
    while True:
        res = cg.conjugated_gradient(apply_A, b, diag, seg, precond=precond,
                                     x0=x, nr0=nr0)
        x, total = res.x, total + res.iterations
        if res.exit_reason in (cg.CONVERGED, cg.DIVERGED) or \
                total >= params.max_iter:
            return res._replace(iterations=total, history=None)


def solve_level(level: LevelData, N: int, hdi: HHODegreeInfo,
                problem: FictdomProblem, precond: str,
                cg_params: cg.CGParams, *, apply_mg: Optional[Callable] = None,
                device, timings: Optional[dict] = None, cg_f64: bool = False,
                cg_segment: int = 0):
    """(local [C, d], CGResult): face_system, PCG preconditioned by
    ``apply_mg`` (mg_preconditioner's, with precond='mg') or by the face
    system's block-Jacobi or Jacobi, and recover_local. ``cg_f64``: on a
    float32 system, CG's vectors and recurrences are float64 around the
    float32 operator and preconditioner. ``cg_segment`` > 0: segmented_cg
    with segments of that many iterations. Phase times go into
    ``timings``: setup_s, cg_s, recover_s."""
    timings = {} if timings is None else timings
    with sink(timings):
        with span("setup", device):
            fsys = face_system(level, N, hdi, problem, precond,
                               device=device)

        with span("cg", device):
            sys_dtype = fsys.rhs.H.dtype
            cg_dtype = torch.float64 if cg_f64 else sys_dtype
            pre = apply_mg if precond == "mg" else fsys.precond
            args = (_in_dtype(fsys.apply_S, sys_dtype),
                    _cast(fsys.rhs, cg_dtype), _cast(fsys.diag, cg_dtype),
                    cg_params)
            pre = None if pre is None else _in_dtype(pre, sys_dtype)
            # the benchmark's traced slice wraps cg.conjugated_gradient
            # by this name and counts its precond keyword's calls
            res = segmented_cg(*args, cg_segment, precond=pre) \
                if cg_segment else cg.conjugated_gradient(*args, precond=pre)

        with span("recover", device):
            local = recover_local(fsys, level, hdi, _cast(res.x, sys_dtype))
    return local, res


MG_TRANSFERS = ("uniform", "smoothed", "cut")


def _check_mg_transfer(mg_transfer: str) -> None:
    if mg_transfer not in MG_TRANSFERS:
        raise ValueError(f"mg_transfer={mg_transfer!r}: expected one of "
                         f"{MG_TRANSFERS}")


def _check_mg_options(mg_transfer: str, mg_deflate: int, cheb_ops: str, *,
                      precond: str, smoother: str, fitted: str,
                      coarse_fitted: Optional[str] = None) -> None:
    """The multigrid options mg_transfer, mg_deflate and cheb_ops: their
    values, and the combinations where they cannot act, which raise
    ValueError (the JAX package ignores them there and runs without
    them): any of them without precond='mg'; mg_transfer='cut' on full
    coarse levels (``coarse_fitted``, by default ``fitted``: they carry no
    drec); cheb_ops other than 'exact' on a full fine level (no unit-cell
    stencil) or with a smoother other than Chebyshev."""
    _check_mg_transfer(mg_transfer)
    if cheb_ops not in multigrid.CHEB_OPS:
        raise ValueError(f"cheb_ops={cheb_ops!r}: expected one of "
                         f"{multigrid.CHEB_OPS}")
    if mg_deflate < 0:
        raise ValueError(f"mg_deflate={mg_deflate!r}: expected 0 or more")
    chosen = [f"{name}={value!r}" for name, value, off in (
        ("mg_transfer", mg_transfer, "uniform"),
        ("mg_deflate", mg_deflate, 0), ("cheb_ops", cheb_ops, "exact"))
        if value != off]
    if chosen and precond != "mg":
        raise ValueError(f"{', '.join(chosen)} needs precond='mg', not "
                         f"{precond!r}")
    if mg_transfer == "cut" and (coarse_fitted or fitted) == "full":
        raise ValueError("mg_transfer='cut' needs lean coarse levels "
                         "(fitted 'lean' or 'uniform'): full levels carry no "
                         "reconstruction-map deviations")
    if cheb_ops != "exact" and (fitted == "full" or smoother != "chebyshev"):
        raise ValueError(f"cheb_ops={cheb_ops!r} needs the unit-cell stencil "
                         "and the Chebyshev smoother (got fitted="
                         f"{fitted!r}, mg_smoother={smoother!r})")


def _check_galerkin(mg_galerkin: bool, mg_gamma: int, fitted: str,
                    precond: str) -> None:
    """The Galerkin hierarchy needs the lean system and the V-cycle (the
    JAX package ignores the flag otherwise; the port refuses). W-style
    cycles run on it alone."""
    if mg_gamma < 1:
        raise ValueError(f"mg_gamma={mg_gamma!r}: expected 1 or more")
    if mg_galerkin and (fitted == "full" or precond != "mg"):
        raise ValueError("mg_galerkin=True needs precond='mg' and fitted "
                         "'lean' or 'uniform' (got precond="
                         f"{precond!r}, fitted={fitted!r})")
    if mg_gamma > 1 and not mg_galerkin:
        raise NotImplementedError(
            f"mg_gamma={mg_gamma!r} without mg_galerkin: a W-style cycle on "
            "the rediscretized hierarchy is not ported (ROADMAP.md, "
            "'Not ported')")


def solve_fictdom_structured(
        N: int, degree: int, problem: Optional[FictdomProblem] = None,
        int_refsteps: int = 4, precond: str = "mg",
        cg_params: Optional[cg.CGParams] = None, compute_h1: bool = True,
        fitted: str = "lean", side: int = LOC_NEG, *, mg_coarsest: int = 8,
        n_smooth: int = 1, patch_ring: int = 1, patch_colors: int = 1,
        cheb_degree: int = 4, patch_sweeps: int = 1,
        mg_smoother: str = "chebyshev", mg_galerkin: bool = False,
        mg_gamma: int = 1, mg_transfer: str = "uniform",
        mg_deflate: int = 0, cheb_ops: str = "exact",
        mixed: Optional[bool] = None, mg_f32: bool = False,
        cg_f64: Optional[bool] = None, cg_segment: int = 0, device=None,
        dtype=DEFAULT_DTYPE) -> StructuredFictdomResult:
    """End-to-end fictdom solve on the generated N x N mesh at HHO degree
    ``degree`` (cell degree k+1, face degree k).

    ``precond``: 'mg' (the reconstruction-transfer V-cycle over meshes N,
    N/2, ..., ``mg_coarsest``: ``n_smooth`` sweeps of
    Chebyshev(``cheb_degree``) over block-Jacobi plus ``patch_sweeps`` of
    the interface-patch smoother on the cut cells grown by ``patch_ring``
    layers, in ``patch_colors`` colors; ``mg_smoother`` 'block_jacobi'
    or 'jacobi' replaces Chebyshev by that base damped by 0.67),
    'block_jacobi' (per-face blocks) or 'jacobi' (the reference's PCG
    preconditioner, solver_cg.hpp:63-144; refused with fitted='lean', as
    in the JAX package). ``fitted``: 'lean', 'uniform' or 'full'
    (build_level). ``mg_galerkin``: the exact Galerkin coarse operators
    (band_galerkin_levels; their host setup is timed as
    ``galerkin_setup_s``), with ``mg_gamma`` coarse visits per gap of the
    top two.

    Multigrid options the JAX package keeps off by default (it measured
    them as no gain): ``mg_transfer`` 'smoothed' (operator-smoothed
    transfers) or 'cut' (each irregular coarse cell's own Nitsche
    harmonic-extension reconstruction in the transfers; coarse levels
    carry its deviations, timed as ``drec_setup_s``), ``mg_deflate`` = K
    (the V-cycle plus a deflation of 2K+1 Fourier modes along the
    interface band, ``deflate_setup_s``) and ``cheb_ops`` 'mixed' or
    'uniform' (the Chebyshev polynomial on the constant-stencil operator,
    and for 'uniform' its uncorrected block-Jacobi base).

    Precision (the module docstring): ``mixed`` (the float32 system with
    the float64 cut splice, on every level), ``mg_f32`` (the float32
    V-cycle), ``cg_f64`` (float64 CG around a float32 system; None: on
    unless ``mg_f32`` or ``cg_segment``, as JAX's rule under x64, which
    ``dtype=torch.float64`` stands for here) and ``cg_segment``
    (segmented_cg). ``dtype=torch.float32`` runs everything in float32,
    the JAX package without x64.

    Departures from the JAX solve: ``mixed=None`` means False at every
    degree (the JAX package turns it on at k >= 2, because the TPU has no
    native float64; the port's default is float64 throughout);
    ``fitted="uniform"`` builds the lean system (the same numbers without
    the O(N^2) broadcast planes; its
    Jacobi diagonal is the whole operator's, as JAX's from the broadcast
    S); the Jacobi smoother on a lean level takes the whole operator's
    diagonal, where the JAX package's fails; ``mg_galerkin=True`` with
    fitted='full' or a precond other than 'mg' raises ValueError, where
    the JAX package ignores the flag, and so do the multigrid options
    where they cannot act (_check_mg_options). W-cycles on the
    rediscretized hierarchy (mg_gamma > 1 without mg_galerkin) are not
    ported and raise NotImplementedError.

    Runs on CUDA unless ``device="cpu"``; raises without a device when
    CUDA is absent. ``timings`` is the sink of the solve's spans
    (utils/timing.py): ``solve`` around it all; the phases, each ended by
    a device synchronize (classify, assembly, assemble_coarse, mg_setup,
    setup, cg, recover, and the options' own set-up phases) and ``h1``;
    inside ``cg`` the spans of solvers/cg.py, and inside ``cg_precond``
    the V-cycle's (multigrid._vcycle). On CUDA the V-cycle is a CUDA
    graph: ``cg_precond`` holds ``mg_graph_replay``, and the V-cycle's
    own spans run only in its capture, ``mg_graph_capture`` inside
    ``mg_setup``."""
    device = resolve_device(device)
    _check_precond(precond)
    _check_fitted(fitted)
    mixed = bool(mixed)
    _check_mixed(mixed, dtype)
    if cg_segment < 0:
        raise ValueError(f"cg_segment={cg_segment!r}: expected 0 or more")
    if cg_f64 is None:
        cg_f64 = dtype == torch.float64 and not mg_f32 and not cg_segment
    _check_galerkin(mg_galerkin, mg_gamma, fitted, precond)
    if mg_smoother not in multigrid.SMOOTHERS:
        raise ValueError(f"mg_smoother={mg_smoother!r}: expected one of "
                         f"{multigrid.SMOOTHERS}")
    _check_mg_options(mg_transfer, mg_deflate, cheb_ops, precond=precond,
                      smoother=mg_smoother, fitted=fitted)
    if fitted == "lean" and precond == "jacobi":
        raise ValueError("the lean system supports precond 'mg' and "
                         "'block_jacobi' only, as in the JAX package "
                         "(fitted='uniform' takes 'jacobi')")
    if problem is None:
        problem = default_problem()
    if cg_params is None:
        cg_params = cg.CGParams(convergence_threshold=1e-6,
                                divergence_threshold=1e8, max_iter=50000,
                                apply_preconditioner=True)
    hdi = HHODegreeInfo(degree + 1, degree)
    eta = nitsche_eta(degree)
    timings = {}

    with sink(timings), span("solve", device):
        fine = build_level(N, hdi, problem, eta, int_refsteps, device=device,
                           dtype=dtype, fitted=fitted, timings=timings,
                           mixed=mixed)
        apply_mg = None
        if precond == "mg":
            apply_mg = mg_preconditioner(
                fine, N, hdi, problem, eta, int_refsteps, device=device,
                dtype=dtype, fitted=fitted, mg_coarsest=mg_coarsest,
                mg_galerkin=mg_galerkin, mg_gamma=mg_gamma, timings=timings,
                mixed=mixed, mg_f32=mg_f32, mg_transfer=mg_transfer,
                mg_deflate=mg_deflate, n_smooth=n_smooth,
                patch_ring=patch_ring, patch_colors=patch_colors,
                cheb_degree=cheb_degree, patch_sweeps=patch_sweeps,
                smoother=mg_smoother, cheb_ops=cheb_ops)
        local, res = solve_level(fine, N, hdi, problem, precond, cg_params,
                                 apply_mg=apply_mg, device=device,
                                 timings=timings, cg_f64=cg_f64,
                                 cg_segment=cg_segment)

        h1 = None
        if compute_h1:
            with span("h1"):
                h1 = fictdom_h1_error_chunked(
                    fine.mesh, cell_geometry(fine.mesh), fine.batch,
                    fine.cell_loc, hdi, local, problem.sol_grad, side)

    return StructuredFictdomResult(local, res.iterations, res.exit_reason,
                                   res.rel_residual, h1, timings,
                                   res.history)


def fictdom_h1_error_chunked(mesh, geom, batch, cell_loc,
                             hdi: HHODegreeInfo, local, sol_grad,
                             side: int = LOC_NEG, chunk: int = 65536,
                             cut_valid=None) -> float:
    """H1(grad) error over the physical side (fictdom_h1_error,
    cuthho_square.cpp:1031-1050): the fitted cells of ``side`` in blocks
    of ``chunk`` cells, so no [C, Q, rbs, 2] tensor of the whole mesh
    exists, plus the cut cells on their side quadrature.

    ``cut_valid`` ([Cc] bool): the rows of ``batch`` that count. The
    contribution of the others is computed and then masked out, as the
    JAX package does for the padding rows of a fixed-capacity batch."""
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
    cut_contrib = torch.sum(crule.w * torch.sum((cge - cgh) ** 2, dim=-1),
                            dim=-1)
    if cut_valid is not None:
        cut_contrib = torch.where(cut_valid, cut_contrib,
                                  torch.zeros_like(cut_contrib))
    return float(torch.sqrt(err + torch.sum(cut_contrib)))
