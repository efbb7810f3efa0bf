"""Build the port's state from the JAX package's pytrees, given as numpy
arrays: any object with the field names of proton_tpu's ``Mesh`` (the
generated and the loaded ones), ``CellGeom``, ``DofMap``,
``FaceIncidence``, ``CondensedSystem``, ``PoissonSolution``,
``ObstacleResult``, ``CutData``, ``CutCellBatch``, ``CondensedCL``,
``UniformCondCL``, ``GridVecCL``, ``InterfaceDofMap``, ``FictdomResult``,
``InterfaceResult`` or ``FamilyResult`` (``np.asarray`` is applied to
each field), and the
per-level data of its multigrid. The tests use
these so that each stage of the two packages runs from identical inputs.
This module imports neither JAX nor proton_tpu."""

from __future__ import annotations

import numpy as np
import torch

from .core.geometry import CellGeom
from .core.mesh import Mesh
from .cut.batched import FamilyResult
from .cut.classify import CutData
from .cut.fictdom import FictdomResult
from .cut.interface_problem import InterfaceDofMap, InterfaceResult
from .cut.methods import CutCellBatch
from .methods.assembly import DofMap, FaceIncidence
from .methods.cells_last import CondensedCL, GridVecCL, UniformCondCL
from .methods.condensation import CondensedSystem
from .methods.obstacle import ObstacleResult
from .methods.poisson import PoissonSolution


def tensor(a, device) -> torch.Tensor:
    """numpy (or array-like) -> tensor on ``device``; integer arrays
    become int64 (torch's index type), other dtypes are kept."""
    a = np.asarray(a)
    if a.dtype.kind in "iu" and a.dtype != np.int8:
        a = a.astype(np.int64)
    return torch.as_tensor(np.array(a), device=device)


def _fields(cls, obj, device, **override):
    return cls(**{f: override[f] if f in override else
                  tensor(getattr(obj, f), device) for f in cls._fields})


def mesh(m, device) -> Mesh:
    return Mesh(points=tensor(m.points, device),
                cell_ptids=tensor(m.cell_ptids, device),
                cell_npts=tensor(m.cell_npts, device),
                cell_faces=tensor(m.cell_faces, device),
                face_ptids=tensor(m.face_ptids, device),
                face_bnd=tensor(m.face_bnd, device),
                kind=m.kind, all_quads=bool(m.all_quads))


def cell_geom(g, device) -> CellGeom:
    return _fields(CellGeom, g, device)


def dofmap(dm, device) -> DofMap:
    return DofMap(**{f: tensor(getattr(dm, f), device) for f in (
        "asm_idx", "free_local", "dirichlet_local", "face_compress",
        "is_dirichlet_face")}, cbs=dm.cbs, fbs=dm.fbs, n_cells=dm.n_cells,
        n_dofs=dm.n_dofs)


def face_incidence(inc, device) -> FaceIncidence:
    return FaceIncidence(tensor(inc.face_cells, device),
                         tensor(inc.face_slot, device),
                         tensor(inc.expand, device))


def condensed_system(c, device) -> CondensedSystem:
    return _fields(CondensedSystem, c, device)


def poisson_solution(s, device) -> PoissonSolution:
    return PoissonSolution(
        x=tensor(s.x, device), local=tensor(s.local, device),
        oper=tensor(s.oper, device), iterations=int(s.iterations),
        exit_reason=int(s.exit_reason), rel_residual=float(s.rel_residual),
        history=None if s.history is None else tensor(s.history, device))


def obstacle_result(r, device) -> ObstacleResult:
    return ObstacleResult(
        alpha=tensor(r.alpha, device), beta=tensor(r.beta, device),
        iterations=int(r.iterations), converged=bool(r.converged),
        energy_error=tensor(r.energy_error, device))


def cut_data(c, device) -> CutData:
    return CutData(**{f: tensor(getattr(c, f), device) for f in
                      CutData.__dataclass_fields__})


def cut_cell_batch(b, device) -> CutCellBatch:
    return _fields(CutCellBatch, b, device, geom=cell_geom(b.geom, device))


def interface_dofmap(dm, device) -> InterfaceDofMap:
    return InterfaceDofMap(**{f: tensor(getattr(dm, f), device) for f in (
        "asm_uncut", "asm_cut", "uncut_ids", "cut_ids", "dirichlet_uncut",
        "cell_table", "face_table", "face_is_cut")}, cbs=dm.cbs, fbs=dm.fbs,
        num_all_cells=dm.num_all_cells, n_dofs=dm.n_dofs)


def fictdom_result(r, device) -> FictdomResult:
    return FictdomResult(
        x=tensor(r.x, device), local=tensor(r.local, device),
        h1_error=float(r.h1_error), iterations=int(r.iterations),
        exit_reason=int(r.exit_reason),
        min_eigs=None if r.min_eigs is None else tensor(r.min_eigs, device),
        oper_cut=None if r.oper_cut is None else tensor(r.oper_cut, device))


def interface_result(r, device) -> InterfaceResult:
    return InterfaceResult(
        x=tensor(r.x, device), local_neg=tensor(r.local_neg, device),
        local_pos=tensor(r.local_pos, device), h1_error=float(r.h1_error),
        iterations=int(r.iterations), exit_reason=int(r.exit_reason))


def family_result(r, device) -> FamilyResult:
    return _fields(FamilyResult, r, device)


def condensed_cl(c, device) -> CondensedCL:
    return _fields(CondensedCL, c, device)


def grid_vec_cl(x, device) -> GridVecCL:
    return _fields(GridVecCL, x, device)


def uniform_cond_cl(c, device) -> UniformCondCL:
    return _fields(UniformCondCL, c, device)


def mg_levels(levels, device) -> dict:
    """Keyword arguments of solvers.multigrid.build_multigrid from the
    JAX package's per-level data, ``levels`` = {n: (S, S_u, irr_ids,
    cut_ids)} as numpy: S is the full [nfd*nfd, C] Schur array, or the
    deviation dS [nfd*nfd, Ci] of a lean level; S_u and irr_ids are None
    on a level without the uniform split; cut_ids are the patch
    smoother's cells."""
    return dict(
        S_per_level={n: tensor(lev[0], device) for n, lev in levels.items()},
        uniform_per_level={
            n: (tensor(lev[1], device), np.asarray(lev[2], dtype=np.int64))
            for n, lev in levels.items() if lev[1] is not None},
        cut_ids_per_level={n: np.asarray(lev[3], dtype=np.int64)
                           for n, lev in levels.items()})
