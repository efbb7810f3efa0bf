"""Static condensation: exact Schur-complement elimination of the cell
unknowns onto the face skeleton (JAX counterpart:
proton_tpu/methods/condensation.py).

    S_loc  = A_FF - A_FT A_TT^-1 A_TF          [C, nfd, nfd]
    bF_loc = fF  - A_FT A_TT^-1 f_T            [C, nfd]
    u_T    = A_TT^-1 (f_T - A_TF u_F)          (recovery)

The condensed solution reproduces the full system's face values; the
cell values come back per cell from one batched small solve. Dirichlet
data folds into the condensed system with the same local mechanism as
the full assembler (hho.hpp:396-402).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.ops import cho_solve_batched, robust_spd_solve
from ..solvers import cg
from ..utils.timing import sink, span
from .assembly import DofMap, FaceIncidence, _apply_local, \
    _incidence_gather, gather_values, scatter_values


class CondensedSystem(NamedTuple):
    S: torch.Tensor          # [C, nfd, nfd] condensed local matrices
    bF: torch.Tensor         # [C, nfd] condensed local loads
    ATT: torch.Tensor        # [C, cbs, cbs] cell blocks
    ATF: torch.Tensor        # [C, cbs, nfd]
    fT: torch.Tensor         # [C, cbs]


def condense(lc, f_cells, cbs: int,
             robust: bool = False) -> CondensedSystem:
    """Eliminate the first cbs local dofs of every cell; f_cells [C, cbs]
    (face loads are zero in every reference problem). ``robust`` solves
    the cell blocks with robust_spd_solve's LU fallback."""
    solver = robust_spd_solve if robust else cho_solve_batched
    ATT = lc[:, :cbs, :cbs]
    ATF = lc[:, :cbs, cbs:]
    AFT = lc[:, cbs:, :cbs]
    iTT_ATF = solver(ATT, ATF)
    iTT_fT = solver(ATT, f_cells[..., None])[..., 0]
    S = lc[:, cbs:, cbs:] - torch.bmm(AFT, iTT_ATF)
    bF = -_apply_local(AFT, iTT_fT)
    return CondensedSystem(S, bF, ATT, ATF, f_cells)


def face_dof_view(dofmap: DofMap):
    """(idx [C, nfd], n_face_dofs): asm_idx restricted to the face slots
    and rebased to [0, n_face_dofs); the sentinel becomes n_face_dofs."""
    cell_dofs = dofmap.n_cells * dofmap.cbs
    n_face_dofs = dofmap.n_dofs - cell_dofs
    idx = dofmap.asm_idx[:, dofmap.cbs:]
    idx = torch.where(idx >= dofmap.n_dofs, n_face_dofs, idx - cell_dofs)
    return idx, n_face_dofs


def make_condensed_operator(dofmap: DofMap, inc: Optional[FaceIncidence],
                            S):
    """Matrix-free S @ x on the face system: with a FaceIncidence, the
    gather form; otherwise the indexed-add scatter."""
    idx, n_face_dofs = face_dof_view(dofmap)

    if inc is None:
        def apply_S(x):
            return scatter_values(idx, n_face_dofs,
                                  _apply_local(S, gather_values(idx, x)))
        return apply_S

    def apply_S(x):
        contrib = _apply_local(S, gather_values(idx, x))
        return _incidence_gather(inc, contrib, 0, dofmap.fbs)

    return apply_S


def condensed_diagonal(dofmap: DofMap, S):
    idx, n_face_dofs = face_dof_view(dofmap)
    return scatter_values(idx, n_face_dofs,
                          torch.diagonal(S, dim1=1, dim2=2))


def condensed_rhs(dofmap: DofMap, sys: CondensedSystem, g_loc=None):
    """Face-system RHS with the Dirichlet data folded through the
    condensed operator (equivalent to folding before elimination)."""
    idx, n_face_dofs = face_dof_view(dofmap)
    loads = sys.bF
    if g_loc is not None:
        loads = loads - _apply_local(sys.S, g_loc[:, dofmap.cbs:])
    return scatter_values(idx, n_face_dofs, loads)


def recover_local(dofmap: DofMap, sys: CondensedSystem, x_faces,
                  g_loc=None):
    """Per-cell [C, d] local solutions from the face solve: gather the
    face dofs (+ Dirichlet data), then back-substitute the cell block."""
    idx, _ = face_dof_view(dofmap)
    uF = gather_values(idx, x_faces)
    if g_loc is not None:
        uF = uF + g_loc[:, dofmap.cbs:]
    rhs_T = sys.fT - _apply_local(sys.ATF, uF)
    uT = cho_solve_batched(sys.ATT, rhs_T[..., None])[..., 0]
    return torch.cat([uT, uF], dim=1)


def solve_condensed(dofmap: DofMap, lc, f_cells, g_loc=None,
                    inc: Optional[FaceIncidence] = None,
                    cg_params: cg.CGParams = cg.CGParams(
                        convergence_threshold=1e-12,
                        divergence_threshold=1e8, max_iter=200000,
                        apply_preconditioner=True),
                    timings: Optional[dict] = None):
    """Condense, CG-solve the face system, recover the cells. Returns
    (local [C, d], CGResult). With a ``timings`` dict, the seconds of
    condensation, CG and recovery are recorded in it (device
    synchronized after each)."""
    with sink(timings):
        with span("condense", lc.device):
            sys = condense(lc, f_cells, dofmap.cbs)
            rhs = condensed_rhs(dofmap, sys, g_loc)
            apply_S = make_condensed_operator(dofmap, inc, sys.S)
            diag = condensed_diagonal(dofmap, sys.S)
        with span("cg", lc.device):
            res = cg.conjugated_gradient(apply_S, rhs, diag, cg_params)
        with span("recover", lc.device):
            local = recover_local(dofmap, sys, res.x, g_loc)
    return local, res
