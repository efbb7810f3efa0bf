"""Face-grid layout of the condensed system on the generated mesh (JAX
counterpart: proton_tpu/methods/structured.py).

Face unknowns are renumbered as grids, H [Ny+1, Nx] horizontal faces and
V [Ny, Nx+1] vertical faces, so gathering a cell's faces is slicing. Cell
local edge order is (bottom, right, top, left): slot0 = H[j, i],
slot1 = V[j, i+1], slot2 = H[j+1, i], slot3 = V[j, i]. Dirichlet faces
stay in the grids, frozen (masked, unit diagonal).

The row-major API of the JAX module (``GridVec`` with the coefficient
axis last, local Schur matrices [C, nfd, nfd]) is a thin layer over the
cells-last functions of methods/cells_last.py, which carry the
arithmetic: each function here permutes its inputs to the cells-last
layout (GridVecCL, [nfd*nfd, C]), calls its cells-last counterpart and
permutes the result back. ``solve_condensed_structured_cl`` is the solve
itself, for callers that hold cells-last operators already.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..solvers import cg
from ..utils.timing import timed

DEFAULT_CG = cg.CGParams(convergence_threshold=1e-6,
                         divergence_threshold=1e8, max_iter=50000,
                         apply_preconditioner=True)


class StructuredFaceSystem(NamedTuple):
    Nx: int
    Ny: int
    fbs: int
    freeH: torch.Tensor   # [Ny+1, Nx] bool, False on Dirichlet faces
    freeV: torch.Tensor   # [Ny, Nx+1] bool


def make_structured_system(Nx: int, Ny: int, fbs: int, *,
                           device) -> StructuredFaceSystem:
    """Boundary faces of the generated box are Dirichlet
    (basic_mesh.hpp:293-297): first/last H rows and V columns."""
    freeH = torch.ones((Ny + 1, Nx), dtype=torch.bool, device=device)
    freeH[0, :] = False
    freeH[Ny, :] = False
    freeV = torch.ones((Ny, Nx + 1), dtype=torch.bool, device=device)
    freeV[:, 0] = False
    freeV[:, Nx] = False
    return StructuredFaceSystem(Nx, Ny, fbs, freeH, freeV)


# cells_last imports StructuredFaceSystem from this module, so it is
# imported once that class exists.
from . import cells_last as cl  # noqa: E402


class GridVec(NamedTuple):
    """Face-grid unknowns, coefficient axis last."""

    H: torch.Tensor   # [Ny+1, Nx, fbs]
    V: torch.Tensor   # [Ny, Nx+1, fbs]


def _S_cl(S):
    """[C, n, n] -> cells-last [n*n, C]."""
    C, n = S.shape[0], S.shape[1]
    return S.permute(1, 2, 0).reshape(n * n, C)


def grid_gather(sys: StructuredFaceSystem, x: GridVec):
    """Local face vectors [C, 4*fbs] from the grids, by slicing."""
    return cl.grid_gather_cl(sys, cl.to_cells_last(x)).T


def grid_scatter(sys: StructuredFaceSystem, contrib) -> GridVec:
    """Adjoint of grid_gather: accumulate [C, 4*B] cell contributions
    into the face grids (B = fbs for values, fbs*fbs for the
    block-Jacobi blocks)."""
    return cl.from_cells_last(cl.grid_scatter_cl(sys, contrib.T))


def _mask(sys: StructuredFaceSystem, x: GridVec) -> GridVec:
    return GridVec(x.H * sys.freeH[..., None], x.V * sys.freeV[..., None])


def make_structured_operator(sys: StructuredFaceSystem, S):
    """Matrix-free Schur operator on the face grids for S [C, nfd, nfd];
    frozen (Dirichlet) faces act as identity."""
    apply_cl = cl.make_structured_operator_cl(sys, _S_cl(S))

    def apply_S(x: GridVec) -> GridVec:
        return cl.from_cells_last(apply_cl(cl.to_cells_last(x)))

    return apply_S


def structured_diagonal(sys: StructuredFaceSystem, S) -> GridVec:
    return cl.from_cells_last(cl.structured_diagonal_cl(sys, _S_cl(S)))


def assembled_face_blocks(sys: StructuredFaceSystem, S):
    """Assembled fbs x fbs diagonal block of every face (summed over its
    <= 2 cells), (BH [Ny+1, Nx, fbs, fbs], BV [Ny, Nx+1, fbs, fbs]);
    identity on frozen faces."""
    BH, BV = cl.assembled_face_blocks_cl(sys, _S_cl(S))
    return BH.permute(2, 3, 0, 1), BV.permute(2, 3, 0, 1)


def block_jacobi_preconditioner(sys: StructuredFaceSystem, S):
    """Per-face block-Jacobi: each face's assembled diagonal block of S,
    inverted once; frozen faces get the identity."""
    precond_cl = cl.block_jacobi_preconditioner_cl(sys, _S_cl(S))

    def precond(r: GridVec) -> GridVec:
        return cl.from_cells_last(precond_cl(cl.to_cells_last(r)))

    return precond


def make_cut_patch_smoother(sys: StructuredFaceSystem, S, cut_ids):
    """Interface-patch additive Schwarz smoother over the 4-face patches
    of the cells ``cut_ids`` (cells_last.make_cut_patch_smoother_cl)."""
    patch_cl = cl.make_cut_patch_smoother_cl(sys, _S_cl(S), cut_ids)

    def apply_patch(r: GridVec) -> GridVec:
        return cl.from_cells_last(patch_cl(cl.to_cells_last(r)))

    return apply_patch


def structured_rhs(sys: StructuredFaceSystem, cond, g_loc=None,
                   cbs: Optional[int] = None) -> GridVec:
    """Condensed loads of ``cond`` (a condensation.CondensedSystem), with
    the Dirichlet data of g_loc [C, d] folded in, on the grids."""
    gF_cl = None if g_loc is None else g_loc[:, cbs:].T
    cond_cl = cl.CondensedCL(_S_cl(cond.S), cond.bF.T, None, None)
    return cl.from_cells_last(cl.structured_rhs_cl(sys, cond_cl, gF_cl))


def solve_condensed_structured_cl(sys: StructuredFaceSystem, lc_cl, f_cl,
                                  cbs: int, gF_cl=None,
                                  cg_params: cg.CGParams = DEFAULT_CG,
                                  timings: Optional[dict] = None):
    """Condense lc_cl [d*d, C] with loads f_cl [cbs, C], Jacobi PCG on the
    face grids with the Dirichlet data gF_cl [nfd, C] folded in, recover
    the cells: (local [C, d], CGResult with x a GridVecCL). With a
    ``timings`` dict, condense_s, cg_s and recover_s are added to it."""
    dev = lc_cl.device
    with timed(timings, "condense_s", dev):
        cond = cl.condense_cl(lc_cl, f_cl, cbs)
        rhs = cl.structured_rhs_cl(sys, cond, gF_cl)
        apply_S = cl.make_structured_operator_cl(sys, cond.S)
        diag = cl.structured_diagonal_cl(sys, cond.S)
    with timed(timings, "cg_s", dev):
        res = cg.conjugated_gradient(apply_S, rhs, diag, cg_params)
    with timed(timings, "recover_s", dev):
        local = cl.solve_recover_cl(sys, cond, res.x, gF_cl)
    return local, res


def solve_condensed_structured(sys: StructuredFaceSystem, lc, f_cells,
                               cbs: int, g_loc=None,
                               cg_params: cg.CGParams = DEFAULT_CG
                               ) -> Tuple[torch.Tensor, cg.CGResult]:
    """Condense + grid-layout Jacobi PCG + recovery for lc [C, d, d],
    f_cells [C, cbs] and Dirichlet data g_loc [C, d]: (local [C, d],
    CGResult with x a GridVec). The same solution as
    condensation.solve_condensed."""
    gF_cl = None if g_loc is None else g_loc[:, cbs:].T
    local, res = solve_condensed_structured_cl(
        sys, _S_cl(lc), f_cells.T, cbs, gF_cl, cg_params)
    return local, res._replace(x=cl.from_cells_last(res.x))
