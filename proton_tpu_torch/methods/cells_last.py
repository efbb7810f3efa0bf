"""Cells-last ([entries, C]) condensed solve on the face grids (JAX
counterpart: proton_tpu/methods/cells_last.py, the fitted="full" subset).

The layout is the JAX package's, so the two compare entry by entry:
lc [d*d, C], condensed Schur S [nfd*nfd, C], face grids with the
polynomial coefficient leading (GridVecCL). The arithmetic is written as
batched tensor operations rather than the TPU's lane-unrolled lists:
condensation is ``torch.linalg.cholesky`` on [C, cbs, cbs] plus
``cholesky_solve``, and the Schur matvec runs over an [nfd, nfd, C] view.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .structured import StructuredFaceSystem


class CondensedCL(NamedTuple):
    """Condensed system, cells-last. X = ATT^-1 ATF and y = ATT^-1 fT are
    the back-substitution operators, so recovery needs no factorization."""

    S: torch.Tensor    # [nfd*nfd, C]
    bF: torch.Tensor   # [nfd, C]
    X: torch.Tensor    # [cbs*nfd, C]
    y: torch.Tensor    # [cbs, C]


def condense_cl(lc_cl, f_cl, cbs: int) -> CondensedCL:
    """Schur-eliminate the first cbs local dofs of every cell:
    S = AFF - AFT ATT^-1 ATF, bF = -AFT ATT^-1 fT."""
    d2, C = lc_cl.shape
    d = int(round(d2 ** 0.5))
    nfd = d - cbs
    A = lc_cl.reshape(d, d, C).permute(2, 0, 1)          # [C, d, d] view
    rhs = torch.cat([A[:, :cbs, cbs:], f_cl.T[:, :, None]], dim=2)
    XY = torch.cholesky_solve(rhs, torch.linalg.cholesky(A[:, :cbs, :cbs]))
    AFT = A[:, cbs:, :cbs]
    S = A[:, cbs:, cbs:] - AFT @ XY[:, :, :nfd]
    bF = -(AFT @ XY[:, :, nfd:])[:, :, 0]
    return CondensedCL(S.permute(1, 2, 0).reshape(nfd * nfd, C),
                       bF.T.contiguous(),
                       XY[:, :, :nfd].permute(1, 2, 0).reshape(cbs * nfd, C),
                       XY[:, :, nfd].T.contiguous())


def _matvec(M_cl, x, n_out: int, n_in: int):
    """y [n_out, C] with y[:, c] = M[:, :, c] x[:, c] over the
    [n_out, n_in, C] view of M_cl [n_out*n_in, C]."""
    return (M_cl.reshape(n_out, n_in, -1) * x[None]).sum(dim=1)


def recover_cells_cl(cond: CondensedCL, uF_cl):
    """uT [cbs, C] = y - X uF."""
    cbs, nfd = cond.y.shape[0], cond.bF.shape[0]
    return cond.y - _matvec(cond.X, uF_cl, cbs, nfd)


def set_columns(a, ids, b):
    """a[:, ids] = b as plain indexed assignment, in place; returns a."""
    a[:, ids] = b
    return a


# ---------------------------------------------------------------------------
# Face grids with the coefficient axis leading
# ---------------------------------------------------------------------------


class GridVecCL(NamedTuple):
    H: torch.Tensor   # [fbs, Ny+1, Nx]
    V: torch.Tensor   # [fbs, Ny, Nx+1]


def grid_gather_cl(sys: StructuredFaceSystem, x: GridVecCL):
    """Local face vectors [4*fbs, C] by slicing (slot order bottom,
    right, top, left)."""
    loc = torch.cat([x.H[:, :-1, :], x.V[:, :, 1:],
                     x.H[:, 1:, :], x.V[:, :, :-1]], dim=0)
    return loc.reshape(4 * sys.fbs, sys.Ny * sys.Nx)


def grid_scatter_cl(sys: StructuredFaceSystem, contrib) -> GridVecCL:
    """Adjoint of grid_gather_cl: [4*B, C] -> grids [B, ...]."""
    B = contrib.shape[0] // 4
    c = contrib.reshape(4, B, sys.Ny, sys.Nx)
    H = contrib.new_zeros((B, sys.Ny + 1, sys.Nx))
    H[:, :-1] = c[0]
    H[:, 1:] += c[2]
    V = contrib.new_zeros((B, sys.Ny, sys.Nx + 1))
    V[:, :, :-1] = c[3]
    V[:, :, 1:] += c[1]
    return GridVecCL(H, V)


def mask_cl(sys: StructuredFaceSystem, x: GridVecCL) -> GridVecCL:
    return GridVecCL(x.H * sys.freeH[None], x.V * sys.freeV[None])


def make_structured_operator_cl(sys: StructuredFaceSystem, S_cl):
    """Matrix-free Schur operator on the face grids: slice-gather, per-cell
    matvec, shift-scatter; frozen (Dirichlet) faces act as identity."""
    nfd = 4 * sys.fbs
    fixH, fixV = ~sys.freeH[None], ~sys.freeV[None]

    def apply_S(x: GridVecCL) -> GridVecCL:
        xl = grid_gather_cl(sys, mask_cl(sys, x))
        y = mask_cl(sys, grid_scatter_cl(sys, _matvec(S_cl, xl, nfd, nfd)))
        return GridVecCL(y.H + x.H * fixH, y.V + x.V * fixV)

    return apply_S


def structured_diagonal_cl(sys: StructuredFaceSystem, S_cl) -> GridVecCL:
    nfd = 4 * sys.fbs
    dl = S_cl.reshape(nfd, nfd, -1).diagonal(dim1=0, dim2=1).T
    d = grid_scatter_cl(sys, dl)
    one = torch.ones((), dtype=S_cl.dtype, device=S_cl.device)
    return GridVecCL(torch.where(sys.freeH[None], d.H, one),
                     torch.where(sys.freeV[None], d.V, one))


def structured_rhs_cl(sys: StructuredFaceSystem, cond: CondensedCL,
                      gF_cl=None) -> GridVecCL:
    """Condensed loads (+ Dirichlet fold, gF_cl [nfd, C]) scattered to the
    grids."""
    nfd = cond.bF.shape[0]
    loads = cond.bF
    if gF_cl is not None:
        loads = loads - _matvec(cond.S, gF_cl, nfd, nfd)
    return mask_cl(sys, grid_scatter_cl(sys, loads))


def assembled_face_blocks_cl(sys: StructuredFaceSystem, S_cl):
    """Per-face assembled fbs x fbs diagonal blocks, (BH [fbs, fbs, Ny+1,
    Nx], BV [fbs, fbs, Ny, Nx+1]); identity on frozen faces."""
    fbs = sys.fbs
    C = S_cl.shape[1]
    S5 = S_cl.reshape(4, fbs, 4, fbs, C)
    blocks = torch.stack([S5[s, :, s] for s in range(4)])   # [4, fbs, fbs, C]
    acc = grid_scatter_cl(sys, blocks.reshape(4 * fbs * fbs, C))
    BH = acc.H.reshape(fbs, fbs, sys.Ny + 1, sys.Nx)
    BV = acc.V.reshape(fbs, fbs, sys.Ny, sys.Nx + 1)
    eye = torch.eye(fbs, dtype=S_cl.dtype, device=S_cl.device)[:, :, None, None]
    return (torch.where(sys.freeH[None, None], BH, eye),
            torch.where(sys.freeV[None, None], BV, eye))


def _inv_planes(B):
    """Inverse of plane-stacked matrices [n, n, ...]."""
    return torch.linalg.inv(B.permute(2, 3, 0, 1)).permute(2, 3, 0, 1)


def block_jacobi_setup_cl(sys: StructuredFaceSystem, S_cl):
    """Inverse fbs x fbs face blocks in grid planes (iH, iV)."""
    BH, BV = assembled_face_blocks_cl(sys, S_cl)
    return _inv_planes(BH), _inv_planes(BV)


def apply_block_jacobi_cl(iH, iV, r: GridVecCL) -> GridVecCL:
    return GridVecCL((iH * r.H[None]).sum(dim=1), (iV * r.V[None]).sum(dim=1))


def block_jacobi_preconditioner_cl(sys: StructuredFaceSystem, S_cl):
    """Per-face block-Jacobi: each face's assembled diagonal block of S,
    inverted once; frozen faces get the identity."""
    iH, iV = block_jacobi_setup_cl(sys, S_cl)

    def precond(r: GridVecCL) -> GridVecCL:
        return apply_block_jacobi_cl(iH, iV, r)

    return precond


def solve_recover_cl(sys: StructuredFaceSystem, cond: CondensedCL,
                     x: GridVecCL, gF_cl=None):
    """Face solution -> per-cell local dofs [C, d] (uT, uF)."""
    uF = grid_gather_cl(sys, mask_cl(sys, x))
    if gF_cl is not None:
        uF = uF + gF_cl
    uT = recover_cells_cl(cond, uF)
    return torch.cat([uT, uF], dim=0).T
