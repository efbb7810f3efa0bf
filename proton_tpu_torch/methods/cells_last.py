"""Cells-last ([entries, C]) condensed solve on the face grids (JAX
counterpart: proton_tpu/methods/cells_last.py).

The layout is the JAX package's, so the two compare entry by entry:
lc [d*d, C], condensed Schur S [nfd*nfd, C], face grids with the
polynomial coefficient leading (GridVecCL). The arithmetic is written as
batched tensor operations rather than the TPU's lane-unrolled lists:
condensation is ``torch.linalg.cholesky`` on [C, cbs, cbs] plus
``cholesky_solve``, and the Schur matvec runs over an [nfd, nfd, C] view.

The uniform family (second half of the module) splits the system of the
generated mesh into one constant unit-cell block ``S_u`` plus deviations
``dS`` on the O(N) irregular (cut or displaced) cells. Its operators are
one small dense product over the [nfd, C] view plus an indexed
correction. Every index tensor is built once, at setup, on the device:
an apply makes no host-to-device copy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
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


def from_row_major(cond_rm) -> CondensedCL:
    """condensation.CondensedSystem ([C, ...]) -> CondensedCL: the
    transpose plus the back-substitution operators X, y, computed here in
    cond_rm's dtype with robust_spd_solve. The float64 cut class of the
    mixed-precision system passes through here before it is rounded to
    float32, so X and y carry the float64 solve and only their values
    are rounded."""
    from ..core.ops import robust_spd_solve

    C, nfd = cond_rm.bF.shape
    cbs = cond_rm.fT.shape[1]
    XY = robust_spd_solve(cond_rm.ATT, torch.cat(
        [cond_rm.ATF, cond_rm.fT[..., None]], dim=-1))
    return CondensedCL(cond_rm.S.permute(1, 2, 0).reshape(nfd * nfd, C),
                       cond_rm.bF.T.contiguous(),
                       XY[..., :nfd].permute(1, 2, 0).reshape(cbs * nfd, C),
                       XY[..., nfd].T.contiguous())


def set_cells(cond: CondensedCL, ids, sub: CondensedCL) -> CondensedCL:
    """Overwrite the columns ``ids`` of every member with a small
    condensed batch, in place (the splice of the float64 cut class into
    the float32 system); returns cond."""
    for a, b in zip(cond, sub):
        set_columns(a, ids, b.to(a.dtype))
    return cond


# ---------------------------------------------------------------------------
# Face grids with the coefficient axis leading
# ---------------------------------------------------------------------------


class GridVecCL(NamedTuple):
    H: torch.Tensor   # [fbs, Ny+1, Nx]
    V: torch.Tensor   # [fbs, Ny, Nx+1]


def to_cells_last(x) -> GridVecCL:
    """structured.GridVec ([Ny+1, Nx, fbs]) -> GridVecCL."""
    return GridVecCL(x.H.permute(2, 0, 1).contiguous(),
                     x.V.permute(2, 0, 1).contiguous())


def from_cells_last(x: GridVecCL):
    """GridVecCL -> structured.GridVec (a view)."""
    from .structured import GridVec

    return GridVec(x.H.permute(1, 2, 0), x.V.permute(1, 2, 0))


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


# ---------------------------------------------------------------------------
# Uniform-stencil split operator
#
# On the generated mesh the condensed local Schur matrix is identical for
# every uncut, undisplaced cell (congruent squares, translation-invariant
# scaled-monomial bases), so S_cl = broadcast(S_u) + dS with dS supported
# on the O(N) irregular columns. The matvec reads only x: one [nfd, nfd]
# product over the cell grid plus a small indexed correction.
# ---------------------------------------------------------------------------


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.array(a))


def _on(sys: StructuredFaceSystem, a, dtype) -> torch.Tensor:
    """``a`` (tensor or array) as a ``dtype`` tensor on the system's
    device."""
    return _as_tensor(a).to(dtype=dtype, device=sys.freeH.device)


def _ids_np(ids) -> np.ndarray:
    if isinstance(ids, torch.Tensor):
        ids = ids.cpu().numpy()
    return np.asarray(ids, dtype=np.int64)


class CellFaceIndex(NamedTuple):
    """Flat positions, in the H [Ny+1, Nx] and V [Ny, Nx+1] planes, of the
    four faces of a set of cells (slot order bottom, right, top, left),
    as device tensors. Within one member the positions are unique; across
    members they repeat (the top face of a cell is the bottom face of the
    cell above), so scatters add member by member."""

    hb: torch.Tensor
    vr: torch.Tensor
    ht: torch.Tensor
    vl: torch.Tensor


def cell_face_index(sys: StructuredFaceSystem, ids) -> CellFaceIndex:
    ids = _ids_np(ids)
    jj, ii = ids // sys.Nx, ids % sys.Nx
    dev = sys.freeH.device
    hb, vl = jj * sys.Nx + ii, jj * (sys.Nx + 1) + ii
    return CellFaceIndex(*(torch.as_tensor(a, device=dev)
                           for a in (hb, vl + 1, hb + sys.Nx, vl)))


def _gather_faces(idx: CellFaceIndex, H, V):
    """Local face vectors [4*fbs, Ci] of the indexed cells."""
    Hf, Vf = H.reshape(H.shape[0], -1), V.reshape(V.shape[0], -1)
    return torch.cat([Hf[:, idx.hb], Vf[:, idx.vr], Hf[:, idx.ht],
                      Vf[:, idx.vl]], dim=0)


def _scatter_add_faces(idx: CellFaceIndex, H, V, c) -> None:
    """Add c [4, fbs, Ci] to the indexed cells' faces of the contiguous
    grids H, V, in place: four accumulating adds, one per slot."""
    Hf, Vf = H.view(H.shape[0], -1), V.view(V.shape[0], -1)
    Hf.index_add_(1, idx.hb, c[0])
    Hf.index_add_(1, idx.ht, c[2])
    Vf.index_add_(1, idx.vl, c[3])
    Vf.index_add_(1, idx.vr, c[1])


def uniform_deltas(S_cl, S_u, ids):
    """dS [nfd*nfd, Ci] = S_cl[:, ids] - S_u (setup-time)."""
    ids = torch.as_tensor(_ids_np(ids), device=S_cl.device)
    S_u = _as_tensor(S_u).to(dtype=S_cl.dtype, device=S_cl.device)
    return S_cl[:, ids] - S_u.reshape(-1, 1)


def make_uniform_operator_cl(sys: StructuredFaceSystem, S_u, ids=None,
                             dS=None):
    """Matrix-free Schur operator of the constant-coefficient system.
    ``S_u`` is the [nfd, nfd] unit-cell condensed matrix. With ``ids`` and
    ``dS`` (irregular columns and their deviation, uniform_deltas) the
    result equals make_structured_operator_cl of the spliced system;
    without them it is the pure uniform operator."""
    nfd = 4 * sys.fbs
    dtype = dS.dtype if dS is not None else _as_tensor(S_u).dtype
    Su = _on(sys, S_u, dtype)
    if tuple(Su.shape) != (nfd, nfd):
        raise ValueError(f"S_u of shape {tuple(Su.shape)}, expected "
                         f"{(nfd, nfd)}")
    idx = None
    if ids is not None and len(ids) > 0:
        idx = torch.as_tensor(_ids_np(ids), device=Su.device)
    freeH, freeV = sys.freeH[None], sys.freeV[None]

    def apply_S(x: GridVecCL) -> GridVecCL:
        xl = grid_gather_cl(sys, GridVecCL(x.H * freeH, x.V * freeV))
        c = Su @ xl
        if idx is not None:
            # the irregular cells' correction, added to their local
            # contributions (the ids are unique) before the face scatter
            c.index_add_(1, idx, _matvec(dS, xl[:, idx], nfd, nfd))
        y = grid_scatter_cl(sys, c)
        return GridVecCL(torch.where(freeH, y.H, x.H),
                         torch.where(freeV, y.V, x.V))

    return apply_S


def uniform_diagonal_cl(sys: StructuredFaceSystem, S_u, irr_ids,
                        dS) -> GridVecCL:
    """structured_diagonal_cl of the spliced system (the unit cell's
    diagonal on every cell plus the diagonal of dS at the irregular
    columns), without forming the spliced S."""
    nfd = 4 * sys.fbs
    dl = _on(sys, S_u, dS.dtype).diagonal()[:, None].repeat(
        1, sys.Nx * sys.Ny)
    irr = _ids_np(irr_ids)
    if len(irr):
        dl[:, torch.as_tensor(irr, device=dl.device)] += dS.reshape(
            nfd, nfd, -1).diagonal(dim1=0, dim2=1).T
    d = grid_scatter_cl(sys, dl)
    one = torch.ones((), dtype=dl.dtype, device=dl.device)
    return GridVecCL(torch.where(sys.freeH[None], d.H, one),
                     torch.where(sys.freeV[None], d.V, one))


def uniform_block_jacobi_blocks(sys: StructuredFaceSystem, S_u):
    """[fbs, fbs] inverse diagonal blocks (iHu, iVu) of the uniform
    system's interior H and V faces: every free face sees the same two
    cell contributions (bottom + top slots, left + right slots)."""
    Su = _as_tensor(S_u)
    fbs = Su.shape[0] // 4
    b, r, t, l = 0, fbs, 2 * fbs, 3 * fbs
    BH = Su[b:b + fbs, b:b + fbs] + Su[t:t + fbs, t:t + fbs]
    BV = Su[l:l + fbs, l:l + fbs] + Su[r:r + fbs, r:r + fbs]
    return torch.linalg.inv(BH), torch.linalg.inv(BV)


def make_uniform_block_jacobi_cl(sys: StructuredFaceSystem, iHu, iVu,
                                 corrH=None, corrV=None):
    """Block-Jacobi apply with constant interior inverse blocks plus
    per-face corrections (hj, hi, dH [fbs, fbs, nH]) and (vj, vi, dV)
    from uniform_bj_from_deltas."""
    fbs = sys.fbs

    def correction(corr, width):
        if corr is None or len(corr[0]) == 0:
            return None
        j, i, d = corr
        flat = torch.as_tensor(j, device=d.device) * width + \
            torch.as_tensor(i, device=d.device)
        return flat, d.reshape(fbs * fbs, -1)

    cH, cV = correction(corrH, sys.Nx), correction(corrV, sys.Nx + 1)

    def apply(iu, corr, r):
        rf = r.reshape(fbs, -1)
        out = iu.to(r.dtype) @ rf
        if corr is not None:
            flat, d = corr
            out.index_add_(1, flat, _matvec(d, rf[:, flat], fbs, fbs))
        return out.reshape(r.shape)

    iHu, iVu = (_on(sys, a, _as_tensor(a).dtype) for a in (iHu, iVu))

    def precond(x: GridVecCL) -> GridVecCL:
        return GridVecCL(apply(iHu, cH, x.H), apply(iVu, cV, x.V))

    return precond


# ---------------------------------------------------------------------------
# Lean uniform condensed system: the O(N^2) broadcasts stay implicit (the
# unit-cell blocks), and only the O(C) load vectors and the O(N) irregular
# columns are stored. Face diagonal blocks, block-Jacobi, the patch
# smoother, the rhs fold and the recovery all derive from dS.
# ---------------------------------------------------------------------------


class UniformCondCL(NamedTuple):
    """Lean uniform condensed system. The unit-cell blocks (S_u, X_u,
    ATT_u) and the sorted irregular ids travel beside it. Irregular
    columns store their exact back-substitution operators."""

    dS: torch.Tensor     # [nfd*nfd, Ci]  S deviation at irregular columns
    bF: torch.Tensor     # [nfd, C]
    fT: torch.Tensor     # [cbs, C]
    X_i: torch.Tensor    # [cbs*nfd, Ci]  ATT^-1 ATF at irregular columns
    y_i: torch.Tensor    # [cbs, Ci]      ATT^-1 fT at irregular columns


def _slot_diag_blocks(dS, fbs: int, slot: int):
    """[Ci, fbs, fbs] diagonal slot block of dS [nfd*nfd, Ci]."""
    nfd = 4 * fbs
    s = slice(slot * fbs, (slot + 1) * fbs)
    return dS.reshape(nfd, nfd, -1)[s, s].permute(2, 0, 1)


def uniform_face_block_deltas(sys: StructuredFaceSystem, dS, irr_ids):
    """Per-face deviations of the assembled fbs x fbs diagonal blocks from
    the uniform interior block, from the dS columns alone: each irregular
    cell adds its dS diagonal slot block to its 4 faces (a face shared by
    two irregular cells gets both); frozen faces are dropped. Returns
    ((hj, hi, dBH [nH, fbs, fbs]), (vj, vi, dBV [nV, fbs, fbs])) with
    hj, hi, vj, vi as numpy arrays."""
    fbs, Nx, Ny = sys.fbs, sys.Nx, sys.Ny
    ids = _ids_np(irr_ids)
    jj, ii = ids // Nx, ids % Nx

    def accumulate(keys, free, lo_slot, hi_slot):
        uniq, inv = np.unique(keys[free], return_inverse=True)
        contrib = torch.cat([_slot_diag_blocks(dS, fbs, lo_slot),
                             _slot_diag_blocks(dS, fbs, hi_slot)])[
            torch.as_tensor(np.nonzero(free)[0], device=dS.device)]
        dB = dS.new_zeros((max(len(uniq), 1), fbs, fbs))
        dB.index_add_(0, torch.as_tensor(inv.reshape(-1), device=dS.device),
                      contrib)
        return uniq, dB

    # H faces: slot b -> (jj, ii), slot t -> (jj+1, ii)
    hkey = np.concatenate([jj * Nx + ii, (jj + 1) * Nx + ii])
    hu, dBH = accumulate(hkey, (hkey // Nx != 0) & (hkey // Nx != Ny), 0, 2)
    # V faces: slot l -> (jj, ii), slot r -> (jj, ii+1)
    W = Nx + 1
    vkey = np.concatenate([jj * W + ii, jj * W + ii + 1])
    vu, dBV = accumulate(vkey, (vkey % W != 0) & (vkey % W != Nx), 3, 1)
    return (hu // Nx, hu % Nx, dBH), (vu // W, vu % W, dBV)


def uniform_bj_from_deltas(sys: StructuredFaceSystem, S_u, hfaces, vfaces,
                           dtype):
    """(corrH, corrV) for make_uniform_block_jacobi_cl from the face block
    deltas: inv(Bu + dB) - inv(Bu) at each touched free face."""
    iHu, iVu = (_on(sys, a, dtype)
                for a in uniform_block_jacobi_blocks(sys, S_u))

    def corr(faces, iu):
        j, i, dB = faces
        d = torch.linalg.inv(torch.linalg.inv(iu) + dB) - iu
        if len(j) == 0:
            d = d[:0]
        return (torch.as_tensor(j, device=d.device),
                torch.as_tensor(i, device=d.device), d.permute(1, 2, 0))

    return corr(hfaces, iHu), corr(vfaces, iVu)


def _pick_columns(table_keys, table_vals, keys, default_shape, dtype):
    """Values at ``keys`` from a sorted (table_keys -> table_vals [n, ...])
    map, zeros where a key is missing. The keys are host arrays."""
    keys = np.asarray(keys)
    if len(table_keys) == 0:
        return torch.zeros((len(keys),) + tuple(default_shape), dtype=dtype,
                           device=table_vals.device)
    pos = np.clip(np.searchsorted(table_keys, keys), 0, len(table_keys) - 1)
    hit = torch.as_tensor(table_keys[pos] == keys, device=table_vals.device)
    vals = table_vals[torch.as_tensor(pos, device=table_vals.device)]
    return vals * hit.reshape((-1,) + (1,) * (vals.ndim - 1))


def _patch_blocks_inverse(sys: StructuredFaceSystem, B, sb, ids):
    """Inverted patch blocks [Cc, nfd, nfd]: the cells' Schur blocks B with
    the diagonal slot blocks replaced by the assembled face blocks sb
    [Cc, 4, fbs, fbs], frozen slots turned into identity rows."""
    fbs, Nx = sys.fbs, sys.Nx
    nfd = 4 * fbs
    Cc = B.shape[0]
    B = B.reshape(Cc, 4, fbs, 4, fbs).clone()
    for s in range(4):
        B[:, s, :, s, :] = sb[:, s]
    B = B.reshape(Cc, nfd, nfd)
    ids = _ids_np(ids)
    jj = torch.as_tensor(ids // Nx, device=B.device)
    ii = torch.as_tensor(ids % Nx, device=B.device)
    free_slot = torch.stack([sys.freeH[jj, ii], sys.freeV[jj, ii + 1],
                             sys.freeH[jj + 1, ii], sys.freeV[jj, ii]], dim=1)
    m = free_slot.repeat_interleave(fbs, dim=1).to(B.dtype)
    eye = torch.eye(nfd, dtype=B.dtype, device=B.device)
    B = B * (m[:, :, None] * m[:, None, :]) + eye * (1.0 - m)[:, None, :]
    return torch.linalg.inv(B)


def _patch_weights(sys: StructuredFaceSystem, ids, dtype):
    """1/sqrt(multiplicity) overlap weight grids of the patch cells."""
    nfd = 4 * sys.fbs
    C = sys.Nx * sys.Ny
    dev = sys.freeH.device
    mask = torch.zeros((C,), dtype=dtype, device=dev)
    mask[torch.as_tensor(_ids_np(ids), device=dev)] = 1.0
    mult = grid_scatter_cl(sys, mask.expand(nfd, C))

    def weight(m):
        return torch.where(m > 0, 1.0 / torch.sqrt(torch.clamp(m, min=1.0)),
                           torch.zeros_like(m))

    return weight(mult.H), weight(mult.V)


def uniform_patch_setup_lean(sys: StructuredFaceSystem, S_u, dS, irr_ids,
                             patch_ids, dtype):
    """cut_patch_setup_cl from the lean data: the patch cells' S columns
    are S_u + dS (zero off the irregular set), their face diagonal blocks
    Bu + dB from uniform_face_block_deltas. Same outputs (Binv, wH, wV)."""
    fbs, Nx = sys.fbs, sys.Nx
    nfd = 4 * fbs
    pids = _ids_np(patch_ids)
    irr = _ids_np(irr_ids)
    jj, ii = pids // Nx, pids % Nx
    dS_cols = _pick_columns(irr, dS.T, pids, (nfd * nfd,), dtype)
    Su = _on(sys, S_u, dtype)
    B = Su[None] + dS_cols.reshape(len(pids), nfd, nfd)

    (hfj, hfi, dBH), (vfj, vfi, dBV) = uniform_face_block_deltas(sys, dS,
                                                                 irr)
    hkeys, vkeys = hfj * Nx + hfi, vfj * (Nx + 1) + vfi
    BHu, BVu = (torch.linalg.inv(_on(sys, a, dtype))
                for a in uniform_block_jacobi_blocks(sys, S_u))

    def face_blocks(keys_cell, dB_tab, tab_keys, Bu):
        return Bu[None] + _pick_columns(tab_keys, dB_tab, keys_cell,
                                        (fbs, fbs), dtype)

    sb = torch.stack([
        face_blocks(jj * Nx + ii, dBH, hkeys, BHu),             # bottom
        face_blocks(jj * (Nx + 1) + ii + 1, dBV, vkeys, BVu),   # right
        face_blocks((jj + 1) * Nx + ii, dBH, hkeys, BHu),       # top
        face_blocks(jj * (Nx + 1) + ii, dBV, vkeys, BVu),       # left
    ], dim=1)                                       # [Cc, 4, fbs, fbs]
    return (_patch_blocks_inverse(sys, B, sb, pids),
            *_patch_weights(sys, pids, dtype))


def uniform_rhs_cl(sys: StructuredFaceSystem, ucond: UniformCondCL, S_u,
                   irr_ids, gF_cl=None) -> GridVecCL:
    """structured_rhs_cl for the lean system: the S gF Dirichlet fold is
    the unit-cell product plus the dS corrections."""
    nfd = ucond.bF.shape[0]
    loads = ucond.bF
    if gF_cl is not None:
        loads = loads - _on(sys, S_u, loads.dtype) @ gF_cl
        irr = _ids_np(irr_ids)
        if len(irr):
            idx = torch.as_tensor(irr, device=loads.device)
            loads[:, idx] -= _matvec(ucond.dS, gF_cl[:, idx], nfd, nfd)
    return mask_cl(sys, grid_scatter_cl(sys, loads))


def uniform_recover_cl(sys: StructuredFaceSystem, ucond: UniformCondCL, X_u,
                       ATT_u, irr_ids, x: GridVecCL, gF_cl=None):
    """solve_recover_cl for the lean system: regular cells back-substitute
    through the unit-cell blocks, irregular cells through their stored
    blocks."""
    cbs, nfd = ucond.fT.shape[0], ucond.bF.shape[0]
    uF = grid_gather_cl(sys, mask_cl(sys, x))
    if gF_cl is not None:
        uF = uF + gF_cl
    # inverted in ATT_u's own dtype (float64), then rounded, as the JAX
    # package does for a float32 system
    Ai = torch.linalg.inv(_on(sys, ATT_u, _as_tensor(ATT_u).dtype)).to(
        uF.dtype)
    uT = Ai @ ucond.fT - _on(sys, X_u, uF.dtype) @ uF
    irr = _ids_np(irr_ids)
    if len(irr):
        idx = torch.as_tensor(irr, device=uF.device)
        uT[:, idx] = ucond.y_i - _matvec(ucond.X_i, uF[:, idx], cbs, nfd)
    return torch.cat([uT, uF], dim=0).T


# ---------------------------------------------------------------------------
# Interface-patch smoother
# ---------------------------------------------------------------------------


def checkerboard_split(ids, Nx: int):
    """Cell ids on the Nx-wide grid split into (even, odd) checkerboard
    colors. Cells of one color are never edge-adjacent, so their 4-face
    patches share no face."""
    ids = _ids_np(ids)
    par = ((ids // Nx) + (ids % Nx)) % 2
    return ids[par == 0], ids[par == 1]


def patch_color_groups(ids, Nx: int, patch_colors: int):
    """Per-color id groups of the patch smoother (the non-empty ones;
    patch_colors 1 or 2)."""
    groups = (_ids_np(ids),) if patch_colors == 1 else \
        checkerboard_split(ids, Nx)
    return tuple(g for g in groups if len(g) > 0)


def cut_patch_setup_cl(sys: StructuredFaceSystem, S_cl, cut_ids):
    """Setup arrays of the interface-patch smoother from the full S:
    inverted patch blocks [Cc, nfd, nfd] and the 1/sqrt(multiplicity)
    overlap weight grids."""
    nfd = 4 * sys.fbs
    ids = _ids_np(cut_ids)
    idx = cell_face_index(sys, ids)
    BH, BV = assembled_face_blocks_cl(sys, S_cl)
    BHf = BH.reshape(sys.fbs, sys.fbs, -1)
    BVf = BV.reshape(sys.fbs, sys.fbs, -1)
    sb = torch.stack([BHf[:, :, idx.hb], BVf[:, :, idx.vr],
                      BHf[:, :, idx.ht], BVf[:, :, idx.vl]]).permute(3, 0, 1, 2)
    B = S_cl[:, torch.as_tensor(ids, device=S_cl.device)].reshape(
        nfd, nfd, -1).permute(2, 0, 1)
    return (_patch_blocks_inverse(sys, B, sb, ids),
            *_patch_weights(sys, ids, S_cl.dtype))


def apply_cut_patch_cl(sys: StructuredFaceSystem, idx: CellFaceIndex, Binv,
                       wH, wV, r: GridVecCL) -> GridVecCL:
    """Additive Schwarz over the 4-face patches of the indexed cells
    (``idx`` = cell_face_index of the patch ids, built at setup)."""
    rH, rV = r.H * wH, r.V * wV
    xc = torch.einsum("cij,jc->ic", Binv, _gather_faces(idx, rH, rV))
    H, V = torch.zeros_like(r.H), torch.zeros_like(r.V)
    _scatter_add_faces(idx, H, V, xc.reshape(4, sys.fbs, -1))
    return mask_cl(sys, GridVecCL(H * wH, V * wV))


def make_patch_apply(sys: StructuredFaceSystem, ids, Binv, wH, wV):
    """r -> patch correction, with the index tensors built here, once."""
    idx = cell_face_index(sys, ids)

    def apply_patch(r: GridVecCL) -> GridVecCL:
        return apply_cut_patch_cl(sys, idx, Binv, wH, wV, r)

    return apply_patch


def make_cut_patch_smoother_cl(sys: StructuredFaceSystem, S_cl, cut_ids):
    """Interface-patch additive Schwarz smoother from the full S."""
    return make_patch_apply(sys, cut_ids,
                            *cut_patch_setup_cl(sys, S_cl, cut_ids))
