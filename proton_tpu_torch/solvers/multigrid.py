"""Geometric multigrid preconditioner for the condensed HHO face system
on the generated mesh (JAX counterpart: proton_tpu/solvers/multigrid.py,
the cells-last layout with the Chebyshev smoother, the rediscretized and
the Galerkin hierarchies).

- hierarchy: the same discretization reassembled on meshes N, N/2, ...
  down to ``coarsest`` (for cut problems the coarse level is the cutHHO
  operator on the coarser background mesh);
- transfers: reconstruction-based prolongation. Coarse face dofs -> the
  harmonic cell extension u_T = -A_TT^-1 A_TF u_F -> the potential
  reconstruction of degree k+1 (constant closed by the cell mean) -> the
  L2 trace projection onto the 12 fine sub-faces of the 2x2 refinement.
  On uniform square cells this is 12 fixed [fbs, 4*fbs] matrices per
  level, applied as one dense product over the coarse cell grid. Fine
  faces on the coarse skeleton average the two adjacent reconstructions.
  The restriction is the adjoint, written out as a stencil;
- smoothing: Chebyshev(degree) over the block-Jacobi-preconditioned
  operator (or damped block-Jacobi or Jacobi), then the interface-patch
  smoother on the cut cells;
- coarsest level: the operator made dense by applying it to the columns
  of the identity, then an eigendecomposition pseudo-inverse;
- the Galerkin coarse hierarchy (optional): the exact R A_f P operators,
  built on the host by the pair-operator engine in float64 and applied
  on the device as one conv2d per level plus indexed deviation pairs;
- options the JAX package keeps off by default (measured as no gain
  there): cut-aware transfers (each irregular coarse cell's own
  reconstruction map), operator-smoothed transfers, the Chebyshev
  polynomial on the constant-stencil operator pair (``cheb_ops``), and
  the interface-band deflation added to the V-cycle by the caller.

Everything the V-cycle indexes with (face positions, masks, transfer
matrices, Chebyshev coefficients) is built once in ``build_multigrid``:
``Multigrid.precondition`` copies nothing from the host and reads nothing
back.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ..core import bases, quadrature
from ..core.geometry import cell_geometry
from ..core.mesh import unit_cell_mesh
from ..core.ops import HHODegreeInfo, cho_solve_batched
from ..methods import cells_last as cl
from ..methods import fused_assembly
from ..methods.cells_last import GridVecCL
from ..methods.structured import (StructuredFaceSystem,
                                  make_structured_system)
from ..utils.timing import span


def _transfer_face_projectors(hdi: HHODegreeInfo, h: float, *, device):
    """Trace projections (PH [3, 2, fbs, rbs], PV [2, 3, fbs, rbs]) of the
    degree-(k+1) cell basis of one coarse square cell of side ``h`` onto
    its 12 fine sub-faces: PH[r, c] maps reconstruction coefficients to
    the face-basis L2 projection on the horizontal fine face at height
    r*h/2, column c. The geometric half of the transfer stencils."""
    mesh_c = unit_cell_mesh(h, device=device)
    geom_c = cell_geometry(mesh_c)
    recdeg = hdi.reconstruction_degree
    bar_c, diam_c = geom_c.bar[0], geom_c.diam[0]

    def face_proj(p0, p1):
        # p0 is the sorted-ptid endpoint (left for H faces, bottom for V),
        # the generator's face-basis orientation
        p0 = torch.tensor(p0, dtype=torch.float64, device=device)
        p1 = torch.tensor(p1, dtype=torch.float64, device=device)
        frule = quadrature.face_rule(p0, p1, hdi.face_degree + recdeg)
        fbar = 0.5 * (p0 + p1)
        fphi = bases.eval_face_basis(frule.pts, fbar, fbar - p0,
                                     torch.linalg.vector_norm(p1 - p0),
                                     hdi.face_degree)            # [Q, fbs]
        rphiF = bases.eval_cell_basis(frule.pts, bar_c, diam_c, recdeg)
        Mf = torch.einsum("q,qi,qj->ij", frule.w, fphi, fphi)
        B = torch.einsum("q,qi,qr->ir", frule.w, fphi, rphiF)
        return cho_solve_batched(Mf, B)

    hh = h / 2.0
    PH = torch.stack([
        torch.stack([face_proj((c * hh, r * hh), ((c + 1) * hh, r * hh))
                     for c in range(2)]) for r in range(3)])
    PV = torch.stack([
        torch.stack([face_proj((c * hh, r * hh), (c * hh, (r + 1) * hh))
                     for c in range(3)]) for r in range(2)])
    return PH, PV


def _unit_recmap(hdi: HHODegreeInfo, h: float, *, device):
    """Harmonic-extension reconstruction map [rbs, nfd] of the uniform
    square cell of side ``h``: coarse face dofs -> cell extension
    u_T = -A_TT^-1 A_TF u_F -> full degree-(k+1) reconstruction. Needs the
    reconstruction operator, which the assembly kernel does not write, so
    this one cell goes through the plain tensor version, operator
    included (the two then come from one computation)."""
    mesh_c = unit_cell_mesh(h, device=device)
    geom_c = cell_geometry(mesh_c)
    oper, lc = fused_assembly.reconstruction_and_operator_plain(
        *fused_assembly.pack_inputs(mesh_c, geom_c), hdi.cell_degree,
        hdi.face_degree)
    oper, lc = oper[0], lc[0]
    cbs = bases.cell_basis_size(hdi.cell_degree)
    nfd = 4 * bases.face_basis_size(hdi.face_degree)
    recdeg = hdi.reconstruction_degree
    d = cbs + nfd

    T = -cho_solve_batched(lc[:cbs, :cbs], lc[:cbs, cbs:])      # [cbs, nfd]
    Vmap = torch.cat([T, torch.eye(nfd, dtype=lc.dtype, device=device)])

    # rows 1: are the gradient-reconstruction operator; the constant row
    # closes the cell mean, m @ (Rfull v) = m[:cbs] @ u_T, m_i = int rphi_i
    rule = quadrature.cell_rule(mesh_c, geom_c, recdeg)
    rphi = bases.eval_cell_basis(rule.pts, geom_c.bar[:, None, :],
                                 geom_c.diam[:, None], recdeg)
    m = torch.einsum("cq,cqi->ci", rule.w, rphi)[0]               # [rbs]
    Icbs = torch.eye(cbs, d, dtype=lc.dtype, device=device)
    r0 = (m[:cbs] @ Icbs - m[1:] @ oper) / m[0]                   # [d]
    return torch.cat([r0[None, :], oper]) @ Vmap                  # [rbs, nfd]


def _transfer_slot_matrices(hdi: HHODegreeInfo, h: float, dtype, *, device):
    """The 12 fine-face transfer matrices [fbs, nfd] of one coarse square
    cell of side ``h`` and its 2x2 refinement, as (MH [3, 2, fbs, nfd],
    MV [2, 3, fbs, nfd]): MH[r, c] is the horizontal fine face at height
    r*h/2 and column c, MV[r, c] the vertical fine face at abscissa c*h/2
    and row r. Not h-invariant (the stabilization scales as 1/h against
    the O(1) reconstruction term): computed per level."""
    PH, PV = _transfer_face_projectors(hdi, h, device=device)
    recmap = _unit_recmap(hdi, h, device=device)
    return (PH @ recmap).to(dtype), (PV @ recmap).to(dtype)


def _weighted_flat(MH, MV):
    """The transfer matrices as [6*fbs, nfd] products (or the trace
    projectors as [6*fbs, rbs]), rows ordered (r, c, f), with the 0.5
    averaging weight of the coarse-skeleton faces (H rows r = 0, 2; V
    columns c = 0, 2) folded in. Halving is exact, so this equals
    averaging the two adjacent reconstructions afterwards."""
    wH = MH.new_tensor([0.5, 1.0, 0.5])[:, None, None, None]
    wV = MV.new_tensor([0.5, 1.0, 0.5])[None, :, None, None]
    nfd = MH.shape[-1]
    return (MH * wH).reshape(-1, nfd), (MV * wV).reshape(-1, nfd)


def _check_refinement(sys_f, sys_c) -> None:
    if sys_f.Nx != 2 * sys_c.Nx or sys_f.Ny != 2 * sys_c.Ny:
        raise ValueError("the fine grid must be the 2x2 refinement of the "
                         "coarse grid")


def _cut_correction(sys_c: StructuredFaceSystem, corr, dtype):
    """The cut-aware transfer correction ``corr`` = (ids, drec, PH, PV) on
    the device: (ids [Ci], drec [rbs, nfd, Ci], PHV [12*fbs, rbs] (the 12
    fine-slot trace projections, H slots (r, c) then V slots, rows
    (slot, f), skeleton slots at the 0.5 averaging weight), the fine H
    and V flat positions [6*Ci] of each irregular cell's slots), or None
    without irregular cells. Two irregular cells that share a face share
    its fine slots: those positions repeat."""
    if corr is None:
        return None
    ids, drec, PH, PV = corr
    ids = np.asarray(ids, dtype=np.int64)
    if len(ids) == 0:
        return None
    dev = sys_c.freeH.device
    Nxc = sys_c.Nx
    jj, ii = ids // Nxc, ids % Nxc
    rbs = PH.shape[-1]
    drec = torch.as_tensor(drec, device=dev).to(dtype)
    if drec.shape[1] != len(ids):
        raise ValueError(f"drec has {drec.shape[1]} columns for {len(ids)} "
                         "irregular cells")
    PHV = torch.cat(_weighted_flat(PH, PV)).to(dev, dtype)
    # fine H slot (r, c) of coarse cell (J, I): row 2J + r, column 2I + c
    # of a [2Nyc + 1, 2Nxc] grid; V slot (r, c): row 2J + r, column 2I + c
    # of [2Nyc, 2Nxc + 1]
    hpos = np.stack([(2 * jj + r) * (2 * Nxc) + 2 * ii + c
                     for r in range(3) for c in range(2)])
    vpos = np.stack([(2 * jj + r) * (2 * Nxc + 1) + 2 * ii + c
                     for r in range(2) for c in range(3)])
    return (torch.as_tensor(ids, device=dev),
            drec.reshape(rbs, -1, len(ids)), PHV,
            torch.as_tensor(hpos.reshape(-1), device=dev),
            torch.as_tensor(vpos.reshape(-1), device=dev))


def make_reconstruction_prolongation_cl(sys_f: StructuredFaceSystem,
                                        sys_c: StructuredFaceSystem,
                                        hdi: HHODegreeInfo, h_coarse: float,
                                        dtype=torch.float64, mats=None,
                                        corr=None):
    """Reconstruction-based coarse -> fine transfer on GridVecCL grids.
    ``mats``: precomputed (MH, MV) of _transfer_slot_matrices.

    ``corr``: the cut-aware correction (ids, drec, PH, PV): the coarse
    irregular cell ids (sorted), their reconstruction-map deviations drec
    [rbs*nfd, Ci] (each cell's own Nitsche harmonic-extension
    reconstruction minus the uniform one, row r*nfd + n,
    cut/fictdom_structured._level_recdev) and the trace projectors of
    _transfer_face_projectors. The value at each of the 12 fine faces of
    an irregular coarse cell gains P_slot @ (drec_i @ xl_i), skeleton
    slots at the 0.5 averaging weight. Two cells that share a face both
    add to its fine slots (accumulated, as the JAX package's .at[].add)."""
    fbs = sys_f.fbs
    _check_refinement(sys_f, sys_c)
    MH, MV = mats if mats is not None else _transfer_slot_matrices(
        hdi, h_coarse, dtype, device=sys_f.freeH.device)
    AH, AV = _weighted_flat(MH, MV)
    Nyc, Nxc = sys_c.Ny, sys_c.Nx
    freeH, freeV = sys_f.freeH[None], sys_f.freeV[None]
    cc = _cut_correction(sys_c, corr, MH.dtype)

    def prolong(xc: GridVecCL) -> GridVecCL:
        xl = cl.grid_gather_cl(sys_c, xc)                   # [nfd, Cc]
        fh = (AH @ xl).reshape(3, 2, fbs, Nyc, Nxc)
        fv = (AV @ xl).reshape(2, 3, fbs, Nyc, Nxc)

        def cols2(r):   # the two column slots of H row r, interleaved
            return fh[r].permute(1, 2, 3, 0).reshape(fbs, Nyc, 2 * Nxc)

        H = xl.new_zeros((fbs, 2 * Nyc + 1, 2 * Nxc))
        H[:, 0:-1:2] = cols2(0)
        H[:, 2::2] += cols2(2)
        H[:, 1::2] = cols2(1)

        def rows2(c):   # the two row slots of V column c, interleaved
            return fv[:, c].permute(1, 2, 0, 3).reshape(fbs, 2 * Nyc, Nxc)

        V = xl.new_zeros((fbs, 2 * Nyc, 2 * Nxc + 1))
        V[:, :, 0:-1:2] = rows2(0)
        V[:, :, 2::2] += rows2(2)
        V[:, :, 1::2] = rows2(1)
        if cc is not None:
            ids, drec, PHV, hpos, vpos = cc
            dv = torch.einsum("rni,ni->ri", drec, xl[:, ids])   # [rbs, Ci]
            add = (PHV @ dv).reshape(12, fbs, -1)           # [slot, f, Ci]
            H.view(fbs, -1).index_add_(
                1, hpos, add[:6].permute(1, 0, 2).reshape(fbs, -1))
            V.view(fbs, -1).index_add_(
                1, vpos, add[6:].permute(1, 0, 2).reshape(fbs, -1))
        return GridVecCL(H * freeH, V * freeV)

    return prolong


def make_reconstruction_restriction_cl(sys_f: StructuredFaceSystem,
                                       sys_c: StructuredFaceSystem,
                                       hdi: HHODegreeInfo, h_coarse: float,
                                       dtype=torch.float64, mats=None,
                                       corr=None):
    """Adjoint of make_reconstruction_prolongation_cl as a stencil: per
    coarse cell, gather its 12 fine-face values by strided slicing
    (skeleton faces carry the 0.5 averaging weight), contract with the
    transfer matrices transposed, and accumulate the cell contributions
    onto the coarse grids. ``corr``: the prolongation's cut-aware
    correction, whose exact adjoint is added on the irregular cells."""
    fbs = sys_f.fbs
    _check_refinement(sys_f, sys_c)
    MH, MV = mats if mats is not None else _transfer_slot_matrices(
        hdi, h_coarse, dtype, device=sys_f.freeH.device)
    AH, AV = _weighted_flat(MH, MV)
    AHt, AVt = AH.T.contiguous(), AV.T.contiguous()
    Nyc, Nxc = sys_c.Ny, sys_c.Nx
    freeH, freeV = sys_f.freeH[None], sys_f.freeV[None]
    cc = _cut_correction(sys_c, corr, MH.dtype)
    if cc is not None:
        PHVt = cc[2].T.contiguous()

    def restrict(rf: GridVecCL) -> GridVecCL:
        # adjoint of the prolongation's final masking: mask the input
        H, V = rf.H * freeH, rf.V * freeV
        # coarse cell (J, I) sees fine H rows 2J (bottom), 2J+1 (mid),
        # 2J+2 (top); columns (2I, 2I+1) pair contiguously
        re = H[:, 0::2].reshape(fbs, Nyc + 1, Nxc, 2)
        ro = H[:, 1::2].reshape(fbs, Nyc, Nxc, 2)
        fh = torch.stack([re[:, :-1], ro, re[:, 1:]])    # [3r, f, Y, X, 2c]
        fh = fh.permute(0, 4, 1, 2, 3).reshape(6 * fbs, Nyc * Nxc)
        # fine V columns 2I (left), 2I+1 (mid), 2I+2 (right); rows
        # (2J, 2J+1) pair contiguously
        ce = V[:, :, 0::2].reshape(fbs, Nyc, 2, Nxc + 1)
        co = V[:, :, 1::2].reshape(fbs, Nyc, 2, Nxc)
        fv = torch.stack([ce[..., :-1], co, ce[..., 1:]])  # [3c, f, Y, 2r, X]
        fv = fv.permute(3, 0, 1, 2, 4).reshape(6 * fbs, Nyc * Nxc)
        contrib = torch.addmm(AHt @ fh, AVt, fv)          # [nfd, Cc]
        if cc is not None:
            ids, drec, _, hpos, vpos = cc
            slots = torch.cat([                            # [slot, f, Ci]
                H.reshape(fbs, -1)[:, hpos].reshape(fbs, 6, -1),
                V.reshape(fbs, -1)[:, vpos].reshape(fbs, 6, -1)],
                dim=1).permute(1, 0, 2).reshape(12 * fbs, -1)
            s = PHVt @ slots                               # [rbs, Ci]
            contrib.index_add_(1, ids, torch.einsum("rni,ri->ni", drec, s))
        return cl.grid_scatter_cl(sys_c, contrib)

    return restrict


# ---------------------------------------------------------------------------
# Grid-vector arithmetic
# ---------------------------------------------------------------------------


def _sub(a: GridVecCL, b: GridVecCL) -> GridVecCL:
    return GridVecCL(a.H - b.H, a.V - b.V)


def _add(a: GridVecCL, b: GridVecCL) -> GridVecCL:
    return GridVecCL(a.H + b.H, a.V + b.V)


def _axpby(a: float, x: GridVecCL, b: float, y: GridVecCL) -> GridVecCL:
    return GridVecCL(torch.add(a * x.H, y.H, alpha=b),
                     torch.add(a * x.V, y.V, alpha=b))


def _zeros_grid(sys: StructuredFaceSystem, dtype) -> GridVecCL:
    dev = sys.freeH.device
    return GridVecCL(
        torch.zeros((sys.fbs, sys.Ny + 1, sys.Nx), dtype=dtype, device=dev),
        torch.zeros((sys.fbs, sys.Ny, sys.Nx + 1), dtype=dtype, device=dev))


def estimate_lambda_max(apply_A, precond, like: GridVecCL, iters: int = 12,
                        safety: float = 1.05) -> float:
    """Power iteration on M^-1 A from the all-ones vector: the Chebyshev
    smoother's eigenvalue estimate, read back once as a Python float."""
    v = GridVecCL(torch.ones_like(like.H), torch.ones_like(like.V))
    lam = 1.0
    for _ in range(iters):
        w = precond(apply_A(v))
        lam = float(torch.sqrt(torch.sum(w.H * w.H) + torch.sum(w.V * w.V)))
        v = GridVecCL(w.H / lam, w.V / lam)
    return lam * safety


def make_chebyshev_smoother(apply_A, precond, lam_max: float,
                            degree: int = 4, alpha: float = 4.0):
    """Chebyshev(degree) polynomial smoother on the upper part
    [lam_max/alpha, lam_max] of the M^-1 A spectrum (Adams et al.,
    'Parallel multigrid smoothing'): r -> accumulated correction. A fixed
    polynomial in M^-1 A applied to M^-1, hence symmetric positive
    definite. Its coefficients are Python floats fixed here."""
    lmin = lam_max / alpha
    theta = 0.5 * (lam_max + lmin)
    delta = 0.5 * (lam_max - lmin)
    sigma = theta / delta
    coeffs, rho = [], 1.0 / sigma
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        coeffs.append((rho_new * rho, 2.0 * rho_new / delta))
        rho = rho_new

    def smooth(r: GridVecCL) -> GridVecCL:
        z = precond(r)
        d = GridVecCL(z.H / theta, z.V / theta)
        x = d
        for c_d, c_z in coeffs:
            r = _sub(r, apply_A(d))
            d = _axpby(c_d, d, c_z, precond(r))
            x = _add(x, d)
        return x

    return smooth


def _mg_sizes(N: int, coarsest: int):
    sizes = []
    n = N
    while n >= coarsest:
        sizes.append(n)
        if n == coarsest:
            break
        n //= 2
    return sizes


# ---------------------------------------------------------------------------
# The Galerkin coarse hierarchy: the pair-operator coarsening engine
#
# The rediscretized coarse operator of a cut problem is not R A_f P: the
# circle cuts the coarse cells at other offsets, so on band-local modes it
# is softer than the Galerkin product and the coarse correction overshoots.
# The engine builds the exact Galerkin operators on the host, in float64.
#
# A pair operator (PairOp) is a translation-invariant cell-pair stencil
# {direction (dy, dx): B [nfd, nfd]} plus a sparse list of
# (row cell, col cell, block) deviations: the cut and displaced cells, the
# domain-boundary masking and their images. One coarsening step is the
# exact triple product under the reconstruction-based transfers: a fine
# child couples its parent and the parent's vertical and horizontal
# neighbours through the per-cell restriction M_loc of the 12 transfer
# stencils (skeleton faces at the 0.5 averaging weight). The stencil stays
# within 5x5 cells and the deviations stay O(band + boundary) per level.
# ---------------------------------------------------------------------------


def _mloc_cells(MH, MV, py: int, px: int):
    """Per-cell prolongation restriction of the fine child at (py, px) in
    its coarse parent: [(coarse cell offset (dJ, dI), M [nfd fine, nfd
    coarse])] over the parent, its vertical and its horizontal
    neighbour. Fine slot order (bottom, right, top, left), as
    grid_gather_cl."""
    fbs = MH.shape[2]
    nfd = 4 * fbs
    b, r, t, l = 0, fbs, 2 * fbs, 3 * fbs
    P, V, H = (np.zeros((nfd, nfd)) for _ in range(3))
    if py == 0:    # bottom fine face on the coarse skeleton
        P[b:b + fbs] = 0.5 * MH[0, px]
        V[b:b + fbs] = 0.5 * MH[2, px]
        P[t:t + fbs] = MH[1, px]
    else:          # top fine face on the coarse skeleton
        P[b:b + fbs] = MH[1, px]
        P[t:t + fbs] = 0.5 * MH[2, px]
        V[t:t + fbs] = 0.5 * MH[0, px]
    if px == 0:    # left fine face on the coarse skeleton
        P[l:l + fbs] = 0.5 * MV[py, 0]
        H[l:l + fbs] = 0.5 * MV[py, 2]
        P[r:r + fbs] = MV[py, 1]
    else:          # right fine face on the coarse skeleton
        P[l:l + fbs] = MV[py, 1]
        P[r:r + fbs] = 0.5 * MV[py, 2]
        H[r:r + fbs] = 0.5 * MV[py, 0]
    return [((0, 0), P), ((2 * py - 1, 0), V), ((0, 2 * px - 1), H)]


def finest_pair_op(nf: int, S_u, dS, irr):
    """PairOp (const, (rows, cols, blocks)) of the finest level: the unit
    cell at direction (0, 0) plus the symmetrized irregular deviations dS
    [nfd*nfd, Ci] at their cells. The domain-boundary masking is added by
    mask_pair_op before each coarsening step."""
    S_u = _host64(S_u)
    nfd = S_u.shape[0]
    irr = np.asarray(irr, dtype=np.int64)
    dSm = np.moveaxis(_host64(dS).reshape(nfd, nfd, len(irr)), -1, 0)
    dSm = 0.5 * (dSm + np.swapaxes(dSm, 1, 2))
    return {(0, 0): S_u}, (irr, irr.copy(), dSm)


def _host64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def _frozen_slot_mask(n: int, cells, nfd: int):
    """[len(cells), nfd] multiplier zeroing the slots of domain-edge faces
    (off-grid coordinates read 0 too: their faces do not exist)."""
    fbs = nfd // 4
    jj, ii = cells // n, cells % n
    m = np.ones((len(cells), nfd))
    m[jj <= 0, 0:fbs] = 0.0
    m[ii >= n - 1, fbs:2 * fbs] = 0.0
    m[jj >= n - 1, 2 * fbs:3 * fbs] = 0.0
    m[ii <= 0, 3 * fbs:4 * fbs] = 0.0
    return m


def mask_pair_op(n: int, const: dict, corr):
    """The deviation list with the level's domain-boundary masking folded
    in: const + corr' = Z (const + corr) Z, Z zeroing the frozen face
    dofs (the energy form of the masked apply and the masked transfers).
    Needed before every coarsening step."""
    rows, cols = np.asarray(corr[0]), np.asarray(corr[1])
    blocks = np.asarray(corr[2], np.float64)
    nfd = next(iter(const.values())).shape[0]
    mr = _frozen_slot_mask(n, rows, nfd)
    mc = _frozen_slot_mask(n, cols, nfd)
    out_r, out_c = [rows], [cols]
    out_b = [blocks * mr[:, :, None] * mc[:, None, :]]

    # Z const Z - const on the pairs that touch the edge
    w = max(max(abs(dy), abs(dx)) for dy, dx in const) + 1
    cells = np.arange(n * n)
    jj, ii = cells // n, cells % n
    fc = cells[(jj < w) | (jj >= n - w) | (ii < w) | (ii >= n - w)]
    fj, fi = fc // n, fc % n
    for (dy, dx), B in const.items():
        cj, ci = fj + dy, fi + dx
        ok = (cj >= 0) & (cj < n) & (ci >= 0) & (ci < n)
        if not ok.any():
            continue
        rcell, ccell = fc[ok], (cj * n + ci)[ok]
        m1 = _frozen_slot_mask(n, rcell, nfd)
        m2 = _frozen_slot_mask(n, ccell, nfd)
        delta = B[None] * (m1[:, :, None] * m2[:, None, :]) - B[None]
        nz = np.abs(delta).max(axis=(1, 2)) > 0
        if nz.any():
            out_r.append(rcell[nz])
            out_c.append(ccell[nz])
            out_b.append(delta[nz])
    return _aggregate_pairs(np.concatenate(out_r), np.concatenate(out_c),
                            np.concatenate(out_b, axis=0), n)


def _aggregate_pairs(rows, cols, blocks, n):
    """Sum the blocks of repeated (row, col) pairs: sorted unique pairs.
    Each sum runs in input order (a stable sort, then reduceat), as an
    unbuffered np.add.at would."""
    key = rows.astype(np.int64) * (n * n) + cols.astype(np.int64)
    order = np.argsort(key, kind="stable")
    key = key[order]
    starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    uk = key[starts]
    agg = np.add.reduceat(np.asarray(blocks)[order], starts, axis=0)
    return uk // (n * n), uk % (n * n), agg


def galerkin_coarsen_pair_op(hdi: HHODegreeInfo, nc: int, const_f: dict,
                             corr_f, domain: float = 1.0):
    """One exact Galerkin coarsening step of a PairOp, fine nf = 2 nc ->
    coarse nc, under the reconstruction-based transfers (their slot
    matrices from _transfer_slot_matrices, on the CPU in float64).
    Returns (const_c, (rows, cols, blocks))."""
    MH, MV = (m.numpy() for m in _transfer_slot_matrices(
        hdi, domain / nc, torch.float64, device=torch.device("cpu")))
    nfd = 4 * MH.shape[2]
    nf = 2 * nc
    mlocs = {(py, px): _mloc_cells(MH, MV, py, px)
             for py in (0, 1) for px in (0, 1)}

    # the translation-invariant part
    const_c = {}
    for (py, px), ml_a in mlocs.items():
        for (dy, dx), B in const_f.items():
            qy, qx = (py + dy) % 2, (px + dx) % 2
            dPy, dPx = (py + dy) // 2, (px + dx) // 2
            for ca, Ma in ml_a:
                for cb, Mb in mlocs[(qy, qx)]:
                    d = (dPy + cb[0] - ca[0], dPx + cb[1] - ca[1])
                    const_c[d] = const_c.get(d, 0.0) + Ma.T @ B @ Mb

    # the deviations
    out_r, out_c, out_b = [], [], []

    def coarsen_pairs(ja, ia, jb, ib, blocks_f):
        """Triple product of explicit fine pairs (coordinates may be off
        the grid); coarse row or column cells off the grid are dropped,
        as the masked transfers drop them."""
        pa_y, pa_x, pb_y, pb_x = ja % 2, ia % 2, jb % 2, ib % 2
        Pa_j, Pa_i, Pb_j, Pb_i = ja // 2, ia // 2, jb // 2, ib // 2
        for (py, px), ml_a in mlocs.items():
            for (qy, qx), ml_b in mlocs.items():
                sel = (pa_y == py) & (pa_x == px) & (pb_y == qy) & \
                    (pb_x == qx)
                if not sel.any():
                    continue
                Bsel = blocks_f[sel]
                for ca, Ma in ml_a:
                    rj, ri = Pa_j[sel] + ca[0], Pa_i[sel] + ca[1]
                    va = (rj >= 0) & (rj < nc) & (ri >= 0) & (ri < nc)
                    for cb, Mb in ml_b:
                        cj, ci = Pb_j[sel] + cb[0], Pb_i[sel] + cb[1]
                        ok = va & (cj >= 0) & (cj < nc) & (ci >= 0) & \
                            (ci < nc)
                        if not ok.any():
                            continue
                        out_r.append((rj * nc + ri)[ok])
                        out_c.append((cj * nc + ci)[ok])
                        out_b.append(Ma.T @ Bsel[ok] @ Mb)

    rows_f, cols_f = np.asarray(corr_f[0]), np.asarray(corr_f[1])
    coarsen_pairs(rows_f // nf, rows_f % nf, cols_f // nf, cols_f % nf,
                  np.asarray(corr_f[2], np.float64))

    # phantom pairs: near the edge the translation-invariant stencil
    # includes fine pairs (fa, fb) with fa or fb off the grid while the
    # coarse row and column cells are on it; emit their negatives
    w = max(max(abs(dy), abs(dx)) for dy, dx in const_f) + 2
    coords = np.arange(-1, nf + 1)
    JA, IA = np.meshgrid(coords, coords, indexing="ij")
    frame = (JA < w) | (JA >= nf - w) | (IA < w) | (IA >= nf - w)
    ja0, ia0 = JA[frame].ravel(), IA[frame].ravel()
    for (dy, dx), B in const_f.items():
        jb0, ib0 = ja0 + dy, ia0 + dx
        a_on = (ja0 >= 0) & (ja0 < nf) & (ia0 >= 0) & (ia0 < nf)
        b_on = (jb0 >= 0) & (jb0 < nf) & (ib0 >= 0) & (ib0 < nf)
        bad = ~(a_on & b_on)
        if bad.any():
            coarsen_pairs(ja0[bad], ia0[bad], jb0[bad], ib0[bad],
                          np.broadcast_to(-B, (int(bad.sum()),) + B.shape))

    if not out_r:
        return const_c, (np.zeros(0, np.int64), np.zeros(0, np.int64),
                         np.zeros((0, nfd, nfd)))
    return const_c, _aggregate_pairs(np.concatenate(out_r),
                                     np.concatenate(out_c),
                                     np.concatenate(out_b, axis=0), nc)


class GalerkinLevel(NamedTuple):
    """One coarse level's Galerkin operator and its patch blocks, as
    tensors on the solve's device. The coarsest level also carries the
    host float64 eigh pseudo-inverse factor of its dense operator."""

    kernel: torch.Tensor   # [nfd, nfd, k, k] constant stencil, OIHW
    rows: torch.Tensor     # [P] deviation pair row cells
    cols: torch.Tensor     # [P] deviation pair column cells
    blocks: torch.Tensor   # [P, nfd, nfd]
    cells: torch.Tensor    # [m] sorted cells whose 4-face block deviates
    cblocks: torch.Tensor  # [m, nfd, nfd] their exact 4-face restrictions
    Bu_cell: torch.Tensor  # [nfd, nfd] the uniform interior restriction
    coarse_Q: Optional[torch.Tensor] = None
    coarse_winv: Optional[torch.Tensor] = None


def pair_op_diag_data(nc: int, const: dict, corr, fbs: int):
    """The level's assembled face-diagonal data: the uniform interior H
    and V face blocks BHu, BVu [fbs, fbs] and the per-face deltas
    ((hj, hi, dBH), (vj, vi, dBV)) at the free faces the deviations
    touch. No solve reads them; kept as the JAX package's diagnostic."""
    nfd = 4 * fbs
    b, r, t, l = (slice(0, fbs), slice(fbs, 2 * fbs),
                  slice(2 * fbs, 3 * fbs), slice(3 * fbs, 4 * fbs))
    C00 = const[(0, 0)]
    C10 = const.get((1, 0), np.zeros((nfd, nfd)))
    C01 = const.get((0, 1), np.zeros((nfd, nfd)))
    BHu = C00[t, t] + C00[b, b] + C10[t, b] + C10[t, b].T
    BVu = C00[l, l] + C00[r, r] + C01[r, l] + C01[r, l].T

    rows, cols, blocks = (np.asarray(a) for a in corr)
    ja, ia, jb, ib = rows // nc, rows % nc, cols // nc, cols % nc
    hkeys, hvals, vkeys, vvals = [], [], [], []
    diag = rows == cols
    if diag.any():
        jj, ii, B = ja[diag], ia[diag], blocks[diag]
        hkeys += [jj * nc + ii, (jj + 1) * nc + ii]
        hvals += [B[:, b, b], B[:, t, t]]
        vkeys += [jj * (nc + 1) + ii, jj * (nc + 1) + ii + 1]
        vvals += [B[:, l, l], B[:, r, r]]
    for sel, key, blk in (
            ((jb == ja + 1) & (ib == ia), lambda j, i: (j + 1) * nc + i,
             (t, b)),
            ((jb == ja - 1) & (ib == ia), lambda j, i: j * nc + i, (b, t))):
        if sel.any():
            hkeys.append(key(ja[sel], ia[sel]))
            hvals.append(blocks[sel][:, blk[0], blk[1]])
    for sel, key, blk in (
            ((ib == ia + 1) & (jb == ja),
             lambda j, i: j * (nc + 1) + i + 1, (r, l)),
            ((ib == ia - 1) & (jb == ja), lambda j, i: j * (nc + 1) + i,
             (l, r))):
        if sel.any():
            vkeys.append(key(ja[sel], ia[sel]))
            vvals.append(blocks[sel][:, blk[0], blk[1]])

    def agg(keys, vals, W, frozen):
        if not keys:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros((0, fbs, fbs)))
        k = np.concatenate(keys)
        v = np.concatenate(vals, axis=0)
        ok = ~frozen(k)
        uk, inv = np.unique(k[ok], return_inverse=True)
        out = np.zeros((len(uk), fbs, fbs))
        np.add.at(out, inv.reshape(-1), v[ok])
        return uk // W, uk % W, out

    fH = agg(hkeys, hvals, nc, lambda k: (k // nc == 0) | (k // nc == nc))
    fV = agg(vkeys, vvals, nc + 1,
             lambda k: (k % (nc + 1) == 0) | (k % (nc + 1) == nc))
    return BHu, BVu, fH, fV


def pair_op_cell_face_blocks(nc: int, const: dict, corr, fbs: int):
    """Exact 4-face restrictions of the pair operator: the uniform
    interior cell's block B_u [nfd, nfd] and (cells, blocks) for every
    cell whose restriction deviates (within one cell of a deviation pair
    or of the domain edge). These are the local solves of the Galerkin
    patch smoother. Vectorized over the cells: for each slot pair, each
    owner pair adds its constant block and its deviation block (looked up
    among the sorted pair keys)."""
    nfd = 4 * fbs
    rows, cols, blocks = (np.asarray(a) for a in corr)
    keys = rows.astype(np.int64) * (nc * nc) + cols
    order = np.argsort(keys, kind="stable")
    keys, blocks = keys[order], blocks[order]
    # the owners of slot s of a cell: itself and its neighbour off[s]
    # through slot opp[s]
    off = ((-1, 0), (0, 1), (1, 0), (0, -1))
    opp = (2, 3, 0, 1)

    def on_grid(j, i):
        return (j >= 0) & (j < nc) & (i >= 0) & (i < nc)

    def restrictions(cells):
        j, i = cells // nc, cells % nc
        B = np.zeros((len(cells), nfd, nfd))
        for s1 in range(4):
            for s2 in range(4):
                acc = B[:, s1 * fbs:(s1 + 1) * fbs, s2 * fbs:(s2 + 1) * fbs]
                for da, sa in (((0, 0), s1), (off[s1], opp[s1])):
                    ja, ia = j + da[0], i + da[1]
                    for db, sb in (((0, 0), s2), (off[s2], opp[s2])):
                        jb, ib = j + db[0], i + db[1]
                        ok = on_grid(ja, ia) & on_grid(jb, ib)
                        if not ok.any():
                            continue
                        blk = const.get((db[0] - da[0], db[1] - da[1]))
                        if blk is not None:
                            acc[ok] += blk[sa * fbs:(sa + 1) * fbs,
                                           sb * fbs:(sb + 1) * fbs]
                        if len(keys):
                            k = (ja * nc + ia) * (nc * nc) + jb * nc + ib
                            pos = np.minimum(np.searchsorted(keys, k),
                                             len(keys) - 1)
                            hit = ok & (keys[pos] == k)
                            acc[hit] += blocks[pos[hit]][
                                :, sa * fbs:(sa + 1) * fbs,
                                sb * fbs:(sb + 1) * fbs]
        return B

    # the deviating cells: the 3 x 3 neighbourhoods of the pairs' cells,
    # and the edge frame
    pc = np.unique(np.concatenate([rows, cols])).astype(np.int64)
    steps = [(dj, di) for dj in (-1, 0, 1) for di in (-1, 0, 1)]
    near = [(pc // nc + dj) * nc + pc % nc + di for dj, di in steps]
    ok = [on_grid(pc // nc + dj, pc % nc + di) for dj, di in steps]
    allc = np.arange(nc * nc)
    jj, ii = allc // nc, allc % nc
    frame = allc[(jj == 0) | (jj == nc - 1) | (ii == 0) | (ii == nc - 1)]
    cells = np.unique(np.concatenate([c[m] for c, m in zip(near, ok)] +
                                     [frame]))
    # the uniform block from the first interior cell that does not
    # deviate; on a grid where all do, the centre cell's
    interior = allc[(jj >= 1) & (jj <= nc - 2) & (ii >= 1) & (ii <= nc - 2)]
    free = np.setdiff1d(interior, cells)
    ref = free[:1] if len(free) else np.array([(nc // 2) * nc + nc // 2])
    B_u = restrictions(ref)[0]
    out = restrictions(cells) if len(cells) else np.zeros((0, nfd, nfd))
    return B_u, cells, out


def pair_op_kernel(const: dict, dtype=np.float64):
    """The constant stencil as a conv kernel [nfd out, nfd in, k, k] (odd
    k, centre = direction (0, 0)): out[s, J, I] = sum K[s, s2, c+dy, c+dx]
    xl[s2, J+dy, I+dx], a cross-correlation; zero padding drops the
    off-grid pairs exactly."""
    rmax = max(max(abs(dy), abs(dx)) for dy, dx in const)
    nfd = next(iter(const.values())).shape[0]
    K = np.zeros((nfd, nfd, 2 * rmax + 1, 2 * rmax + 1), dtype)
    for (dy, dx), B in const.items():
        K[:, :, rmax + dy, rmax + dx] = B
    return K


def pair_op_dense(nc: int, const: dict, corr, fbs: int):
    """The pair operator made dense on the nc x nc grid's face dofs, in
    the flat order of _flatten ([H (m, j, i) | V (m, j, i)]); frozen rows
    and columns get the identity."""
    nH = fbs * (nc + 1) * nc
    ntot = nH + fbs * nc * (nc + 1)
    A = np.zeros((ntot, ntot))
    m = np.arange(fbs)

    def face_dofs(cells, slot):
        """[len, fbs] flat dofs of slot ``slot`` of each cell, -1 on
        frozen (domain-edge) faces."""
        j, i = cells // nc, cells % nc
        fj, fi = (j + (slot == 2), i + (slot == 1))
        if slot in (0, 2):
            d = m[None, :] * (nc + 1) * nc + (fj * nc + fi)[:, None]
            bad = (fj == 0) | (fj == nc)
        else:
            d = nH + m[None, :] * nc * (nc + 1) + \
                (fj * (nc + 1) + fi)[:, None]
            bad = (fi == 0) | (fi == nc)
        d[bad] = -1
        return d

    def add_blocks(ca, cb, B):
        B = np.broadcast_to(B, (len(ca),) + B.shape[-2:])
        for s1 in range(4):
            d1 = face_dofs(ca, s1)
            for s2 in range(4):
                d2 = face_dofs(cb, s2)
                ok = (d1[:, 0] >= 0) & (d2[:, 0] >= 0)
                if ok.any():
                    np.add.at(A, (d1[ok][:, :, None], d2[ok][:, None, :]),
                              B[ok][:, s1 * fbs:(s1 + 1) * fbs,
                                    s2 * fbs:(s2 + 1) * fbs])

    cells = np.arange(nc * nc)
    jj, ii = cells // nc, cells % nc
    for (dy, dx), B in const.items():
        ok = (jj + dy >= 0) & (jj + dy < nc) & (ii + dx >= 0) & \
            (ii + dx < nc)
        add_blocks(cells[ok], cells[ok] + dy * nc + dx, np.asarray(B))
    rows, cols, blocks = (np.asarray(a) for a in corr)
    if len(rows):
        add_blocks(rows, cols, blocks)
    frozen = np.abs(A).sum(0) + np.abs(A).sum(1) == 0
    A[frozen, frozen] = 1.0
    return A


def pinv_factor_host(A):
    """(Q, winv) of the eigh pseudo-inverse of a dense symmetric float64
    operator on the host, cutoff 50 n eps max|w|: the Galerkin coarsest
    operator is singular (the composed masked prolongation has a small
    kernel), and restricted residuals are orthogonal to that kernel."""
    w, Q = np.linalg.eigh(0.5 * (A + A.T))
    tol = 50.0 * len(w) * np.finfo(np.float64).eps * np.abs(w).max()
    return Q, np.where(w > tol, 1.0 / np.where(w > tol, w, 1.0), 0.0)


# ---------------------------------------------------------------------------
# The Galerkin operator and its patch blocks on the device
# ---------------------------------------------------------------------------


def make_galerkin_operator_cl(sys: StructuredFaceSystem, kernel, rows=None,
                              cols=None, blocks=None):
    """Matrix-free pair-operator apply on GridVecCL grids: the cells' slot
    planes [nfd, Ny, Nx], one conv2d for the constant stencil (a
    cross-correlation with zero padding), the deviation pairs as a
    gather, a batched product and an accumulating index_add_ (rows
    repeat), the face scatter, then the masks and the frozen identity
    (the contract of make_structured_operator_cl)."""
    nfd, Ny, Nx = 4 * sys.fbs, sys.Ny, sys.Nx
    pad = (kernel.shape[-1] - 1) // 2
    has_pairs = rows is not None and rows.shape[0] > 0
    freeH, freeV = sys.freeH[None], sys.freeV[None]

    def apply_S(x: GridVecCL) -> GridVecCL:
        xl = cl.grid_gather_cl(sys, GridVecCL(x.H * freeH, x.V * freeV))
        with span("galerkin.conv"):
            c = torch.nn.functional.conv2d(
                xl.reshape(1, nfd, Ny, Nx), kernel,
                padding=pad).reshape(nfd, Ny * Nx)
        if has_pairs:
            with span("galerkin.pairs"):
                yp = torch.bmm(blocks, xl[:, cols].T[:, :, None])[:, :, 0]
                c.index_add_(1, rows, yp.T)
        y = cl.grid_scatter_cl(sys, c)
        return GridVecCL(torch.where(freeH, y.H, x.H),
                         torch.where(freeV, y.V, x.V))

    return apply_S


def galerkin_patch_setup(sys: StructuredFaceSystem, gal: GalerkinLevel,
                         patch_ids, dtype):
    """uniform_patch_setup_lean's Galerkin twin, (Binv, wH, wV): each patch
    cell's local block is the exact 4-face restriction of the Galerkin
    operator (pair_op_cell_face_blocks), masked at frozen faces and
    inverted."""
    fbs, Nx = sys.fbs, sys.Nx
    nfd = 4 * fbs
    dev = sys.freeH.device
    pids_np = cl._ids_np(patch_ids)
    pids = torch.as_tensor(pids_np, device=dev)
    B = gal.Bu_cell.to(dtype).expand(len(pids_np), nfd, nfd)
    if gal.cells.shape[0] > 0:
        pos = torch.clamp(torch.searchsorted(gal.cells, pids), 0,
                          gal.cells.shape[0] - 1)
        hit = (gal.cells[pos] == pids)[:, None, None]
        B = torch.where(hit, gal.cblocks.to(dtype)[pos], B)
    jj, ii = pids // Nx, pids % Nx
    free_slot = torch.stack([sys.freeH[jj, ii], sys.freeV[jj, ii + 1],
                             sys.freeH[jj + 1, ii], sys.freeV[jj, ii]], dim=1)
    m = free_slot.repeat_interleave(fbs, dim=1).to(dtype)
    eye = torch.eye(nfd, dtype=dtype, device=dev)
    B = B * (m[:, :, None] * m[:, None, :]) + eye * (1.0 - m)[:, None, :]
    return (torch.linalg.inv(B), *cl._patch_weights(sys, pids_np, dtype))


class MGLevel(NamedTuple):
    sys: StructuredFaceSystem
    apply_S: Callable
    smoothers: tuple       # r -> dx steps; pre-smoothing applies them in
    #                        order, post-smoothing in reverse (keeps the
    #                        V-cycle symmetric)
    prolong: Optional[Callable]    # from the next-coarser level
    restrict: Optional[Callable]   # (both None on the coarsest)


class Multigrid(NamedTuple):
    levels: List[MGLevel]
    coarse_factor: tuple           # (Q, winv) of _coarse_factor
    coarse_shape: tuple
    n_smooth: int
    gamma: int = 1                 # 1: V-cycle; > 1: the coarse problem of
    #                                the top ``gamma_depth`` gaps is solved
    #                                gamma times (W-style re-visits)
    gamma_depth: int = 2

    def precondition(self, r: GridVecCL) -> GridVecCL:
        return _vcycle(self, 0, r)


def _coarse_factor(Ac):
    """Eigendecomposition pseudo-inverse factor (Q, winv) of the dense
    coarsest operator. Only the rounding-level kernel is dropped: the
    cutoff is 100 eps max|w|."""
    As = 0.5 * (Ac + Ac.T)
    w, Q = torch.linalg.eigh(As)
    tol = 100.0 * torch.finfo(Ac.dtype).eps * torch.max(torch.abs(w))
    keep = w > tol
    winv = torch.where(keep, 1.0 / torch.where(keep, w, torch.ones_like(w)),
                       torch.zeros_like(w))
    return Q, winv


def _coarse_solve(fac, rhs):
    """Apply the (Q, winv) factor in the factor's dtype and return the
    result in the rhs dtype: the Galerkin hierarchy's host factor stays
    float64 under a float32 V-cycle, as in the JAX package."""
    Q, winv = fac
    return (Q @ (winv * (Q.T @ rhs.to(Q.dtype)))).to(rhs.dtype)


def _flatten(x: GridVecCL):
    return torch.cat([x.H.reshape(-1), x.V.reshape(-1)])


def _unflatten(v, shapes) -> GridVecCL:
    hshape, vshape = shapes
    n = int(np.prod(hshape))
    return GridVecCL(v[:n].reshape(hshape), v[n:].reshape(vshape))


def _vcycle(mg: Multigrid, lvl: int, b: GridVecCL) -> GridVecCL:
    """The cycle from level ``lvl`` down, each stage a span named by the
    level's n x n cells: mg_smooth_n{n} (pre and post), mg_residual_n{n},
    mg_restrict_n{n}, mg_prolong_n{n} (with the correction's add) and
    mg_coarse_n{n} on the coarsest level."""
    level = mg.levels[lvl]
    n = level.sys.Nx
    if lvl == len(mg.levels) - 1:
        with span(f"mg_coarse_n{n}"):
            return _unflatten(_coarse_solve(mg.coarse_factor, _flatten(b)),
                              mg.coarse_shape)

    def smooth(x, steps):
        # x = None is the zero initial guess: the first residual is b
        with span(f"mg_smooth_n{n}"):
            for _ in range(mg.n_smooth):
                for s in steps:
                    x = s(b) if x is None else \
                        _add(x, s(_sub(b, level.apply_S(x))))
        return x

    x = smooth(None, level.smoothers)
    with span(f"mg_residual_n{n}"):
        r = _sub(b, level.apply_S(x))
    with span(f"mg_restrict_n{n}"):
        rc = level.restrict(r)
    ec = _vcycle(mg, lvl + 1, rc)
    if mg.gamma > 1 and lvl < mg.gamma_depth and \
            lvl + 1 < len(mg.levels) - 1:
        # W-style: re-visit the coarse problem on its residual
        coarse = mg.levels[lvl + 1]
        for _ in range(mg.gamma - 1):
            ec = _add(ec, _vcycle(mg, lvl + 1,
                                  _sub(rc, coarse.apply_S(ec))))
    with span(f"mg_prolong_n{n}"):
        x = _add(x, level.prolong(ec))
    return smooth(x, tuple(reversed(level.smoothers)))


SMOOTHERS = ("chebyshev", "block_jacobi", "jacobi")
CHEB_OPS = ("exact", "mixed", "uniform")


def _cheb_op_pair(sys_n: StructuredFaceSystem, apply_S, base, S_u,
                  cheb_ops: str):
    """(operator, preconditioner) the Chebyshev polynomial is built on.
    'exact': the level's operator and its corrected block-Jacobi base;
    'mixed': the inner matvecs on the pure constant stencil of the unit
    cell, the corrected base kept (it keeps the sliver rows' scaling);
    'uniform': the constant stencil and the uncorrected constant-block
    base. The smoother stays SPD in every mode (a fixed polynomial of an
    SPD pair), and the V-cycle's residuals always use the level's own
    operator. ``S_u`` None (a level without the constant-stencil
    decomposition) is refused for 'mixed' and 'uniform'."""
    if cheb_ops == "exact":
        return apply_S, base
    if S_u is None:
        raise ValueError(f"cheb_ops={cheb_ops!r} needs the constant-stencil "
                         f"decomposition (uniform_per_level) on level "
                         f"{sys_n.Nx}")
    apply_sm = cl.make_uniform_operator_cl(sys_n, S_u)
    if cheb_ops == "mixed":
        return apply_sm, base
    return apply_sm, cl.make_uniform_block_jacobi_cl(
        sys_n, *cl.uniform_block_jacobi_blocks(sys_n, S_u))


def _smooth_transfer_pair(prol, restrict, apply_S, base, lam: float):
    """Operator-smoothed transfers (smoothed-aggregation style):
    P' = (I - omega M^-1 A) P and R' = R (I - omega A M^-1) with
    omega = 4 / (3 lambda_max(M^-1 A)); R' is the exact adjoint of P'
    since A and M are symmetric. One extra operator and base apply per
    transfer."""
    om = 4.0 / (3.0 * lam)

    def prol_s(xc: GridVecCL) -> GridVecCL:
        p = prol(xc)
        return _axpby(1.0, p, -om, base(apply_S(p)))

    def restrict_s(rf: GridVecCL) -> GridVecCL:
        return restrict(_axpby(1.0, rf, -om, apply_S(base(rf))))

    return prol_s, restrict_s


# ---------------------------------------------------------------------------
# Interface-band deflation
#
# The error the V-cycle leaves on cut problems is smooth along the
# interface band: the patch and Chebyshev smoothers are local, and the
# rediscretized coarse level cuts the circle at other offsets, so its
# correction of band-tangential smooth modes degrades as N grows. A small
# space B of Fourier modes in the interface angle, on the constant
# components of the band faces, holds those modes; the additive coarse
# correction z += B (B^T A B)^-1 B^T r removes them at O(m^2) cost per
# apply, m = 2K+1 modes.
# ---------------------------------------------------------------------------


def band_face_features(n: int, cut_ids, K: int):
    """The deflation basis over the free faces of the cells ``cut_ids`` on
    the n x n unit-square grid, on the host: ((hj, hi, Wh), (vj, vi, Wv))
    with W [nface, 2K+1] the Fourier features [1, cos k theta, sin k
    theta] of the face centre's angle around the band's centroid (for
    star-shaped interfaces), rows scaled by 1/sqrt(nface)."""
    ids = np.asarray(cut_ids)
    jj, ii = ids // n, ids % n
    hkey = np.unique(np.concatenate([jj * n + ii, (jj + 1) * n + ii]))
    hkey = hkey[(hkey // n != 0) & (hkey // n != n)]
    W = n + 1
    vkey = np.unique(np.concatenate([jj * W + ii, jj * W + ii + 1]))
    vkey = vkey[(vkey % W != 0) & (vkey % W != n)]
    hj, hi = hkey // n, hkey % n
    vj, vi = vkey // W, vkey % W
    hx, hy = (hi + 0.5) / n, hj / n
    vx, vy = vi / n, (vj + 0.5) / n
    xc = np.concatenate([hx, vx]).mean() if len(hx) + len(vx) else 0.5
    yc = np.concatenate([hy, vy]).mean() if len(hy) + len(vy) else 0.5

    def feats(x, y):
        th = np.arctan2(y - yc, x - xc)
        cols = [np.ones_like(th)]
        for k in range(1, K + 1):
            cols.append(np.cos(k * th))
            cols.append(np.sin(k * th))
        return np.stack(cols, axis=1)

    nf = max(len(hj) + len(vj), 1)
    return ((hj, hi, feats(hx, hy) / np.sqrt(nf)),
            (vj, vi, feats(vx, vy) / np.sqrt(nf)))


def _band_basis(sys_f: StructuredFaceSystem, cut_ids, Wh, Wv):
    """(B, Bt): y [m] -> the grids of B y (the features on the constant
    component of the band faces, masked), and r -> B^T r [m]."""
    K = (Wh.shape[1] - 1) // 2
    (hj, hi, _), (vj, vi, _) = band_face_features(sys_f.Nx, cut_ids, K)
    dev = Wh.device
    hj, hi, vj, vi = (torch.as_tensor(a, device=dev)
                      for a in (hj, hi, vj, vi))
    freeH, freeV = sys_f.freeH[None], sys_f.freeV[None]
    fbs, Ny, Nx = sys_f.fbs, sys_f.Ny, sys_f.Nx

    def B(y) -> GridVecCL:
        H = Wh.new_zeros((fbs, Ny + 1, Nx))
        V = Wh.new_zeros((fbs, Ny, Nx + 1))
        H[0].index_put_((hj, hi), Wh @ y, accumulate=True)
        V[0].index_put_((vj, vi), Wv @ y, accumulate=True)
        return GridVecCL(H * freeH, V * freeV)

    def Bt(r: GridVecCL):
        return Wh.T @ r.H[0, hj, hi] + Wv.T @ r.V[0, vj, vi]

    return B, Bt


def make_band_deflation(sys_f: StructuredFaceSystem, apply_S, cut_ids,
                        K: int, dtype):
    """The band deflation of the section comment on the level ``sys_f``
    with operator ``apply_S``: returns ((Wh, Wv, G_chol), apply), apply
    being r -> B (B^T A B)^-1 B^T r (make_band_deflation_apply). G =
    B^T A B is built from the 2K+1 operator columns, symmetrized and
    shifted by 100 eps / m tr(G) before its Cholesky factor."""
    (_, _, Wh), (_, _, Wv) = band_face_features(sys_f.Nx, cut_ids, K)
    dev = sys_f.freeH.device
    Wh = torch.as_tensor(Wh, device=dev).to(dtype)
    Wv = torch.as_tensor(Wv, device=dev).to(dtype)
    m = Wh.shape[1]
    B, Bt = _band_basis(sys_f, cut_ids, Wh, Wv)
    eye = torch.eye(m, dtype=dtype, device=dev)
    G = torch.stack([Bt(apply_S(B(eye[j]))) for j in range(m)], dim=1)
    shift = 100.0 * torch.finfo(dtype).eps / m
    G = 0.5 * (G + G.T) + shift * torch.trace(G) * eye
    arrays = (Wh, Wv, torch.linalg.cholesky(G))
    return arrays, make_band_deflation_apply(sys_f, cut_ids, arrays)


def make_band_deflation_apply(sys_f: StructuredFaceSystem, cut_ids,
                              arrays):
    """The deflation apply r -> B (B^T A B)^-1 B^T r from the arrays
    (Wh, Wv, G_chol) of make_band_deflation; ``cut_ids`` give the face
    index sets again."""
    Wh, Wv, G_chol = arrays
    B, Bt = _band_basis(sys_f, cut_ids, Wh, Wv)

    def apply(r: GridVecCL) -> GridVecCL:
        return B(torch.cholesky_solve(Bt(r)[:, None], G_chol)[:, 0])

    return apply


def _jacobi(diag: GridVecCL):
    """r -> r / diag on the grids."""
    inv = GridVecCL(1.0 / diag.H, 1.0 / diag.V)

    def apply(r: GridVecCL) -> GridVecCL:
        return GridVecCL(r.H * inv.H, r.V * inv.V)

    return apply


def _damped(base, omega: float):
    def apply(r: GridVecCL) -> GridVecCL:
        z = base(r)
        return GridVecCL(omega * z.H, omega * z.V)

    return apply


def build_multigrid(N: int, fbs: int, S_per_level, hdi: HHODegreeInfo,
                    n_smooth: int = 2, coarsest: int = 8,
                    cut_ids_per_level=None, patch_sweeps: int = 1,
                    cheb_degree: int = 4, patch_colors: int = 1,
                    uniform_per_level=None, smoother: str = "chebyshev",
                    omega: float = 0.67, galerkin_per_level=None,
                    gamma: int = 1, cheb_ops: str = "exact",
                    rec_dev_per_level=None,
                    smooth_transfers: bool = False) -> Multigrid:
    """The V-cycle over meshes N, N/2, ..., coarsest of the unit square,
    on cells-last grids (the JAX package's layout="cl").

    ``smoother``: 'chebyshev' (Chebyshev(cheb_degree) over the
    block-Jacobi-preconditioned operator), 'block_jacobi' (per-face
    fbs x fbs blocks) or 'jacobi' (pointwise), the last two damped by
    ``omega``. On a lean level the Jacobi diagonal is that of the whole
    operator, unit cell plus deviations (cells_last.uniform_diagonal_cl):
    the JAX package scatters the deviation columns alone there and fails.

    ``S_per_level``: {n: S_n}, the condensed local Schur matrices of each
    rediscretized level, cells-last. With ``uniform_per_level``
    ({n: (S_u [nfd, nfd], sorted irregular ids)}) level n runs the
    constant-stencil operators and S_n is the deviation dS [nfd*nfd, Ci]
    at the irregular columns (cells_last.uniform_deltas takes it from a
    full S); without an entry S_n is the full [nfd*nfd, C_n] array.
    ``cut_ids_per_level`` ({n: patch cell ids}) turns on the
    interface-patch smoother on each level.

    ``galerkin_per_level`` ({n: GalerkinLevel}, the coarse levels of
    band_galerkin_levels) makes level n's operator the exact Galerkin one:
    its residual applies, its Chebyshev polynomial and its patch blocks
    (galerkin_patch_setup) use it, while the block-Jacobi or Jacobi base
    stays the rediscretized one of S_per_level. A coarsest entry with
    coarse_Q replaces the dense pseudo-inverse. ``gamma`` > 1 re-visits the
    coarse problem of the top two gaps (Multigrid.gamma).

    ``cheb_ops`` ('exact', 'mixed', 'uniform'): the operator pair of the
    Chebyshev polynomial and of its eigenvalue estimate (_cheb_op_pair;
    'mixed' and 'uniform' need ``uniform_per_level`` on every level).
    ``rec_dev_per_level`` ({n: drec [rbs*nfd, Ci]}, column-aligned with
    level n's irregular ids) adds the cut-aware correction to the
    transfers of every gap whose coarse level n has an entry.
    ``smooth_transfers`` wraps every transfer pair in
    _smooth_transfer_pair with the level's operator and base, at the
    Chebyshev smoother's eigenvalue (a fresh estimate with the damped
    smoothers)."""
    if smoother not in SMOOTHERS:
        raise ValueError(f"smoother={smoother!r}: expected one of "
                         f"{SMOOTHERS}")
    if cheb_ops not in CHEB_OPS:
        raise ValueError(f"cheb_ops={cheb_ops!r}: expected one of "
                         f"{CHEB_OPS}")
    if cheb_ops != "exact" and smoother != "chebyshev":
        raise ValueError(f"cheb_ops={cheb_ops!r} needs the Chebyshev "
                         f"smoother, not {smoother!r}")
    sizes = _mg_sizes(N, coarsest)
    dtype, device = S_per_level[N].dtype, S_per_level[N].device
    systems = {n: make_structured_system(n, n, fbs, device=device)
               for n in sizes}
    uniform_per_level = uniform_per_level or {}
    galerkin_per_level = galerkin_per_level or {}

    levels = []
    for i, n in enumerate(sizes):
        sys_n = systems[n]
        S_n = S_per_level[n]
        S_u, irr = uniform_per_level.get(n, (None, None))
        if S_u is not None:
            S_u = torch.as_tensor(S_u, dtype=dtype, device=device)
            dS = S_n
            if dS.shape[1] != len(irr):
                raise ValueError(f"level {n}: dS has {dS.shape[1]} columns "
                                 f"for {len(irr)} irregular cells")
            apply_S = cl.make_uniform_operator_cl(sys_n, S_u, irr, dS)
            if smoother == "jacobi":
                base = _jacobi(cl.uniform_diagonal_cl(sys_n, S_u, irr, dS))
            else:
                hf, vf = cl.uniform_face_block_deltas(sys_n, dS, irr)
                base = cl.make_uniform_block_jacobi_cl(
                    sys_n, *cl.uniform_block_jacobi_blocks(sys_n, S_u),
                    *cl.uniform_bj_from_deltas(sys_n, S_u, hf, vf, dtype))
        else:
            apply_S = cl.make_structured_operator_cl(sys_n, S_n)
            base = _jacobi(cl.structured_diagonal_cl(sys_n, S_n)) \
                if smoother == "jacobi" else \
                cl.block_jacobi_preconditioner_cl(sys_n, S_n)

        gal = galerkin_per_level.get(n)
        if gal is not None:
            apply_S = make_galerkin_operator_cl(sys_n, gal.kernel, gal.rows,
                                                gal.cols, gal.blocks)
        if smoother == "chebyshev":
            apply_sm, base_sm = _cheb_op_pair(sys_n, apply_S, base, S_u,
                                              cheb_ops)
            lam = estimate_lambda_max(apply_sm, base_sm,
                                      _zeros_grid(sys_n, dtype))
            smoothers = (make_chebyshev_smoother(apply_sm, base_sm, lam,
                                                 degree=cheb_degree),)
        else:
            smoothers = (_damped(base, omega),)
        patch_ids = () if cut_ids_per_level is None else \
            cut_ids_per_level.get(n, ())
        if len(patch_ids) > 0:
            patches = []
            for g in cl.patch_color_groups(patch_ids, n, patch_colors):
                if gal is not None:
                    patches.append(cl.make_patch_apply(
                        sys_n, g, *galerkin_patch_setup(sys_n, gal, g,
                                                        dtype)))
                elif S_u is not None:
                    patches.append(cl.make_patch_apply(
                        sys_n, g, *cl.uniform_patch_setup_lean(
                            sys_n, S_u, dS, irr, g, dtype)))
                else:
                    patches.append(cl.make_cut_patch_smoother_cl(sys_n, S_n,
                                                                 g))
            # error local to the sliver-cut Nitsche cells is invisible
            # both to Jacobi and to the (differently cut) coarse level
            smoothers = smoothers + tuple(patches) * patch_sweeps
        prol = restrict = None
        if i + 1 < len(sizes):
            nc = sizes[i + 1]
            mats = _transfer_slot_matrices(hdi, 1.0 / nc, dtype,
                                           device=device)
            corr = None
            if rec_dev_per_level is not None and \
                    rec_dev_per_level.get(nc) is not None:
                if nc not in uniform_per_level:
                    raise ValueError(f"level {nc}: a cut-aware transfer "
                                     "needs its irregular ids "
                                     "(uniform_per_level)")
                corr = (uniform_per_level[nc][1], rec_dev_per_level[nc],
                        *_transfer_face_projectors(hdi, 1.0 / nc,
                                                   device=device))
            prol = make_reconstruction_prolongation_cl(
                sys_n, systems[nc], hdi, 1.0 / nc, dtype, mats=mats,
                corr=corr)
            restrict = make_reconstruction_restriction_cl(
                sys_n, systems[nc], hdi, 1.0 / nc, dtype, mats=mats,
                corr=corr)
            if smooth_transfers:
                lam_s = lam if smoother == "chebyshev" else \
                    estimate_lambda_max(apply_S, base,
                                        _zeros_grid(sys_n, dtype))
                prol, restrict = _smooth_transfer_pair(prol, restrict,
                                                       apply_S, base, lam_s)
        levels.append(MGLevel(sys_n, apply_S, smoothers, prol, restrict))

    nco = sizes[-1]
    shapes = ((fbs, nco + 1, nco), (fbs, nco, nco + 1))
    gal_co = galerkin_per_level.get(nco)
    if gal_co is not None and gal_co.coarse_Q is not None:
        factor = (gal_co.coarse_Q, gal_co.coarse_winv)
    else:
        # the coarsest operator, made dense column by column
        ntot = int(np.prod(shapes[0]) + np.prod(shapes[1]))
        eye = torch.eye(ntot, dtype=dtype, device=device)
        apply_c = levels[-1].apply_S
        factor = _coarse_factor(torch.stack(
            [_flatten(apply_c(_unflatten(eye[j], shapes)))
             for j in range(ntot)], dim=1))
    return Multigrid(levels, factor, shapes, n_smooth, gamma)
