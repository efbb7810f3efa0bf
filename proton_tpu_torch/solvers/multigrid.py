"""Geometric multigrid preconditioner for the condensed HHO face system
on the generated mesh (JAX counterpart: proton_tpu/solvers/multigrid.py,
the cells-last layout with the Chebyshev smoother and the rediscretized
hierarchy).

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
  of the identity, then an eigendecomposition pseudo-inverse.

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
    """The transfer matrices as [6*fbs, nfd] products, rows ordered
    (r, c, f), with the 0.5 averaging weight of the coarse-skeleton faces
    (H rows r = 0, 2; V columns c = 0, 2) folded in. Halving is exact, so
    this equals averaging the two adjacent reconstructions afterwards."""
    wH = MH.new_tensor([0.5, 1.0, 0.5])[:, None, None, None]
    wV = MV.new_tensor([0.5, 1.0, 0.5])[None, :, None, None]
    nfd = MH.shape[-1]
    return (MH * wH).reshape(-1, nfd), (MV * wV).reshape(-1, nfd)


def _check_refinement(sys_f, sys_c) -> None:
    if sys_f.Nx != 2 * sys_c.Nx or sys_f.Ny != 2 * sys_c.Ny:
        raise ValueError("the fine grid must be the 2x2 refinement of the "
                         "coarse grid")


def make_reconstruction_prolongation_cl(sys_f: StructuredFaceSystem,
                                        sys_c: StructuredFaceSystem,
                                        hdi: HHODegreeInfo, h_coarse: float,
                                        dtype=torch.float64, mats=None):
    """Reconstruction-based coarse -> fine transfer on GridVecCL grids.
    ``mats``: precomputed (MH, MV) of _transfer_slot_matrices."""
    fbs = sys_f.fbs
    _check_refinement(sys_f, sys_c)
    MH, MV = mats if mats is not None else _transfer_slot_matrices(
        hdi, h_coarse, dtype, device=sys_f.freeH.device)
    AH, AV = _weighted_flat(MH, MV)
    Nyc, Nxc = sys_c.Ny, sys_c.Nx
    freeH, freeV = sys_f.freeH[None], sys_f.freeV[None]

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
        return GridVecCL(H * freeH, V * freeV)

    return prolong


def make_reconstruction_restriction_cl(sys_f: StructuredFaceSystem,
                                       sys_c: StructuredFaceSystem,
                                       hdi: HHODegreeInfo, h_coarse: float,
                                       dtype=torch.float64, mats=None):
    """Adjoint of make_reconstruction_prolongation_cl as a stencil: per
    coarse cell, gather its 12 fine-face values by strided slicing
    (skeleton faces carry the 0.5 averaging weight), contract with the
    transfer matrices transposed, and accumulate the cell contributions
    onto the coarse grids."""
    fbs = sys_f.fbs
    _check_refinement(sys_f, sys_c)
    MH, MV = mats if mats is not None else _transfer_slot_matrices(
        hdi, h_coarse, dtype, device=sys_f.freeH.device)
    AH, AV = _weighted_flat(MH, MV)
    AHt, AVt = AH.T.contiguous(), AV.T.contiguous()
    Nyc, Nxc = sys_c.Ny, sys_c.Nx
    freeH, freeV = sys_f.freeH[None], sys_f.freeV[None]

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
        return cl.grid_scatter_cl(sys_c, torch.addmm(AHt @ fh, AVt, fv))

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
    Q, winv = fac
    return Q @ (winv * (Q.T @ rhs))


def _flatten(x: GridVecCL):
    return torch.cat([x.H.reshape(-1), x.V.reshape(-1)])


def _unflatten(v, shapes) -> GridVecCL:
    hshape, vshape = shapes
    n = int(np.prod(hshape))
    return GridVecCL(v[:n].reshape(hshape), v[n:].reshape(vshape))


def _vcycle(mg: Multigrid, lvl: int, b: GridVecCL) -> GridVecCL:
    level = mg.levels[lvl]
    if lvl == len(mg.levels) - 1:
        return _unflatten(_coarse_solve(mg.coarse_factor, _flatten(b)),
                          mg.coarse_shape)

    def smooth(x, steps):
        # x = None is the zero initial guess: the first residual is b
        for _ in range(mg.n_smooth):
            for s in steps:
                x = s(b) if x is None else \
                    _add(x, s(_sub(b, level.apply_S(x))))
        return x

    x = smooth(None, level.smoothers)
    ec = _vcycle(mg, lvl + 1, level.restrict(_sub(b, level.apply_S(x))))
    x = _add(x, level.prolong(ec))
    return smooth(x, tuple(reversed(level.smoothers)))


SMOOTHERS = ("chebyshev", "block_jacobi", "jacobi")


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
                    omega: float = 0.67) -> Multigrid:
    """The V-cycle over meshes N, N/2, ..., coarsest of the unit square,
    on cells-last grids (the JAX package's layout="cl", cheb_ops="exact").

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
    interface-patch smoother on each level."""
    if smoother not in SMOOTHERS:
        raise ValueError(f"smoother={smoother!r}: expected one of "
                         f"{SMOOTHERS}")
    sizes = _mg_sizes(N, coarsest)
    dtype, device = S_per_level[N].dtype, S_per_level[N].device
    systems = {n: make_structured_system(n, n, fbs, device=device)
               for n in sizes}
    uniform_per_level = uniform_per_level or {}

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

        if smoother == "chebyshev":
            lam = estimate_lambda_max(apply_S, base,
                                      _zeros_grid(sys_n, dtype))
            smoothers = (make_chebyshev_smoother(apply_S, base, lam,
                                                 degree=cheb_degree),)
        else:
            smoothers = (_damped(base, omega),)
        patch_ids = () if cut_ids_per_level is None else \
            cut_ids_per_level.get(n, ())
        if len(patch_ids) > 0:
            patches = []
            for g in cl.patch_color_groups(patch_ids, n, patch_colors):
                if S_u is not None:
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
            prol = make_reconstruction_prolongation_cl(
                sys_n, systems[nc], hdi, 1.0 / nc, dtype, mats=mats)
            restrict = make_reconstruction_restriction_cl(
                sys_n, systems[nc], hdi, 1.0 / nc, dtype, mats=mats)
        levels.append(MGLevel(sys_n, apply_S, smoothers, prol, restrict))

    # the coarsest operator, made dense column by column
    nco = sizes[-1]
    shapes = ((fbs, nco + 1, nco), (fbs, nco, nco + 1))
    ntot = int(np.prod(shapes[0]) + np.prod(shapes[1]))
    eye = torch.eye(ntot, dtype=dtype, device=device)
    apply_c = levels[-1].apply_S
    Ac = torch.stack([_flatten(apply_c(_unflatten(eye[j], shapes)))
                      for j in range(ntot)], dim=1)
    return Multigrid(levels, _coarse_factor(Ac), shapes, n_smooth)
