"""HHO degree bookkeeping, batched load/mass operators and small SPD
solves (JAX counterpart: proton_tpu/core/ops.py; reference
utils.hpp:62-235)."""

from __future__ import annotations

import dataclasses
import warnings

import torch

from . import bases, quadrature


@dataclasses.dataclass(frozen=True)
class HHODegreeInfo:
    """Cell/face/reconstruction degrees with the validity rule of
    hho_degree_info (utils.hpp:62-111): cell_deg must be within one of
    face_deg; otherwise revert to equal order. The reconstruction degree
    is face_deg + 1."""

    cell_degree: int = 1
    face_degree: int = 1

    def __post_init__(self):
        cd, fd = self.cell_degree, self.face_degree
        ok = (fd > 0 and cd in (fd - 1, fd, fd + 1)) or \
             (fd == 0 and cd in (fd, fd + 1))
        if not ok:
            warnings.warn("Invalid cell degree. Reverting to equal-order")
            object.__setattr__(self, "cell_degree", fd)

    @property
    def reconstruction_degree(self) -> int:
        return self.face_degree + 1

    @classmethod
    def equal_order(cls, degree: int) -> "HHODegreeInfo":
        return cls(degree, degree)


def cell_rhs(mesh, geom, degree: int, f, di: int = 0):
    """[C, B] load vectors for a callable f(pts [..., 2]) -> [...]
    (make_rhs cell overload, utils.hpp:153-174)."""
    rule = quadrature.cell_rule(mesh, geom, 2 * (degree + di))
    phi = bases.eval_cell_basis(rule.pts, geom.bar[:, None, :],
                                geom.diam[:, None], degree)
    return torch.einsum("cq,cqi,cq->ci", rule.w, phi, f(rule.pts))


def _face_basis_data(face_pts):
    """(bar, base, h) of faces with endpoints [..., 2, 2] in sorted-ptid
    order (bases.hpp:253-262)."""
    bar = torch.mean(face_pts, dim=-2)
    base = bar - face_pts[..., 0, :]
    h = torch.linalg.vector_norm(face_pts[..., 1, :] - face_pts[..., 0, :],
                                 dim=-1)
    return bar, base, h


def _face_evals(face_pts, degree: int, di: int):
    bar, base, h = _face_basis_data(face_pts)
    rule = quadrature.face_rule(face_pts[..., 0, :], face_pts[..., 1, :],
                                2 * (degree + di))
    phi = bases.eval_face_basis(rule.pts, bar[..., None, :],
                                base[..., None, :], h[..., None], degree)
    return rule, phi


def face_mass_matrices(face_pts, degree: int, di: int = 0):
    """[..., Bf, Bf] face mass matrices (utils.hpp:133-151)."""
    rule, phi = _face_evals(face_pts, degree, di)
    return torch.einsum("...q,...qi,...qj->...ij", rule.w, phi, phi)


def face_rhs(face_pts, degree: int, f, di: int = 0):
    """[..., Bf] face load vectors (utils.hpp:176-197)."""
    rule, phi = _face_evals(face_pts, degree, di)
    return torch.einsum("...q,...qi,...q->...i", rule.w, phi, f(rule.pts))


def cho_solve_batched(A, B):
    """Batched SPD solve A X = B via Cholesky. Raises if a block is not
    positive definite."""
    return torch.cholesky_solve(B, torch.linalg.cholesky(A))


def equilibrated_cho_solve(A, B):
    """Cholesky solve with symmetric diagonal equilibration
    A' = D^-1/2 A D^-1/2. Returns (X, info): info > 0 marks blocks whose
    factorization failed (their X is garbage)."""
    d = torch.sqrt(torch.diagonal(A, dim1=-2, dim2=-1))
    A_ = A / (d[..., :, None] * d[..., None, :])
    B_ = B / d[..., :, None]
    L, info = torch.linalg.cholesky_ex(A_)
    return torch.cholesky_solve(B_, L) / d[..., :, None], info


def robust_spd_solve(A, B):
    """Batched SPD solve that survives rounding on marginal blocks:
    equilibrated Cholesky, with a pivoted-LU solve of a trace-eps-shifted
    copy for any block whose Cholesky failed (never selected in f64 on the
    tested problems). A [..., n, n], B [..., n, m]."""
    X, info = equilibrated_cho_solve(A, B)
    bad = (info != 0) | torch.isnan(X).any(dim=-1).any(dim=-1)
    if bool(bad.any()):
        eps = torch.finfo(A.dtype).eps
        tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / A.shape[-1]
        eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
        A_reg = A + (16.0 * eps * tr)[..., None, None] * eye
        X = torch.where(bad[..., None, None], torch.linalg.solve(A_reg, B), X)
    return X


def cell_mass_matrices(mesh, geom, degree: int, di: int = 0):
    """[C, B, B] cell mass matrices (make_mass_matrix cell overload,
    utils.hpp:113-131); quadrature degree 2*(degree+di)."""
    rule = quadrature.cell_rule(mesh, geom, 2 * (degree + di))
    phi = bases.eval_cell_basis(rule.pts, geom.bar[:, None, :],
                                geom.diam[:, None], degree)
    return torch.einsum("cq,cqi,cqj->cij", rule.w, phi, phi)


def spd_inverse(A):
    """Batched SPD inverse: robust_spd_solve against the identity."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return robust_spd_solve(A, eye.expand(A.shape))


def project_function(mesh, geom, hdi: HHODegreeInfo, f, di: int = 0):
    """L2 projection of f onto the per-cell HHO space [C, cbs + nF*fbs]
    (project_function, utils.hpp:199-227). Padded face slots get zeros."""
    cm = cell_mass_matrices(mesh, geom, hdi.cell_degree, di)
    cr = cell_rhs(mesh, geom, hdi.cell_degree, f, di)
    cell_dofs = cho_solve_batched(cm, cr[..., None])[..., 0]
    fm = face_mass_matrices(geom.face_pts, hdi.face_degree, di)
    fr = face_rhs(geom.face_pts, hdi.face_degree, f, di)
    face_dofs = cho_solve_batched(fm, fr[..., None])[..., 0]  # [C, nF, fbs]
    face_dofs = torch.where(geom.edge_valid[..., None], face_dofs,
                            torch.zeros_like(face_dofs))
    C = mesh.num_cells
    return torch.cat([cell_dofs, face_dofs.reshape(C, -1)], dim=1)


def condition_number(A):
    """SVD condition number (utils.hpp:229-235); batched."""
    s = torch.linalg.svdvals(A)
    return s[..., 0] / s[..., -1]
