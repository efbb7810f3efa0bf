"""Batched HHO operators on any mesh of the SoA layout (JAX counterpart:
proton_tpu/methods/hho.py; reference hho.hpp:32-237).

Each builder makes the operator of every cell at once:

- gradient reconstruction   -> (oper [C, rbs-1, d], data [C, d, d])
- naive stabilization       -> [C, d, d]
- fancy (HHO) stabilization -> [C, d, d]

with d = cbs + nF*fbs and nF the padded face count per cell. Padded face
slots get zero quadrature weights, an identity in their mass blocks
before the Cholesky solves, and are masked after, so the same code
serves quad and polygonal meshes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..core import bases, quadrature
from ..core.geometry import CellGeom
from ..core.ops import HHODegreeInfo, _face_basis_data, cho_solve_batched


def local_dof_count(mesh, hdi: HHODegreeInfo) -> int:
    cbs = bases.cell_basis_size(hdi.cell_degree)
    fbs = bases.face_basis_size(hdi.face_degree)
    return cbs + mesh.max_pts * fbs


class FaceEvals(NamedTuple):
    """Basis evaluations on all cell-face quadrature points: w [C,nF,Q];
    cphi [C,nF,Q,rbs]; cdphi [C,nF,Q,rbs,2] (or None); fphi [C,nF,Q,fbs]."""

    w: torch.Tensor
    cphi: torch.Tensor
    cdphi: Optional[torch.Tensor]
    fphi: torch.Tensor


def _face_evals(geom: CellGeom, rec_degree: int, fac_degree: int,
                quad_degree: int, want_grads: bool) -> FaceEvals:
    """Cell (rec_degree) and face bases at the GL points of every face of
    every cell; padded faces get zero weights (hho.py:61)."""
    frule = quadrature.face_rule(geom.face_pts[..., 0, :],
                                 geom.face_pts[..., 1, :], quad_degree)
    w = frule.w * geom.edge_valid[..., None]
    bar = geom.bar[:, None, None, :]
    diam = geom.diam[:, None, None]
    cphi = bases.eval_cell_basis(frule.pts, bar, diam, rec_degree)
    cdphi = (bases.eval_cell_gradients(frule.pts, bar, diam, rec_degree)
             if want_grads else None)
    fbar, fbase, fh = _face_basis_data(geom.face_pts)
    fphi = bases.eval_face_basis(frule.pts, fbar[..., None, :],
                                 fbase[..., None, :], fh[..., None],
                                 fac_degree)
    return FaceEvals(w, cphi, cdphi, fphi)


def _safe_mass(geom: CellGeom, mass):
    """Face mass blocks with the identity on padded slots, so the batched
    Cholesky stays well posed (hho.py:135-136, 193-194)."""
    eye = torch.eye(mass.shape[-1], dtype=mass.dtype, device=mass.device)
    return torch.where(geom.edge_valid[..., None, None], mass, eye)


def _face_identity_blocks(nF: int, fbs: int, width: int, offset: int,
                          like: torch.Tensor):
    """[nF, fbs, width] with -I at columns offset + f*fbs of block f."""
    out = torch.zeros((nF, fbs, width), dtype=like.dtype, device=like.device)
    eye = torch.eye(fbs, dtype=like.dtype, device=like.device)
    for f in range(nF):
        out[f, :, offset + f * fbs:offset + (f + 1) * fbs] = -eye
    return out


def _masked_quadratic(geom: CellGeom, mass, B, h):
    """sum over valid faces of B_f^T M_f B_f / h."""
    mB = torch.einsum("cfij,cfjs->cfis", mass, B)
    mB = torch.where(geom.edge_valid[..., None, None], mB,
                     torch.zeros_like(mB))
    return torch.einsum("cfir,cfis->crs", B, mB) / h[:, None, None]


def hho_laplacian(mesh, geom: CellGeom, hdi: HHODegreeInfo
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched gradient reconstruction (make_hho_laplacian,
    hho.hpp:32-96): (oper [C, rbs-1, d], data [C, d, d]), data being
    a_T(., .) = (grad r(.), grad r(.))."""
    recdeg = hdi.reconstruction_degree
    cbs = bases.cell_basis_size(hdi.cell_degree)
    fbs = bases.face_basis_size(hdi.face_degree)
    rbs = bases.cell_basis_size(recdeg)
    nF, C = mesh.max_pts, mesh.num_cells

    # cell stiffness (hho.hpp:55-64)
    rule = quadrature.cell_rule(mesh, geom, 2 * recdeg)
    dphi = bases.eval_cell_gradients(rule.pts, geom.bar[:, None, :],
                                     geom.diam[:, None], recdeg)
    stiff = torch.einsum("cq,cqix,cqjx->cij", rule.w, dphi, dphi)
    del dphi

    # face coupling (grad r . n, v_F - v_T) (hho.hpp:66-85)
    fe = _face_evals(geom, recdeg, hdi.face_degree, 2 * hdi.face_degree,
                     want_grads=True)
    dn = torch.einsum("cfqrx,cfx->cfqr", fe.cdphi[..., 1:, :], geom.normals)
    face_blocks = torch.einsum("cfq,cfqr,cfqb->cfrb", fe.w, dn, fe.fphi)
    cell_corr = torch.einsum("cfq,cfqr,cfqk->crk", fe.w, dn,
                             fe.cphi[..., :cbs])
    gr_rhs = torch.cat(
        [stiff[:, 1:, :cbs] - cell_corr,
         face_blocks.permute(0, 2, 1, 3).reshape(C, rbs - 1, nF * fbs)],
        dim=2)

    oper = cho_solve_batched(stiff[:, 1:, 1:], gr_rhs)      # hho.hpp:92
    data = torch.einsum("crm,crn->cmn", gr_rhs, oper)       # hho.hpp:93
    return oper, data


def naive_stabilization(mesh, geom: CellGeom, hdi: HHODegreeInfo):
    """Batched (1/h) sum_F ||pi_F(v_F - v_T)||^2
    (make_hho_naive_stabilization, hho.hpp:99-148). Mirrors the
    reference's h = measure(cl), the cell *area* (hho.hpp:119)."""
    fbs = bases.face_basis_size(hdi.face_degree)
    nF, C = mesh.max_pts, mesh.num_cells

    fe = _face_evals(geom, hdi.cell_degree, hdi.face_degree,
                     2 * hdi.face_degree, want_grads=False)
    mass = torch.einsum("cfq,cfqi,cfqj->cfij", fe.w, fe.fphi, fe.fphi)
    trace = torch.einsum("cfq,cfqi,cfqk->cfik", fe.w, fe.fphi, fe.cphi)
    ratio = cho_solve_batched(_safe_mass(geom, mass), trace)  # hho.hpp:142

    # oper[f] = [ratio | 0 ... -I ... 0] (hho.hpp:126-142)
    neg = _face_identity_blocks(nF, fbs, nF * fbs, 0, mass)
    oper = torch.cat([ratio, neg.expand(C, nF, fbs, nF * fbs)], dim=3)
    return _masked_quadratic(geom, mass, oper, geom.meas)


def fancy_stabilization(mesh, geom: CellGeom, hdi: HHODegreeInfo,
                        reconstruction):
    """Batched HHO stabilization pi_F(v_F - p_T v) + pi_F(v_T - pi_T p_T v)
    (make_hho_fancy_stabilization, hho.hpp:155-237). Uses h = diameter(cl)
    (hho.hpp:201), unlike the naive variant."""
    recdeg = hdi.reconstruction_degree
    cbs = bases.cell_basis_size(hdi.cell_degree)
    fbs = bases.face_basis_size(hdi.face_degree)
    rbs = bases.cell_basis_size(recdeg)
    nF = mesh.max_pts
    d = cbs + nF * fbs
    R = reconstruction                                   # [C, rbs-1, d]

    # cell mass at the reconstruction degree (hho.hpp:173-179)
    rule = quadrature.cell_rule(mesh, geom, 2 * recdeg)
    phi = bases.eval_cell_basis(rule.pts, geom.bar[:, None, :],
                                geom.diam[:, None], recdeg)
    mass = torch.einsum("cq,cqi,cqj->cij", rule.w, phi, phi)

    # proj1 = v_T - pi_T p_T v (hho.hpp:184-190)
    proj1 = -cho_solve_batched(
        mass[:, :cbs, :cbs],
        torch.einsum("cir,crd->cid", mass[:, :cbs, 1:rbs], R))
    proj1[:, :, :cbs] += torch.eye(cbs, dtype=R.dtype, device=R.device)

    # face mass and trace at the reconstruction degree (hho.hpp:199-216)
    fe = _face_evals(geom, recdeg, hdi.face_degree, 2 * hdi.face_degree,
                     want_grads=False)
    fmass = torch.einsum("cfq,cfqi,cfqj->cfij", fe.w, fe.fphi, fe.fphi)
    ftrace = torch.einsum("cfq,cfqi,cfqk->cfik", fe.w, fe.fphi, fe.cphi)
    safe = _safe_mass(geom, fmass)

    # proj2 = pi_F p_T v - v_F (hho.hpp:222-226)
    proj2 = cho_solve_batched(
        safe, torch.einsum("cfir,crd->cfid", ftrace[..., 1:rbs], R))
    proj2 = proj2 + _face_identity_blocks(nF, fbs, d, cbs, proj2)

    # proj3 = pi_F(v_T - pi_T p_T v) (hho.hpp:229-230)
    proj3 = cho_solve_batched(
        safe, torch.einsum("cfik,ckd->cfid", ftrace[..., :cbs], proj1))
    return _masked_quadratic(geom, fmass, proj2 + proj3, geom.diam)
