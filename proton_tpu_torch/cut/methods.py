"""Batched cutHHO operators over the cut-cell class (JAX counterpart:
proton_tpu/cut/methods.py; reference cuthho_square.cpp:293-666).

Classification marks cells NEG / POS / CUT; the host gathers the cut-cell
ids once and these operators run on the compact [Cc, ...] batch. Uncut
cells take the fitted operator (methods/fused_assembly.py on the
generated mesh, methods/hho.py on any mesh); the solvers overwrite the
cut cells with these. The interface problem's doubled-space operator is
``interface_laplacian``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..core import bases
from ..core.geometry import CellGeom, cell_points
from ..core.ops import HHODegreeInfo, _face_basis_data, cho_solve_batched, \
    robust_spd_solve
from .classify import LOC_NEG, LOC_POS, CutData
from .levelset import LevelSet
from .quadrature import SidePolygon, interface_rule, side_cell_rule, \
    side_face_rule, triangulation_points

# Nitsche penalty (cell_eta, cuthho_square.cpp:301-306)
CELL_ETA = 5.0


class InterfaceParams(NamedTuple):
    """params{kappa_1, kappa_2, eta} (cuthho_square.cpp:293-299)."""

    kappa_1: float = 1.0
    kappa_2: float = 1.0
    eta: float = 5.0


class CutCellBatch(NamedTuple):
    """Per-cut-cell data gathered to [Cc, ...]."""

    ids: torch.Tensor         # [Cc] cell indices
    pts: torch.Tensor         # [Cc, P, 2]
    npts: torch.Tensor        # [Cc]
    geom: CellGeom            # all fields gathered to [Cc, ...]
    node_loc: torch.Tensor    # [Cc, P] corner LOC codes
    face_loc: torch.Tensor    # [Cc, nF]
    face_isect: torch.Tensor  # [Cc, nF, 2]
    fnode_loc: torch.Tensor   # [Cc, nF, 2] LOC of each face endpoint
    interface: torch.Tensor   # [Cc, R+1, 2]


def make_cut_batch(mesh, geom: CellGeom, cutdata: CutData,
                   ids) -> CutCellBatch:
    """Gather the cut-cell class; ``ids`` are host cell indices."""
    ids = torch.as_tensor(ids, dtype=torch.int64, device=mesh.points.device)
    cf = mesh.cell_faces[ids]
    fn = mesh.face_ptids[cf]
    return CutCellBatch(
        ids=ids,
        pts=cell_points(mesh)[ids],
        npts=mesh.cell_npts[ids],
        geom=CellGeom(*(f[ids] for f in geom)),
        node_loc=cutdata.node_loc[mesh.cell_ptids[ids]],
        face_loc=cutdata.face_loc[cf],
        face_isect=cutdata.face_isect[cf],
        fnode_loc=cutdata.node_loc[fn],
        interface=cutdata.interface[ids],
    )


def side_polygon(batch: CutCellBatch, side: int) -> SidePolygon:
    return triangulation_points(batch.pts, batch.npts, batch.node_loc,
                                batch.interface, side)


def _side_cell_evals(batch, poly, degree, quad_degree, want_grads=True):
    rule = side_cell_rule(poly, quad_degree)
    g = batch.geom
    phi = bases.eval_cell_basis(rule.pts, g.bar[:, None, :],
                                g.diam[:, None], degree)
    dphi = (bases.eval_cell_gradients(rule.pts, g.bar[:, None, :],
                                      g.diam[:, None], degree)
            if want_grads else None)
    return rule, phi, dphi


def _side_face_evals(batch, cell_degree, face_degree, quad_degree,
                     side, want_grads=False):
    """Cell+face basis evaluations on the (sub-segment) quadrature of each
    face of each cut cell; off-side faces get zero weights."""
    g = batch.geom
    rule = side_face_rule(g.face_pts, batch.face_loc, batch.face_isect,
                          batch.fnode_loc[..., 0], batch.fnode_loc[..., 1],
                          quad_degree, side)
    w = rule.w * g.edge_valid[..., None]
    cphi = bases.eval_cell_basis(rule.pts, g.bar[:, None, None, :],
                                 g.diam[:, None, None], cell_degree)
    cdphi = (bases.eval_cell_gradients(rule.pts, g.bar[:, None, None, :],
                                       g.diam[:, None, None], cell_degree)
             if want_grads else None)
    fbar, fbase, fh = _face_basis_data(g.face_pts)
    fphi = bases.eval_face_basis(rule.pts, fbar[..., None, :],
                                 fbase[..., None, :], fh[..., None],
                                 face_degree)
    return w, cphi, cdphi, fphi, rule.pts


def _interface_evals(batch, poly, ls: LevelSet, degree, quad_degree):
    g = batch.geom
    irule = interface_rule(batch.interface, poly.bar, quad_degree)
    phi = bases.eval_cell_basis(irule.pts, g.bar[:, None, :],
                                g.diam[:, None], degree)
    dphi = bases.eval_cell_gradients(irule.pts, g.bar[:, None, :],
                                     g.diam[:, None], degree)
    return irule, phi, dphi, ls.normal(irule.pts)


def _nitsche_side_stiffness(batch: CutCellBatch, poly, ls: LevelSet,
                            recdeg: int, eta: float):
    """Side stiffness minus the consistency terms plus eta/hT times the
    interface mass (cuthho_square.cpp:337-360), [Cc, rbs, rbs]."""
    rule, _, dphi = _side_cell_evals(batch, poly, recdeg, 2 * recdeg)
    stiff = torch.einsum("cq,cqix,cqjx->cij", rule.w, dphi, dphi)
    hT = batch.geom.meas
    irule, iphi, idphi, n = _interface_evals(batch, poly, ls, recdeg,
                                             2 * recdeg)
    dn = torch.einsum("cqix,cqx->cqi", idphi, n)
    A = torch.einsum("cq,cqi,cqj->cij", irule.w, iphi, dn)
    M = torch.einsum("cq,cqi,cqj->cij", irule.w, iphi, iphi)
    return stiff - A - A.transpose(1, 2) + M * (eta / hT)[:, None, None]


def cut_hho_laplacian(batch: CutCellBatch, ls: LevelSet,
                      hdi: HHODegreeInfo, side: int, eta: float = CELL_ETA
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nitsche fictitious-domain reconstruction on cut cells
    (cuthho_square.cpp:308-388). Returns (oper [Cc, rbs, d],
    data [Cc, d, d])."""
    recdeg = hdi.reconstruction_degree
    rbs = bases.cell_basis_size(recdeg)
    cbs = bases.cell_basis_size(hdi.cell_degree)
    fbs = bases.face_basis_size(hdi.face_degree)
    Cc, nF = batch.pts.shape[:2]

    stiff = _nitsche_side_stiffness(batch, side_polygon(batch, side), ls,
                                    recdeg, eta)

    # face couplings at 2*recdeg quadrature, full-rbs gradients
    # (cuthho_square.cpp:366-383)
    w, cphi, cdphi, fphi, _ = _side_face_evals(batch, recdeg,
                                               hdi.face_degree, 2 * recdeg,
                                               side, want_grads=True)
    fdn = torch.einsum("cfqrx,cfx->cfqr", cdphi, batch.geom.normals)
    face_blocks = torch.einsum("cfq,cfqr,cfqb->cfrb", w, fdn, fphi)
    cell_corr = torch.einsum("cfq,cfqr,cfqk->crk", w, fdn, cphi[..., :cbs])

    gr_rhs = torch.cat(
        [stiff[:, :, :cbs] - cell_corr,
         face_blocks.permute(0, 2, 1, 3).reshape(Cc, rbs, nF * fbs)], dim=2)
    oper = robust_spd_solve(stiff, gr_rhs)
    data = torch.einsum("crm,crn->cmn", gr_rhs, oper)
    return oper, data


def cut_stabilization(batch: CutCellBatch, hdi: HHODegreeInfo, side: int):
    """Naive stabilization restricted to one side, skipping faces whose
    side quadrature is empty (cuthho_square.cpp:566-621); 1/h uses the
    full cell area (:589)."""
    cbs = bases.cell_basis_size(hdi.cell_degree)
    fbs = bases.face_basis_size(hdi.face_degree)
    Cc, nF = batch.face_loc.shape

    w, cphi, _, fphi, _ = _side_face_evals(batch, hdi.cell_degree,
                                        hdi.face_degree,
                                        2 * hdi.face_degree, side)
    mass = torch.einsum("cfq,cfqi,cfqj->cfij", w, fphi, fphi)
    trace = torch.einsum("cfq,cfqi,cfqk->cfik", w, fphi, cphi)

    live = (torch.sum(torch.abs(w), dim=-1) > 0)[..., None, None]
    eye_f = torch.eye(fbs, dtype=mass.dtype, device=mass.device)
    ratio = cho_solve_batched(torch.where(live, mass, eye_f), trace)

    neg_eyes = torch.zeros((nF, fbs, nF * fbs), dtype=mass.dtype,
                           device=mass.device)
    for f in range(nF):
        neg_eyes[f, :, f * fbs:(f + 1) * fbs] = -eye_f
    oper = torch.cat([ratio, neg_eyes.expand(Cc, nF, fbs, nF * fbs)], dim=3)

    mo = torch.einsum("cfij,cfjs->cfis", mass, oper)
    mo = torch.where(live, mo, torch.zeros_like(mo))
    data = torch.einsum("cfir,cfis->crs", oper, mo)
    return data / batch.geom.meas[:, None, None]


def cut_rhs(batch: CutCellBatch, degree: int, f, ls: LevelSet, bcs,
            side: int, eta: float = CELL_ETA):
    """Source + Nitsche boundary lifting on cut cells
    (cuthho_square.cpp:623-666): side source at 2*degree quadrature plus
    int_Gamma g (eta/hT phi - dphi.n) at *degree* quadrature (:647).
    Returns [Cc, cbs]."""
    poly = side_polygon(batch, side)
    rule, phi, _ = _side_cell_evals(batch, poly, degree, 2 * degree,
                                    want_grads=False)
    ret = torch.einsum("cq,cqi,cq->ci", rule.w, phi, f(rule.pts))

    hT = batch.geom.meas
    irule, iphi, idphi, n = _interface_evals(batch, poly, ls, degree, degree)
    dn = torch.einsum("cqix,cqx->cqi", idphi, n)
    lift = iphi * (eta / hT)[:, None, None] - dn
    return ret + torch.einsum("cq,cq,cqi->ci", irule.w, bcs(irule.pts), lift)


def check_eigs(batch: CutCellBatch, ls: LevelSet, hdi: HHODegreeInfo,
               side: int):
    """Eigenvalues of the Nitsche-stabilized side stiffness per cut cell
    (check_eigs, cuthho_square.cpp:504-560), the coercivity diagnostic.
    Returns [Cc, rbs], ascending."""
    poly = side_polygon(batch, side)
    return torch.linalg.eigvalsh(_nitsche_side_stiffness(
        batch, poly, ls, hdi.reconstruction_degree, CELL_ETA))


def interface_laplacian(batch: CutCellBatch, ls: LevelSet,
                        hdi: HHODegreeInfo,
                        parms: InterfaceParams = InterfaceParams()
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Doubled-space (neg/pos) reconstruction with kappa-weighted
    stiffness and interface jump/penalty coupling
    (make_hho_laplacian_interface, cuthho_square.cpp:390-502).

    Local dof layout (the reference's): [cbs neg | cbs pos | nF*fbs neg |
    nF*fbs pos]. Returns (oper [Cc, 2*rbs, 2*d'], data [Cc, 2*d', 2*d'])
    with d' = cbs + nF*fbs."""
    recdeg = hdi.reconstruction_degree
    rbs = bases.cell_basis_size(recdeg)
    cbs = bases.cell_basis_size(hdi.cell_degree)
    fbs = bases.face_basis_size(hdi.face_degree)
    Cc, nF = batch.face_loc.shape
    nfd = nF * fbs
    D = 2 * (cbs + nfd)
    k1, k2, eta = parms.kappa_1, parms.kappa_2, parms.eta

    # side stiffnesses (cuthho_square.cpp:420-432)
    poly_n = side_polygon(batch, LOC_NEG)
    rule_n, _, dphi_n = _side_cell_evals(batch, poly_n, recdeg, 2 * recdeg)
    stiff_nn = k1 * torch.einsum("cq,cqix,cqjx->cij", rule_n.w, dphi_n,
                                 dphi_n)
    poly_p = side_polygon(batch, LOC_POS)
    rule_p, _, dphi_p = _side_cell_evals(batch, poly_p, recdeg, 2 * recdeg)
    stiff_pp = k2 * torch.einsum("cq,cqix,cqjx->cij", rule_p.w, dphi_p,
                                 dphi_p)

    # interface coupling blocks (:437-459), integrated on the NEG side
    hT = batch.geom.meas
    irule, iphi, idphi, n = _interface_evals(batch, poly_n, ls, recdeg,
                                             2 * recdeg)
    dn = torch.einsum("cqix,cqx->cqi", idphi, n)
    a = k1 * torch.einsum("cq,cqi,cqj->cij", irule.w, iphi, dn)
    b = a.transpose(1, 2)
    c = (k1 * eta / hT)[:, None, None] * \
        torch.einsum("cq,cqi,cqj->cij", irule.w, iphi, iphi)
    stiff = torch.cat([torch.cat([stiff_nn - a - b + c, b - c], dim=2),
                       torch.cat([a - c, stiff_pp + c], dim=2)], dim=1)

    # gr_rhs cell columns (:462-463)
    gr_rhs = stiff.new_zeros((Cc, 2 * rbs, D))
    gr_rhs[:, :, :cbs] = stiff[:, :, :cbs]
    gr_rhs[:, :, cbs:2 * cbs] = stiff[:, :, rbs:rbs + cbs]

    # face couplings per side (:465-496); gradients not deconstantized,
    # face quadrature at 2*recdeg
    for side, kap, row0, cell_col0, face_col0 in (
            (LOC_NEG, k1, 0, 0, 2 * cbs),
            (LOC_POS, k2, rbs, cbs, 2 * cbs + nfd)):
        w, cphi, cdphi, fphi, _ = _side_face_evals(
            batch, recdeg, hdi.face_degree, 2 * recdeg, side,
            want_grads=True)
        fdn = torch.einsum("cfqrx,cfx->cfqr", cdphi, batch.geom.normals)
        fb = kap * torch.einsum("cfq,cfqr,cfqb->cfrb", w, fdn, fphi)
        cc = kap * torch.einsum("cfq,cfqr,cfqk->crk", w, fdn,
                                cphi[..., :cbs])
        gr_rhs[:, row0:row0 + rbs, cell_col0:cell_col0 + cbs] -= cc
        gr_rhs[:, row0:row0 + rbs, face_col0:face_col0 + nfd] += \
            fb.permute(0, 2, 1, 3).reshape(Cc, rbs, nfd)

    # The doubled Nitsche matrix is singular: the global constant (1 on
    # both sides) has zero stiffness, zero jump penalty and zero
    # consistency terms. The reference solves it with LDLT anyway (:498)
    # and survives on round-off; regularize exactly instead: gr_rhs is
    # orthogonal to the null vector v = (e0, e0), so adding
    # sigma * v v^T changes oper only along v and leaves data invariant.
    v = stiff.new_zeros(2 * rbs)
    v[0] = 1.0
    v[rbs] = 1.0
    sigma = torch.einsum("cii->c", stiff) / (2 * rbs)
    stiff_reg = stiff + sigma[:, None, None] * (v[:, None] * v[None, :])
    oper = robust_spd_solve(stiff_reg, gr_rhs)
    data = torch.einsum("crm,crn->cmn", gr_rhs, oper)
    return oper, data


def cut_project_function(batch: CutCellBatch, hdi: HHODegreeInfo, side: int,
                         f):
    """Side-restricted L2 projection (project_function,
    cuthho_utils.hpp:107-146): cell dofs from the side mass matrix, face
    dofs only on faces touching the side. Returns [Cc, d']."""
    celdeg, facdeg = hdi.cell_degree, hdi.face_degree
    fbs = bases.face_basis_size(facdeg)
    Cc, nF = batch.face_loc.shape

    poly = side_polygon(batch, side)
    rule, phi, _ = _side_cell_evals(batch, poly, celdeg, 2 * celdeg,
                                    want_grads=False)
    mass = torch.einsum("cq,cqi,cqj->cij", rule.w, phi, phi)
    rhs = torch.einsum("cq,cqi,cq->ci", rule.w, phi, f(rule.pts))
    cell_dofs = cho_solve_batched(mass, rhs[..., None])[..., 0]

    w, _, _, fphi, fpts = _side_face_evals(batch, celdeg, facdeg,
                                           2 * facdeg, side)
    fmass = torch.einsum("cfq,cfqi,cfqj->cfij", w, fphi, fphi)
    frhs = torch.einsum("cfq,cfqi,cfq->cfi", w, fphi, f(fpts))
    live = torch.sum(torch.abs(w), dim=-1) > 0
    eye_f = torch.eye(fbs, dtype=fmass.dtype, device=fmass.device)
    safe = torch.where(live[..., None, None], fmass, eye_f)
    fdofs = cho_solve_batched(safe, frhs[..., None])[..., 0]
    fdofs = torch.where(live[..., None], fdofs, torch.zeros_like(fdofs))
    return torch.cat([cell_dofs, fdofs.reshape(Cc, nF * fbs)], dim=1)
