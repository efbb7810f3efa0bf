"""Plain reference of the cutHHO elliptic interface problem on the
generated N x N mesh of the unit square cut by a circle (ProtoN
``run_cuthho_interface``, ``cuthho_square -i``,
apps/cuthho/cuthho_square.cpp:1625-1846).

It judges a solution; it does not solve. From the problem alone it works
out again the mesh, the classification with the node displacement and
the refined interface, and every cell's local operator and load:

- uncut cells: the kappa-weighted HHO reconstruction plus the naive
  stabilization (:1668-1681), kappa_1 on the negative side (inside the
  circle) and kappa_2 on the positive one, and the whole-cell load;
- cut cells: the doubled operator of make_hho_laplacian_interface
  (:390-502) on the local layout [uT-, uT+, uF-, uF+], each side's
  kappa-weighted stiffness, the interface's consistency and penalty
  coupling of the two sides, the side face terms, plus each side's
  stabilization (:1690-1704); the side loads, with no Nitsche lifting
  (:1708-1710).

Given the program's per-cell, per-side unknowns ``local_neg`` and
``local_pos`` ([N*N, cbs + 4(k+1)] each: uT, then uF face by face in
local order, on the side's copy of a cut face) it returns

- the residual of the face equations, sum over cells of A_FT uT + A_FF uF
  on every non-Dirichlet face copy, over the condensed right-hand side
  -sum A_FT A_TT^-1 f_T: equal to the relative residual of the condensed
  face system once the cell rows hold. A face copy is keyed (face, side)
  where the face is cut and (face) elsewhere: the uncut faces of a cut
  cell take the rows of both its sides, as in the interface assembler
  (:1155-1182);
- the residual of the cell rows A_TT uT + A_TF uF - f_T over |f_T|;
- the H1 error of the cell unknowns against u = sin(pi x) sin(pi y) over
  both sides (:1763-1834).

The bases, quadratures, grid, classification, side polygons, the
uncut-cell operator and the small SPD solve are those of the sibling
``cuthho.py``, the fictitious-domain reference. It shares no dof map,
condensation, V-cycle, Schwarz block or CG with the program, and works
over the uncut cells in blocks of 65,536. It imports torch and numpy
only.

Where it departs from upstream:

- the doubled cut-cell stiffness is singular (the constant on both sides
  has no gradient and no jump). Upstream factors it by LDLT anyway
  (:498) and lives on round-off; this file adds sigma v v^T along that
  null vector v = (1, 1) of the two constants before solving, which
  leaves grT K^-1 gr unchanged because gr is orthogonal to v;
- take_local_data (:1357-1429) reads the face unknowns from the base
  cbs * num_cells, not cbs * num_all_cells, when cut cells exist
  (:1423): the program reads them from the right base, and this file
  judges the unknowns so read;
- the Dirichlet data of the outer boundary is that of u, which vanishes
  there: the condensed right-hand side takes none of it (the program's
  projection of it is at rounding level), and the face and cell rows
  read the program's values on those faces.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import cuthho as ref

LOC_NEG, LOC_POS, LOC_CUT = ref.LOC_NEG, ref.LOC_POS, ref.LOC_CUT
BLOCK = ref.BLOCK


def _stab_parts(g, pts, w, k: int):
    """Face mass and face-cell trace matrices of the naive stabilization
    on the face quadrature (pts, w) [C, 4, Q]."""
    fbar, fbase, fh = ref._face_data(g.face_pts)
    cphi = ref.cell_basis(pts, g.bar[:, None, None], g.diam[:, None, None],
                          k + 1)
    fphi = ref.face_basis(pts, fbar[:, :, None], fbase[:, :, None],
                          fh[:, :, None], k)
    return (torch.einsum("cfq,cfqi,cfqj->cfij", w, fphi, fphi),
            torch.einsum("cfq,cfqi,cfqt->cfit", w, fphi, cphi))


def uncut_operator(g, k: int, kappa):
    """[C, d, d]: kappa times the HHO reconstruction of uncut quads plus
    their naive stabilization; ``kappa`` [C]."""
    pts, w = ref.segment_rule(g.pts, torch.roll(g.pts, -1, dims=1), 2 * k)
    mass, trace = _stab_parts(g, pts, w, k)
    live = torch.ones_like(mass[..., 0, 0], dtype=torch.bool)
    stab = ref._stabilization(mass, trace, g.meas, live)
    return kappa[:, None, None] * (ref.fitted_operator(g, k) - stab) + stab


def interface_operator(cc, phi, k: int, kappa_1: float, kappa_2: float,
                       eta: float):
    """[Cc, D, D], D = 2 (cbs + 4 fbs), layout [uT-, uT+, uF-, uF+]: the
    doubled reconstruction of make_hho_laplacian_interface plus each
    side's kappa-weighted stabilization.

    The reconstruction's bilinear form on the two sides' degree-(k+1)
    polynomials, n the level set's normal (out of the negative side):
    sum_i kappa_i (grad u_i, grad v_i)_side i - <kappa_1 d_n u_-, [v]>
    - <[u], kappa_1 d_n v_-> + kappa_1 eta / |T| <[u], [v]>, [u] = u_- - u_+,
    the interface terms integrated on the negative side's rule."""
    r, cbs, fbs = k + 1, ref.cell_basis_size(k + 1), k + 1
    rbs, nfd = cbs, 4 * fbs
    g = cc.g
    Cc = g.pts.shape[0]
    D = 2 * (cbs + nfd)
    bar, diam = g.bar[:, None], g.diam[:, None]

    stiff, sbar = {}, {}
    for side, kap in ((LOC_NEG, kappa_1), (LOC_POS, kappa_2)):
        tp, count, sbar[side] = ref.side_polygon(cc, side)
        qp, qw = ref.fan_rule(tp, count, sbar[side], 2 * r)
        dphi = ref.cell_grads(qp, bar, diam, r)
        stiff[side] = kap * torch.einsum("cq,cqix,cqjx->cij", qw, dphi, dphi)
    ip, iw = ref._interface(cc, sbar[LOC_NEG], 2 * r)
    iphi = ref.cell_basis(ip, bar, diam, r)
    idn = torch.einsum("cqix,cqx->cqi", ref.cell_grads(ip, bar, diam, r),
                       phi.normal(ip))
    # a[i, j] = kappa_1 <phi_i, d_n phi_j>: test i, trial j
    a = kappa_1 * torch.einsum("cq,cqi,cqj->cij", iw, iphi, idn)
    c = (kappa_1 * eta / g.meas)[:, None, None] * \
        torch.einsum("cq,cqi,cqj->cij", iw, iphi, iphi)
    at = a.transpose(1, 2)
    K = torch.cat([torch.cat([stiff[LOC_NEG] - a - at + c, at - c], dim=2),
                   torch.cat([a - c, stiff[LOC_POS] + c], dim=2)], dim=1)

    # right-hand sides of the reconstruction: the cell columns of K, then
    # each side's face terms on the side's part of the faces
    gr = K.new_zeros((Cc, 2 * rbs, D))
    gr[:, :, :cbs] = K[:, :, :cbs]
    gr[:, :, cbs:2 * cbs] = K[:, :, rbs:rbs + cbs]
    fbar, fbase, fh = ref._face_data(g.face_pts)
    for side, kap, row, col in ((LOC_NEG, kappa_1, 0, 0),
                                (LOC_POS, kappa_2, rbs, cbs)):
        fpts, fw = ref._side_faces(cc, 2 * r, side)
        fdn = torch.einsum("cfqrx,cfx->cfqr", ref.cell_grads(
            fpts, bar[:, None], diam[:, None], r), g.normals)
        cphi = ref.cell_basis(fpts, bar[:, None], diam[:, None], r)
        fphi = ref.face_basis(fpts, fbar[:, :, None], fbase[:, :, None],
                              fh[:, :, None], k)
        fblk = kap * torch.einsum("cfq,cfqr,cfqb->crfb", fw, fdn, fphi)
        corr = kap * torch.einsum("cfq,cfqr,cfqt->crt", fw, fdn,
                                  cphi[..., :cbs])
        f0 = 2 * cbs + (0 if side == LOC_NEG else nfd)
        gr[:, row:row + rbs, col:col + cbs] -= corr
        gr[:, row:row + rbs, f0:f0 + nfd] += fblk.reshape(Cc, rbs, nfd)

    # the null vector of K (the constants of both sides), departure above
    v = K.new_zeros(2 * rbs)
    v[0] = v[rbs] = 1.0
    sigma = torch.diagonal(K, dim1=1, dim2=2).mean(dim=1)
    K = K + sigma[:, None, None] * (v[:, None] * v[None, :])
    lc = torch.einsum("crm,crn->cmn", gr, ref.spd_solve(K, gr))

    for side, kap, c0, f0 in ((LOC_NEG, kappa_1, 0, 2 * cbs),
                              (LOC_POS, kappa_2, cbs, 2 * cbs + nfd)):
        spts, sw = ref._side_faces(cc, 2 * k, side)
        mass, trace = _stab_parts(g, spts, sw, k)
        stab = kap * ref._stabilization(mass, trace, g.meas,
                                        torch.sum(torch.abs(sw), -1) > 0)
        cols = torch.cat([torch.arange(c0, c0 + cbs),
                          torch.arange(f0, f0 + nfd)]).to(lc.device)
        lc[:, cols[:, None], cols[None, :]] += stab
    return lc


def side_loads(cc, k: int, f):
    """[Cc, 2 cbs]: the source on each side of the cut cells, [f-, f+]."""
    r = k + 1
    g = cc.g
    out = []
    for side in (LOC_NEG, LOC_POS):
        tp, count, sbar = ref.side_polygon(cc, side)
        qp, qw = ref.fan_rule(tp, count, sbar, 2 * r)
        phi = ref.cell_basis(qp, g.bar[:, None], g.diam[:, None], r)
        out.append(torch.einsum("cq,cqi,cq->ci", qw, phi, f(qp)))
    return torch.cat(out, dim=1)


class Judgement(NamedTuple):
    face_res: float   # |sum A_F u| / |condensed rhs|, non-Dirichlet copies
    cell_res: float   # |A_TT uT + A_TF uF - f_T| / |f_T|, all cells
    h1: float         # H1 error of uT over both sides
    n_cut: int


def judge(N: int, k: int, radius: float, center, refsteps: int,
          kappa_1: float, kappa_2: float, eta: float, local_neg, local_pos,
          device) -> Judgement:
    """The residuals and the H1 error of the per-side unknowns
    ``local_neg`` and ``local_pos`` (module docstring), float64."""
    dt = torch.float64
    grid = ref.make_grid(N, device, dt)
    phi = ref.Circle(radius, *center)
    cls = ref.classify(grid, phi, refsteps)
    cbs, fbs = ref.cell_basis_size(k + 1), k + 1
    C, F = N * N, grid.face_ptids.shape[0]
    # face copy (f, s) at row 2 f + s; s = 1 only on the positive copy of
    # a cut face
    rF = torch.zeros((2 * F, fbs), dtype=dt, device=device)
    bF = torch.zeros_like(rF)
    sums = torch.zeros(3, dtype=dt, device=device)   # |r_T|^2, |f_T|^2, H1^2
    face_cut = (cls.face_loc == LOC_CUT).long()

    def host(local, cells):
        return local[cells.to(local.device)].to(device=device, dtype=dt)

    def accumulate(lc, u, fT, rows, nT):
        """Rows of cells whose local vector u [n, m] has nT cell unknowns
        first; ``rows`` [n, m - nT] the face copy of each face unknown."""
        rT = torch.einsum("cij,cj->ci", lc[:, :nT], u) - fT
        yF = torch.einsum("cij,cj->ci", lc[:, nT:], u)
        z = ref.spd_solve(lc[:, :nT, :nT], fT[..., None])[..., 0]
        bT = -torch.einsum("cji,cj->ci", lc[:, :nT, nT:], z)
        rows = rows.reshape(-1, fbs)[:, 0]
        rF.index_add_(0, rows, yF.reshape(-1, fbs))
        bF.index_add_(0, rows, bT.reshape(-1, fbs))
        sums[:2] += torch.stack([torch.sum(rT * rT), torch.sum(fT * fT)])

    def h1(g, qp, qw, uT):
        gh = torch.einsum("cqix,ci->cqx", ref.cell_grads(
            qp, g.bar[:, None], g.diam[:, None], k + 1)[:, :, 1:], uT[:, 1:])
        sums[2] += torch.sum(qw * torch.sum((ref.exact_grad(qp) - gh) ** 2,
                                            -1))

    def face_rows(faces, copy):
        return (2 * faces + copy)[..., None].expand(*faces.shape, fbs)

    kap = torch.tensor([kappa_1, kappa_2], dtype=dt, device=device)
    for s in range(0, C, BLOCK):
        cells = torch.arange(s, min(s + BLOCK, C), device=device)
        cells = cells[cls.cell_loc[cells] != LOC_CUT]
        g = ref.geometry(cls.points, grid, cells)
        pos = cls.cell_loc[cells] == LOC_POS
        u = torch.where(pos[:, None], host(local_pos, cells),
                        host(local_neg, cells))
        lc = uncut_operator(g, k, kap[pos.long()])
        faces = grid.cell_faces[cells]
        accumulate(lc, u, ref.fitted_load(g, k, ref.exact_f),
                   face_rows(faces, 0).reshape(len(cells), -1), cbs)
        qp, qw = ref.quad_rule(g.pts, 2 * (k + 1))
        h1(g, qp, qw, u[:, :cbs])

    cc = ref.cut_cells(grid, cls)
    ids = cls.cut_ids
    un, up = host(local_neg, ids), host(local_pos, ids)
    u = torch.cat([un[:, :cbs], up[:, :cbs], un[:, cbs:], up[:, cbs:]], 1)
    faces = grid.cell_faces[ids]
    rows = torch.cat([face_rows(faces, 0),
                      face_rows(faces, face_cut[faces])], dim=1)
    accumulate(interface_operator(cc, phi, k, kappa_1, kappa_2, eta), u,
               side_loads(cc, k, ref.exact_f), rows.reshape(len(ids), -1),
               2 * cbs)
    for side, us in ((LOC_NEG, un), (LOC_POS, up)):
        tp, count, sbar = ref.side_polygon(cc, side)
        qp, qw = ref.fan_rule(tp, count, sbar, 2 * (k + 1))
        h1(cc.g, qp, qw, us[:, :cbs])

    inner = ~grid.face_bnd
    live = torch.stack([inner, inner & (face_cut == 1)], dim=1).reshape(-1)
    rT2, fT2, h2 = sums.tolist()
    return Judgement(
        float(torch.linalg.vector_norm(rF[live]) /
              torch.linalg.vector_norm(bF[live])),
        (rT2 / fT2) ** 0.5, h2 ** 0.5, int(len(ids)))
