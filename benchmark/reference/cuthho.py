"""Plain reference of the cutHHO fictitious-domain Poisson problem on the
generated N x N mesh of the unit square cut by a circle (ProtoN
``run_cuthho_fictdom``, apps/cuthho/cuthho_square.cpp:806-1080).

It judges a solution; it does not solve. From the problem alone it works
out again what the system under test derives: the mesh, the level-set
classification with the bad-cut node displacement and the refined
interface (cuthho_geom.hpp:68-673), every cell's local HHO operator and
load (hho.hpp:55-148 for uncut cells, the Nitsche operators of
cuthho_square.cpp:293-666 for cut ones). Given the per-cell unknowns
(uT, uF) of a solution it returns

- the residual of the face equations, sum over cells of A_FT uT + A_FF uF,
  over the condensed right-hand side -sum A_FT A_TT^-1 f_T: equal to the
  relative residual of the condensed face system once the cell rows hold;
- the residual of the cell rows A_TT uT + A_TF uF - f_T over |f_T|;
- the H1 error of the cell unknowns against the manufactured solution
  u = sin(pi x) sin(pi y) on the physical side (cuthho_square.cpp:1031-1050).

The per-cell formulas are a frozen copy of plain batched tensor math (the
same algorithm as the reference C++), written over whole cells in blocks:
no fused kernel, no lean or condensed system, no band restriction, no
multigrid and no CG. It imports torch and numpy only.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

LOC_NEG, LOC_POS, LOC_CUT = 0, 1, 2
BISECTION_STEPS = 30          # find_zero_crossing, cuthho_geom.hpp:68-116
CLOSENESS = 0.4               # move_nodes, cuthho_geom.hpp:466-543
BLOCK = 65536                 # cells per block of the fitted pass


# --------------------------------------------------------------------------
# bases (bases.hpp:70-291): scaled monomials, ordered by total degree
# --------------------------------------------------------------------------

def cell_basis_size(k: int) -> int:
    return (k + 1) * (k + 2) // 2


@lru_cache(maxsize=None)
def _exponents(k: int):
    px = [d - i for d in range(k + 1) for i in range(d + 1)]
    py = [i for d in range(k + 1) for i in range(d + 1)]
    return np.array(px), np.array(py)


def _powers(x, p: int):
    out = [torch.ones_like(x)]
    for _ in range(p):
        out.append(out[-1] * x)
    return torch.stack(out, dim=-1)


def cell_basis(pts, bar, h, k: int):
    px, py = _exponents(k)
    b = (pts - bar) / (0.5 * h[..., None])
    return _powers(b[..., 0], k)[..., px] * _powers(b[..., 1], k)[..., py]


def cell_grads(pts, bar, h, k: int):
    px, py = _exponents(k)
    b = (pts - bar) / (0.5 * h[..., None])
    X, Y = _powers(b[..., 0], k), _powers(b[..., 1], k)
    ih = (2.0 / h)[..., None]
    fx, fy = X[..., px], Y[..., py]
    dx = X[..., np.maximum(px - 1, 0)] * torch.as_tensor(
        px, dtype=pts.dtype, device=pts.device) * ih
    dy = Y[..., np.maximum(py - 1, 0)] * torch.as_tensor(
        py, dtype=pts.dtype, device=pts.device) * ih
    return torch.stack([dx * fy, fx * dy], dim=-1)


def face_basis(pts, fbar, fbase, fh, k: int):
    ep = 4.0 * torch.sum(fbase * (pts - fbar), dim=-1) / (fh * fh)
    return _powers(ep, k)


# --------------------------------------------------------------------------
# quadrature (quadratures.hpp): Gauss-Legendre, collapsed triangle rules
# --------------------------------------------------------------------------

@lru_cache(maxsize=None)
def gauss_legendre(degree: int):
    if degree % 2 == 0:
        degree += 1
    return np.polynomial.legendre.leggauss((degree + 1) // 2)


@lru_cache(maxsize=None)
def _duffy(degree: int):
    degree = max(degree, 1)
    xu, wu = np.polynomial.legendre.leggauss((degree + 1) // 2 + 1)
    xv, wv = np.polynomial.legendre.leggauss((degree + 2) // 2)
    U, V = np.meshgrid((xu + 1) / 2, (xv + 1) / 2, indexing="ij")
    WU, WV = np.meshgrid(wu / 2, wv / 2, indexing="ij")
    x, y = U.ravel(), (V * (1 - U)).ravel()
    return np.stack([1 - x - y, x, y], axis=1), 2 * (WU * WV * (1 - U)).ravel()


def _t(a, like):
    return torch.as_tensor(np.asarray(a), dtype=like.dtype, device=like.device)


def segment_rule(p0, p1, degree: int):
    x, w = gauss_legendre(degree)
    t, w = _t(x, p0), _t(w, p0)
    pts = 0.5 * (1 - t)[:, None] * p0[..., None, :] + \
        0.5 * (1 + t)[:, None] * p1[..., None, :]
    return pts, 0.5 * torch.linalg.vector_norm(p1 - p0, dim=-1)[..., None] * w


def quad_rule(p4, degree: int):
    """Tensor GL through the bilinear map of quads p4 [..., 4, 2]."""
    x, w = gauss_legendre(degree)
    xi, eta = _t(np.tile(x, len(x)), p4), _t(np.repeat(x, len(x)), p4)
    ww = _t(np.repeat(w, len(w)) * np.tile(w, len(w)), p4)
    p0, p1, p2, p3 = (p4[..., i, None, :] for i in range(4))
    s = [(1 - xi) * (1 - eta), (1 + xi) * (1 - eta), (1 + xi) * (1 + eta),
         (1 - xi) * (1 + eta)]
    pts = 0.25 * (p0 * s[0][:, None] + p1 * s[1][:, None] +
                  p2 * s[2][:, None] + p3 * s[3][:, None])
    a = 0.25 * ((p1 - p0) * (1 - eta)[:, None] + (p2 - p3) * (1 + eta)[:, None])
    b = 0.25 * ((p3 - p0) * (1 - xi)[:, None] + (p2 - p1) * (1 + xi)[:, None])
    jac = torch.abs(a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0])
    return pts, ww * jac


def fan_rule(tp, count, bar, degree: int):
    """One triangle (p_i, p_i+1, bar) per edge of padded polygons."""
    C, P, _ = tp.shape
    k = torch.arange(P, device=tp.device)[None, :]
    n = count[:, None]
    nxt = torch.where(k < n, torch.where(k + 1 < n, k + 1, 0),
                      torch.minimum(k, n - 1))
    e1 = torch.take_along_dim(tp, nxt[..., None].expand(C, P, 2), dim=1)
    lam, wb = _duffy(degree)
    lam, wb = _t(lam, tp), _t(wb, tp)
    b = bar[:, None, :].expand(C, P, 2)
    v0, v1 = e1 - tp, b - tp
    area = 0.5 * torch.abs(v0[..., 0] * v1[..., 1] - v0[..., 1] * v1[..., 0])
    pts = lam[:, 0, None] * tp[..., None, :] + lam[:, 1, None] * \
        e1[..., None, :] + lam[:, 2, None] * b[..., None, :]
    return pts.reshape(C, -1, 2), (area[..., None] * wb).reshape(C, -1)


# --------------------------------------------------------------------------
# mesh and geometry (basic_mesh.hpp:230-298, basic_geom.hpp)
# --------------------------------------------------------------------------

class Grid(NamedTuple):
    points: torch.Tensor       # [P, 2]
    cell_ptids: torch.Tensor   # [C, 4] (bl, br, tr, tl)
    cell_faces: torch.Tensor   # [C, 4] face k joins local points k, k+1
    face_ptids: torch.Tensor   # [F, 2] ascending point ids
    face_bnd: torch.Tensor     # [F] bool, on the square's boundary


def make_grid(N: int, device, dtype=torch.float64) -> Grid:
    """The unit square in N x N cells; faces numbered as the sorted,
    deduplicated list of (lower id, higher id) point pairs."""
    W = N + 1
    j, i = np.divmod(np.arange(W * W), W)
    points = np.stack([i * (1.0 / N), j * (1.0 / N)], axis=1)
    cj, ci = np.divmod(np.arange(N * N), N)
    p0 = cj * W + ci
    cell_ptids = np.stack([p0, p0 + 1, p0 + W + 1, p0 + W], axis=1)
    edges = np.stack([cell_ptids, np.roll(cell_ptids, -1, axis=1)], axis=2)
    edges = np.sort(edges, axis=2).reshape(-1, 2)
    faces, inverse = np.unique(edges, axis=0, return_inverse=True)
    fp = points[faces]
    bnd = ((fp[:, 0, 0] == fp[:, 1, 0]) & ((fp[:, 0, 0] == 0) |
                                           (fp[:, 0, 0] == 1))) | \
        ((fp[:, 0, 1] == fp[:, 1, 1]) & ((fp[:, 0, 1] == 0) |
                                         (fp[:, 0, 1] == 1)))

    def idx(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    return Grid(torch.as_tensor(points, dtype=dtype, device=device),
                idx(cell_ptids), idx(inverse.reshape(-1, 4)), idx(faces),
                torch.as_tensor(bnd, device=device))


def polygon_barycenter(pts):
    rel = pts - pts[..., :1, :]
    a, b = rel[..., 1:-1, :], rel[..., 2:, :]
    d = 0.5 * (a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0])
    num = torch.sum((a + b) * d[..., None], dim=-2)
    return pts[..., 0, :] + num / (3.0 * torch.sum(d, dim=-1)[..., None])


class Geom(NamedTuple):
    pts: torch.Tensor       # [C, 4, 2]
    bar: torch.Tensor       # [C, 2]
    diam: torch.Tensor      # [C]
    meas: torch.Tensor      # [C]
    normals: torch.Tensor   # [C, 4, 2] outward, local edge k
    face_pts: torch.Tensor  # [C, 4, 2, 2] ascending point-id order


def geometry(points, grid: Grid, cells) -> Geom:
    pts = points[grid.cell_ptids[cells]]
    rel = pts - pts[:, :1]
    a, b = rel[:, 1:-1], rel[:, 2:]
    meas = torch.abs(torch.sum(0.5 * (a[..., 0] * b[..., 1] -
                                      a[..., 1] * b[..., 0]), dim=-1))
    diff = pts[:, :, None, :] - pts[:, None, :, :]
    diam = torch.sqrt(torch.amax(torch.sum(diff * diff, dim=-1), dim=(1, 2)))
    v = torch.roll(pts, -1, dims=1) - pts
    n = torch.stack([v[..., 1], -v[..., 0]], dim=-1)
    normals = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    face_pts = points[grid.face_ptids[grid.cell_faces[cells]]]
    return Geom(pts, polygon_barycenter(pts), diam, meas, normals, face_pts)


def _face_data(face_pts):
    fbar = torch.mean(face_pts, dim=-2)
    fh = torch.linalg.vector_norm(face_pts[..., 1, :] - face_pts[..., 0, :],
                                  dim=-1)
    return fbar, fbar - face_pts[..., 0, :], fh


# --------------------------------------------------------------------------
# level set and classification (cuthho_geom.hpp:68-673)
# --------------------------------------------------------------------------

class Circle(NamedTuple):
    radius: float
    cx: float
    cy: float

    def __call__(self, p):
        x, y = p[..., 0] - self.cx, p[..., 1] - self.cy
        return x * x + y * y - self.radius * self.radius

    def normal(self, p):
        g = torch.stack([p[..., 0] - self.cx, p[..., 1] - self.cy], dim=-1)
        return g / torch.linalg.vector_norm(g, dim=-1, keepdim=True)


def _same_sign(a, b):
    return ((a >= 0) & (b >= 0)) | ((a < 0) & (b < 0))


def zero_crossing(pa, pb, phi):
    a, b = pa, pb
    for _ in range(BISECTION_STEPS):
        m = 0.5 * (a + b)
        same = _same_sign(phi(b), phi(m))[..., None]
        a, b = torch.where(same, a, m), torch.where(same, m, b)
    return 0.5 * (a + b)


def _face_cuts(points, grid: Grid, phi):
    fp = points[grid.face_ptids]
    l0, l1 = phi(fp[:, 0]), phi(fp[:, 1])
    loc = torch.where((l0 >= 0) & (l1 >= 0), LOC_POS,
                      torch.where((l0 < 0) & (l1 < 0), LOC_NEG, LOC_CUT))
    return loc, zero_crossing(fp[:, 0], fp[:, 1], phi)


class Classified(NamedTuple):
    points: torch.Tensor      # [P, 2] after the node displacement
    node_loc: torch.Tensor    # [P] side of the undisplaced nodes
    face_loc: torch.Tensor    # [F] on the displaced nodes
    face_isect: torch.Tensor  # [F, 2]
    cell_loc: torch.Tensor    # [C]
    cut_ids: torch.Tensor     # [Cc] ascending
    interface: torch.Tensor   # [Cc, 2^levels + 1, 2] oriented polyline


def classify(grid: Grid, phi: Circle, levels: int) -> Classified:
    """Node sides, node displacement by half the (face midpoint -
    crossing) offset where a crossing lies within 0.4 of a face end, face
    cuts on the displaced nodes, cells with two cut faces, and the
    interface bisected into 2^levels segments projected onto phi = 0."""
    points = grid.points
    P = points.shape[0]
    node_loc = torch.where(phi(points) < 0, LOC_NEG, LOC_POS)
    floc, isect = _face_cuts(points, grid, phi)
    fp = points[grid.face_ptids]
    close = torch.linalg.vector_norm(isect - fp[:, 0], dim=-1) / \
        torch.linalg.vector_norm(fp[:, 1] - fp[:, 0], dim=-1)
    cut = floc == LOC_CUT
    delta = 0.5 * (0.5 * (fp[:, 0] + fp[:, 1]) - isect)
    disp = torch.zeros_like(points)
    for end, moves in ((0, cut & (close < CLOSENESS)),
                       (1, cut & (close > 1 - CLOSENESS))):
        disp.index_add_(0, grid.face_ptids[moves, end], -delta[moves])
    points = points + disp

    floc, isect = _face_cuts(points, grid, phi)
    cf_cut = floc[grid.cell_faces] == LOC_CUT                     # [C, 4]
    count = cf_cut.sum(dim=1)
    cpts = points[grid.cell_ptids]
    cell_loc = torch.where(count >= 2, LOC_CUT, torch.where(
        torch.all(phi(cpts) > 0, dim=1), LOC_POS, LOC_NEG))
    if bool(torch.any((count != 0) & (count != 2))):
        raise RuntimeError("a cell with an invalid number of cuts")
    cut_ids = torch.nonzero(cell_loc == LOC_CUT)[:, 0]

    # the two cut faces of each cut cell, in local order; orient the
    # segment so that its left normal points into phi >= 0
    k = torch.arange(4, device=points.device)
    order = torch.where(cf_cut[cut_ids], k, 4)
    first = torch.argmin(order, dim=1)
    second = torch.argmin(torch.where(k == first[:, None], 4, order), dim=1)
    ci = isect[grid.cell_faces[cut_ids]]
    rows = torch.arange(len(cut_ids), device=points.device)
    p0, p1 = ci[rows, first], ci[rows, second]
    t = p1 - p0
    swap = (phi(p0 + torch.stack([-t[:, 1], t[:, 0]], dim=-1)) >= 0)[:, None]
    line = torch.stack([torch.where(swap, p1, p0),
                        torch.where(swap, p0, p1)], dim=1)
    for _ in range(levels):
        a, b = line[:, :-1], line[:, 1:]
        m = 0.5 * (a + b)
        t = b - a
        n = torch.stack([-t[..., 1], t[..., 0]], dim=-1)
        far = torch.where((~_same_sign(phi(m), phi(m + n)))[..., None],
                          m + n, m - n)
        ip = zero_crossing(m, far, phi)
        S = a.shape[1]
        line = torch.cat([torch.stack([a, ip], dim=2).reshape(-1, 2 * S, 2),
                          line[:, -1:]], dim=1)
    return Classified(points, node_loc, floc, isect, cell_loc, cut_ids, line)


# --------------------------------------------------------------------------
# small SPD solves
# --------------------------------------------------------------------------

def spd_solve(A, B):
    """Equilibrated Cholesky; a shifted LU solve for a block whose
    factorization fails."""
    d = torch.sqrt(torch.diagonal(A, dim1=-2, dim2=-1))
    L, info = torch.linalg.cholesky_ex(A / (d[..., :, None] * d[..., None, :]))
    X = torch.cholesky_solve(B / d[..., :, None], L) / d[..., :, None]
    bad = (info != 0) | torch.isnan(X).flatten(1).any(dim=1)
    if bool(bad.any()):
        tr = torch.diagonal(A, dim1=-2, dim2=-1).mean(-1)
        eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
        A_reg = A + (16 * torch.finfo(A.dtype).eps * tr)[..., None, None] * eye
        X = torch.where(bad[:, None, None], torch.linalg.solve(A_reg, B), X)
    return X


# --------------------------------------------------------------------------
# uncut cells: HHO reconstruction + naive stabilization (hho.hpp:55-148)
# --------------------------------------------------------------------------

def fitted_operator(g: Geom, k: int):
    """lc [C, d, d] of uncut quads at cell degree k+1, face degree k."""
    r, cbs, fbs = k + 1, cell_basis_size(k + 1), k + 1
    rbs = cbs
    C = g.pts.shape[0]
    qp, qw = quad_rule(g.pts, 2 * r)
    dphi = cell_grads(qp, g.bar[:, None], g.diam[:, None], r)
    stiff = torch.einsum("cq,cqix,cqjx->cij", qw, dphi, dphi)
    fpts, fw = segment_rule(g.pts, torch.roll(g.pts, -1, dims=1), 2 * k)
    cphi = cell_basis(fpts, g.bar[:, None, None], g.diam[:, None, None], r)
    cdphi = cell_grads(fpts, g.bar[:, None, None], g.diam[:, None, None], r)
    fbar, fbase, fh = _face_data(g.face_pts)
    fphi = face_basis(fpts, fbar[:, :, None], fbase[:, :, None],
                      fh[:, :, None], k)
    dn = torch.einsum("cfqrx,cfx->cfqr", cdphi[..., 1:, :], g.normals)
    fblk = torch.einsum("cfq,cfqr,cfqb->cfrb", fw, dn, fphi)
    corr = torch.einsum("cfq,cfqr,cfqt->crt", fw, dn, cphi[..., :cbs])
    gr = torch.cat([stiff[:, 1:, :cbs] - corr,
                    fblk.permute(0, 2, 1, 3).reshape(C, rbs - 1, 4 * fbs)],
                   dim=2)
    lc = torch.einsum("crm,crn->cmn", gr,
                      torch.cholesky_solve(gr, torch.linalg.cholesky(
                          stiff[:, 1:, 1:])))
    mass = torch.einsum("cfq,cfqi,cfqj->cfij", fw, fphi, fphi)
    trace = torch.einsum("cfq,cfqi,cfqt->cfit", fw, fphi, cphi[..., :cbs])
    lc = lc + _stabilization(mass, trace, g.meas, torch.ones_like(
        mass[..., 0, 0], dtype=torch.bool))
    return lc


def _stabilization(mass, trace, meas, live):
    """sum over faces of (P_F uT - uF)^T M_F (P_F uT - uF) / |T|, faces
    that are not ``live`` left out."""
    C, nf, fbs, _ = mass.shape
    eye = torch.eye(fbs, dtype=mass.dtype, device=mass.device)
    ratio = torch.cholesky_solve(trace, torch.linalg.cholesky(
        torch.where(live[..., None, None], mass, eye)))
    neg = torch.zeros((nf, fbs, nf * fbs), dtype=mass.dtype,
                      device=mass.device)
    for f in range(nf):
        neg[f, :, f * fbs:(f + 1) * fbs] = -eye
    op = torch.cat([ratio, neg.expand(C, nf, fbs, nf * fbs)], dim=3)
    mo = torch.where(live[..., None, None],
                     torch.einsum("cfij,cfjs->cfis", mass, op), 0.0)
    return torch.einsum("cfir,cfis->crs", op, mo) / meas[:, None, None]


def fitted_load(g: Geom, k: int, f):
    qp, qw = quad_rule(g.pts, 2 * (k + 1))
    phi = cell_basis(qp, g.bar[:, None], g.diam[:, None], k + 1)
    return torch.einsum("cq,cqi,cq->ci", qw, phi, f(qp))


# --------------------------------------------------------------------------
# cut cells: Nitsche fictitious-domain operators (cuthho_square.cpp:293-666)
# --------------------------------------------------------------------------

class CutCells(NamedTuple):
    g: Geom
    node_loc: torch.Tensor    # [Cc, 4]
    face_loc: torch.Tensor    # [Cc, 4]
    face_isect: torch.Tensor  # [Cc, 4, 2]
    fnode_loc: torch.Tensor   # [Cc, 4, 2] side of each face end
    interface: torch.Tensor   # [Cc, R+1, 2]


def cut_cells(grid: Grid, cls: Classified) -> CutCells:
    ids = cls.cut_ids
    cf = grid.cell_faces[ids]
    return CutCells(geometry(cls.points, grid, ids),
                    cls.node_loc[grid.cell_ptids[ids]], cls.face_loc[cf],
                    cls.face_isect[cf], cls.node_loc[grid.face_ptids[cf]],
                    cls.interface)


def side_polygon(cc: CutCells, side: int):
    """The polygon of one side (collect_triangulation_points,
    cuthho_geom.hpp:675-728): on-side nodes in local order and the
    interface, forward for NEG and reversed for POS; where the first and
    last nodes are both on the side, the leading run, the interface, then
    the trailing run. Returns (points padded by the last one, count,
    fan barycenter)."""
    pts, R1 = cc.g.pts, cc.interface.shape[1]
    Cc, P = pts.shape[:2]
    dev = pts.device
    k = torch.arange(P, device=dev)[None, :]
    on = cc.node_loc == side
    both_ends = on[:, 0] & on[:, -1]
    prefix = torch.cumprod(on.long(), dim=1).bool()
    suffix = torch.flip(torch.cumprod(torch.flip(on.long(), [1]), dim=1),
                        [1]).bool()
    trailing = suffix & on & ~prefix
    big = 10 * (P + R1 + 2)
    key_nodes = torch.where(on, torch.where(both_ends[:, None] & trailing,
                                            P + R1 + k, k), big)
    iface = cc.interface if side == LOC_NEG else torch.flip(cc.interface, [1])
    keys = torch.cat([key_nodes, (P + torch.arange(R1, device=dev))[None, :]
                      .expand(Cc, R1)], dim=1)
    order = torch.argsort(keys, dim=1, stable=True)
    tp = torch.take_along_dim(torch.cat([pts, iface], dim=1),
                              order[..., None].expand(-1, -1, 2), dim=1)
    count = on.sum(dim=1) + R1
    last = torch.take_along_dim(tp, (count - 1)[:, None, None]
                                .expand(-1, 1, 2), dim=1)
    slot = torch.arange(P + R1, device=dev)[None, :]
    tp = torch.where((slot < count[:, None])[..., None], tp, last)
    return tp, count, polygon_barycenter(tp)


def _side_faces(cc: CutCells, degree: int, side: int):
    """GL on the on-side part of each face: whole faces of the side, the
    on-side piece of cut faces, zero weights otherwise."""
    fp = cc.g.face_pts
    cut = cc.face_loc == LOC_CUT
    p0 = torch.where((cut & (cc.fnode_loc[..., 0] != side))[..., None],
                     cc.face_isect, fp[..., 0, :])
    p1 = torch.where((cut & (cc.fnode_loc[..., 1] != side))[..., None],
                     cc.face_isect, fp[..., 1, :])
    pts, w = segment_rule(p0, p1, degree)
    return pts, w * (cut | (cc.face_loc == side))[..., None]


def _interface(cc: CutCells, side_bar, degree: int):
    """GL on each interface segment, signed by a probe from the side's
    barycenter (integrate_interface, cuthho_geom.hpp:851-895)."""
    line = cc.interface
    va = line[:, 0] - side_bar
    t = line[:, 1] - line[:, 0]
    sign = torch.where(torch.sum(va * torch.stack([t[:, 1], -t[:, 0]], -1),
                                 dim=-1) < 0, -1.0, 1.0).to(line.dtype)
    pts, w = segment_rule(line[:, :-1], line[:, 1:], degree)
    Cc = line.shape[0]
    return pts.reshape(Cc, -1, 2), (w * sign[:, None, None]).reshape(Cc, -1)


def cut_operator(cc: CutCells, phi: Circle, k: int, eta: float,
                 side: int = LOC_NEG):
    """lc [Cc, d, d]: the Nitsche reconstruction on the side plus the
    side-restricted naive stabilization."""
    r, cbs, fbs = k + 1, cell_basis_size(k + 1), k + 1
    rbs = cbs
    g = cc.g
    Cc = g.pts.shape[0]
    tp, count, sbar = side_polygon(cc, side)
    qp, qw = fan_rule(tp, count, sbar, 2 * r)
    dphi = cell_grads(qp, g.bar[:, None], g.diam[:, None], r)
    stiff = torch.einsum("cq,cqix,cqjx->cij", qw, dphi, dphi)
    ip, iw = _interface(cc, sbar, 2 * r)
    iphi = cell_basis(ip, g.bar[:, None], g.diam[:, None], r)
    idn = torch.einsum("cqix,cqx->cqi", cell_grads(
        ip, g.bar[:, None], g.diam[:, None], r), phi.normal(ip))
    A = torch.einsum("cq,cqi,cqj->cij", iw, iphi, idn)
    M = torch.einsum("cq,cqi,cqj->cij", iw, iphi, iphi)
    stiff = stiff - A - A.transpose(1, 2) + M * (eta / g.meas)[:, None, None]

    fbar, fbase, fh = _face_data(g.face_pts)
    fpts, fw = _side_faces(cc, 2 * r, side)
    cphi = cell_basis(fpts, g.bar[:, None, None], g.diam[:, None, None], r)
    fdn = torch.einsum("cfqrx,cfx->cfqr", cell_grads(
        fpts, g.bar[:, None, None], g.diam[:, None, None], r), g.normals)
    fphi = face_basis(fpts, fbar[:, :, None], fbase[:, :, None],
                      fh[:, :, None], k)
    fblk = torch.einsum("cfq,cfqr,cfqb->cfrb", fw, fdn, fphi)
    corr = torch.einsum("cfq,cfqr,cfqt->crt", fw, fdn, cphi[..., :cbs])
    gr = torch.cat([stiff[:, :, :cbs] - corr,
                    fblk.permute(0, 2, 1, 3).reshape(Cc, rbs, 4 * fbs)], dim=2)
    lc = torch.einsum("crm,crn->cmn", gr, spd_solve(stiff, gr))

    spts, sw = _side_faces(cc, 2 * k, side)
    sc = cell_basis(spts, g.bar[:, None, None], g.diam[:, None, None], r)
    sf = face_basis(spts, fbar[:, :, None], fbase[:, :, None],
                    fh[:, :, None], k)
    mass = torch.einsum("cfq,cfqi,cfqj->cfij", sw, sf, sf)
    trace = torch.einsum("cfq,cfqi,cfqt->cfit", sw, sf, sc)
    return lc + _stabilization(mass, trace, g.meas,
                               torch.sum(torch.abs(sw), dim=-1) > 0)


def cut_load(cc: CutCells, phi: Circle, k: int, eta: float, f, u,
             side: int = LOC_NEG):
    """[Cc, cbs]: the side source at quadrature 2(k+1) plus the Nitsche
    lifting of the Dirichlet data u on the interface, at quadrature k+1
    (cuthho_square.cpp:623-666)."""
    r = k + 1
    g = cc.g
    tp, count, sbar = side_polygon(cc, side)
    qp, qw = fan_rule(tp, count, sbar, 2 * r)
    phi_q = cell_basis(qp, g.bar[:, None], g.diam[:, None], r)
    out = torch.einsum("cq,cqi,cq->ci", qw, phi_q, f(qp))
    ip, iw = _interface(cc, sbar, r)
    iphi = cell_basis(ip, g.bar[:, None], g.diam[:, None], r)
    idn = torch.einsum("cqix,cqx->cqi", cell_grads(
        ip, g.bar[:, None], g.diam[:, None], r), phi.normal(ip))
    lift = iphi * (eta / g.meas)[:, None, None] - idn
    return out + torch.einsum("cq,cq,cqi->ci", iw, u(ip), lift)


# --------------------------------------------------------------------------
# the manufactured problem and the judgement of a solution
# --------------------------------------------------------------------------

def exact_u(p):
    return torch.sin(np.pi * p[..., 0]) * torch.sin(np.pi * p[..., 1])


def exact_f(p):
    return 2 * np.pi ** 2 * exact_u(p)


def exact_grad(p):
    x, y = np.pi * p[..., 0], np.pi * p[..., 1]
    return np.pi * torch.stack([torch.cos(x) * torch.sin(y),
                                torch.sin(x) * torch.cos(y)], dim=-1)


class Judgement(NamedTuple):
    face_res: float   # |sum A_F u| / |condensed rhs|, interior faces
    cell_res: float   # |A_TT uT + A_TF uF - f_T| / |f_T|, all cells
    h1: float         # H1 error of uT on the physical side
    n_cut: int


def judge(N: int, k: int, radius: float, center, refsteps: int, eta: float,
          local, device) -> Judgement:
    """The residuals and the H1 error of the per-cell unknowns ``local``
    [N*N, cbs + 4(k+1)] (uT, then uF face by face in local order, each in
    the basis of its face's ascending point-id orientation), float64."""
    dt = torch.float64
    grid = make_grid(N, device, dt)
    phi = Circle(radius, *center)
    cls = classify(grid, phi, refsteps)
    cbs, fbs = cell_basis_size(k + 1), k + 1
    C, F = N * N, grid.face_ptids.shape[0]
    rF = torch.zeros((F, fbs), dtype=dt, device=device)
    bF = torch.zeros_like(rF)
    sums = torch.zeros(3, dtype=dt, device=device)   # |r_T|^2, |f_T|^2, H1^2

    def accumulate(cells, lc, fT, g, grads_rule):
        u = local[cells.to(local.device)].to(device=device, dtype=dt)
        uT, uF = u[:, :cbs], u[:, cbs:]
        rT = torch.einsum("cij,cj->ci", lc[:, :cbs], u) - fT
        yF = torch.einsum("cij,cj->ci", lc[:, cbs:], u)
        z = spd_solve(lc[:, :cbs, :cbs], fT[..., None])[..., 0]
        bT = -torch.einsum("cji,cj->ci", lc[:, :cbs, cbs:], z)
        faces = grid.cell_faces[cells].reshape(-1)
        rF.index_add_(0, faces, yF.reshape(-1, fbs))
        bF.index_add_(0, faces, bT.reshape(-1, fbs))
        qp, qw, on = grads_rule
        gh = torch.einsum("cqix,ci->cqx", cell_grads(
            qp, g.bar[:, None], g.diam[:, None], k + 1)[:, :, 1:], uT[:, 1:])
        e = torch.sum(qw * torch.sum((exact_grad(qp) - gh) ** 2, -1), dim=1)
        sums.add_(torch.stack([torch.sum(rT * rT), torch.sum(fT * fT),
                               torch.sum(torch.where(on, e, 0.0))]))

    for s in range(0, C, BLOCK):
        cells = torch.arange(s, min(s + BLOCK, C), device=device)
        cells = cells[cls.cell_loc[cells] != LOC_CUT]
        g = geometry(cls.points, grid, cells)
        neg = cls.cell_loc[cells] == LOC_NEG
        fT = torch.where(neg[:, None], fitted_load(g, k, exact_f), 0.0)
        qp, qw = quad_rule(g.pts, 2 * (k + 1))
        accumulate(cells, fitted_operator(g, k), fT, g, (qp, qw, neg))

    cc = cut_cells(grid, cls)
    tp, count, sbar = side_polygon(cc, LOC_NEG)
    qp, qw = fan_rule(tp, count, sbar, 2 * (k + 1))
    accumulate(cls.cut_ids, cut_operator(cc, phi, k, eta),
               cut_load(cc, phi, k, eta, exact_f, exact_u), cc.g,
               (qp, qw, torch.ones_like(cls.cut_ids, dtype=torch.bool)))

    inner = ~grid.face_bnd
    rT2, fT2, h2 = sums.tolist()
    return Judgement(
        float(torch.linalg.vector_norm(rF[inner]) /
              torch.linalg.vector_norm(bF[inner])),
        (rT2 / fT2) ** 0.5, h2 ** 0.5, int(len(cls.cut_ids)))
