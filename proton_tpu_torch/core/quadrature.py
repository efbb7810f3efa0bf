"""Quadrature rules, batched over whole element sets (JAX counterpart:
proton_tpu/core/quadrature.py; reference quadratures.hpp).

- 1D Gauss-Legendre on [-1, 1]: an even requested degree d is bumped to
  d+1, then n = (d+1)/2 nodes are used (quadratures.hpp:78-95). Host numpy
  tables; the device rules cast them to the input dtype.
- Quad cells: tensor-product GL through the bilinear map with the
  analytic Jacobian (quadratures.hpp:311-375).
- Polygonal cells: fan triangulation from the barycenter, one triangle
  rule per edge (quadratures.hpp:377-402).
- Faces: GL on the segment, weight scaled by length/2
  (quadratures.hpp:404-432).

Triangles use collapsed (Duffy) tensor rules of arbitrary degree, as the
JAX package does, instead of the reference's Dunavant tables.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Host-side 1D rules
# ---------------------------------------------------------------------------

def _gl_num_nodes(degree: int) -> int:
    """Node-count rule of gauss_legendre (quadratures.hpp:81-87): even
    degrees are bumped by one, then n = (degree+1)/2."""
    if degree % 2 == 0:
        degree += 1
    return (degree + 1) // 2


@lru_cache(maxsize=None)
def gauss_legendre(degree: int) -> Tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre nodes/weights on [-1, 1] exact to ``degree``
    (quadratures.hpp:78-158). Returns (x [n], w [n]), sum(w) == 2."""
    n = _gl_num_nodes(degree)
    x, w = np.polynomial.legendre.leggauss(n)
    return x.astype(np.float64), w.astype(np.float64)


@lru_cache(maxsize=None)
def golub_welsch(degree: int) -> Tuple[np.ndarray, np.ndarray]:
    """Golub-Welsch construction via the Jacobi-matrix eigendecomposition
    (quadratures.hpp:32-75); agrees with :func:`gauss_legendre` to machine
    precision."""
    n = _gl_num_nodes(degree)
    if n == 1:
        return np.zeros(1), np.full(1, 2.0)
    i = np.arange(1, n)
    beta = np.sqrt(1.0 / (4.0 - 1.0 / (i * i)))
    J = np.diag(beta, -1) + np.diag(beta, 1)
    nodes, vecs = np.linalg.eigh(J)
    weights = 2.0 * vecs[0, :] ** 2
    return nodes, weights


@lru_cache(maxsize=None)
def duffy_triangle(degree: int) -> Tuple[np.ndarray, np.ndarray]:
    """Collapsed (Duffy) tensor rule on the reference triangle, exact for
    total degree ``degree``. Returns (lam [n, 3], wbar [n]) with
    barycentric coordinates and weights summing to 1."""
    degree = max(degree, 1)
    nu = (degree + 1) // 2 + 1
    nv = (degree + 2) // 2
    xu, wu = np.polynomial.legendre.leggauss(nu)
    xv, wv = np.polynomial.legendre.leggauss(nv)
    u = (xu + 1.0) / 2.0
    v = (xv + 1.0) / 2.0
    wu = wu / 2.0
    wv = wv / 2.0
    U, V = np.meshgrid(u, v, indexing="ij")
    WU, WV = np.meshgrid(wu, wv, indexing="ij")
    x = U.ravel()
    y = (V * (1.0 - U)).ravel()
    w = (WU * WV * (1.0 - U)).ravel()  # sums to 1/2 == unit triangle area
    lam = np.stack([1.0 - x - y, x, y], axis=1)
    return lam, 2.0 * w


# ---------------------------------------------------------------------------
# Device-side batched rules
# ---------------------------------------------------------------------------

class QuadRule(NamedTuple):
    """Batched quadrature: points [..., Q, 2] and weights [..., Q]."""

    pts: torch.Tensor
    w: torch.Tensor


def _table(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def triangle_rule(p0, p1, p2, degree: int) -> QuadRule:
    """Batched physical-triangle rule (quadratures.hpp:238-271).
    p0/p1/p2: [..., 2]."""
    lam_np, wbar_np = duffy_triangle(degree)
    lam = _table(lam_np, p0)
    wbar = _table(wbar_np, p0)
    v0 = p1 - p0
    v1 = p2 - p0
    area = 0.5 * torch.abs(v0[..., 0] * v1[..., 1] - v0[..., 1] * v1[..., 0])
    pts = (lam[:, 0, None] * p0[..., None, :] +
           lam[:, 1, None] * p1[..., None, :] +
           lam[:, 2, None] * p2[..., None, :])
    return QuadRule(pts, area[..., None] * wbar)


def quad_cell_rule(pts4, degree: int) -> QuadRule:
    """Tensor GL rule on bilinear quads with the analytic Jacobian
    (quadratures.hpp:311-375). pts4 [..., 4, 2] CCW corners; returns
    points [..., n*n, 2] (x fast, y slow) and weights [..., n*n]."""
    x, w = gauss_legendre(degree)
    xi = _table(np.tile(x, len(x)), pts4)
    eta = _table(np.repeat(x, len(x)), pts4)
    ww = _table(np.repeat(w, len(w)) * np.tile(w, len(w)), pts4)

    p0, p1, p2, p3 = (pts4[..., i, :] for i in range(4))
    s0 = (1 - xi) * (1 - eta)
    s1 = (1 + xi) * (1 - eta)
    s2 = (1 + xi) * (1 + eta)
    s3 = (1 - xi) * (1 + eta)
    pts = 0.25 * (p0[..., None, :] * s0[..., None] +
                  p1[..., None, :] * s1[..., None] +
                  p2[..., None, :] * s2[..., None] +
                  p3[..., None, :] * s3[..., None])
    j11 = 0.25 * ((p1 - p0)[..., None, 0] * (1 - eta) +
                  (p2 - p3)[..., None, 0] * (1 + eta))
    j12 = 0.25 * ((p1 - p0)[..., None, 1] * (1 - eta) +
                  (p2 - p3)[..., None, 1] * (1 + eta))
    j21 = 0.25 * ((p3 - p0)[..., None, 0] * (1 - xi) +
                  (p2 - p1)[..., None, 0] * (1 + xi))
    j22 = 0.25 * ((p3 - p0)[..., None, 1] * (1 - xi) +
                  (p2 - p1)[..., None, 1] * (1 + xi))
    jac = torch.abs(j11 * j22 - j12 * j21)
    return QuadRule(pts, ww * jac)


def poly_cell_rule(pts, npts, bar, degree: int) -> QuadRule:
    """Barycenter-fan rule on padded polygons (quadratures.hpp:377-402):
    one triangle (p_k, p_k+1, bar) per edge. pts [C, P, 2], npts [C],
    bar [C, 2]; padded triangles are degenerate (zero weights)."""
    C, P, _ = pts.shape
    k = torch.arange(P, device=pts.device)[None, :]
    n = npts[:, None]
    valid = k < n
    i1 = torch.where(k + 1 < n, k + 1, 0)
    i1 = torch.where(valid, i1, torch.minimum(k, n - 1))
    e1 = torch.take_along_dim(pts, i1[..., None].expand(C, P, 2), dim=1)
    rule = triangle_rule(pts, e1, bar[:, None, :].expand(C, P, 2), degree)
    Q = rule.w.shape[-1]
    return QuadRule(rule.pts.reshape(C, P * Q, 2), rule.w.reshape(C, P * Q))


def cell_rule(mesh, geom, degree: int) -> QuadRule:
    """integrate(msh, cl, degree) for every cell (quadratures.hpp:311-402);
    all-quad meshes take the tensor-GL bilinear rule."""
    from .geometry import cell_points
    if mesh.kind == "quad" or mesh.all_quads:
        return quad_cell_rule(cell_points(mesh)[..., :4, :], degree)
    return poly_cell_rule(cell_points(mesh), mesh.cell_npts, geom.bar, degree)


def face_rule(fp0, fp1, degree: int) -> QuadRule:
    """GL rule on segments (quadratures.hpp:404-432). fp0/fp1: [..., 2]."""
    x, w = gauss_legendre(degree)
    t = _table(x, fp0)
    ww = _table(w, fp0)
    meas = torch.linalg.vector_norm(fp1 - fp0, dim=-1)
    pts = (0.5 * (1 - t)[:, None] * fp0[..., None, :] +
           0.5 * (1 + t)[:, None] * fp1[..., None, :])
    return QuadRule(pts, 0.5 * meas[..., None] * ww)


def bilinear_ref_to_phys(pts4, ref_pts):
    """The quad reference transform (reference_transform::ref_to_phys,
    quadratures.hpp:274-308): points of [-1,1]^2 through the bilinear map
    of each cell. pts4 [..., 4, 2], ref_pts [R, 2] -> [..., R, 2]."""
    xi = ref_pts[..., 0]
    eta = ref_pts[..., 1]
    s = torch.stack([0.25 * (1 - xi) * (1 - eta),
                     0.25 * (1 + xi) * (1 - eta),
                     0.25 * (1 + xi) * (1 + eta),
                     0.25 * (1 - xi) * (1 + eta)], dim=-1)     # [R, 4]
    return torch.einsum("rk,...kx->...rx", s, pts4)
