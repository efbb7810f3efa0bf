"""Batched mesh geometry (JAX counterpart: proton_tpu/core/geometry.py;
reference basic_geom.hpp).

- barycenter: polygon fan formula with signed areas from p0
  (basic_geom.hpp:247-286)
- diameter: max pairwise point distance (basic_geom.hpp:288-305)
- measure: fan-triangle |area| sum (basic_geom.hpp:317-344)
- normals: per-edge outward unit normal (v.y, -v.x)/|v| for CCW polygons
  (basic_geom.hpp:349-399)
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def cell_points(mesh) -> torch.Tensor:
    """[C, Pmax, 2] coordinates of each cell's points."""
    return mesh.points[mesh.cell_ptids]


def _fan_dets(pts):
    """Signed fan determinants det(p_{i-1}-p0, p_i-p0)/2, i=2..n-1."""
    rel = pts - pts[..., :1, :]
    a = rel[..., 1:-1, :]
    b = rel[..., 2:, :]
    return 0.5 * (a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0])


def polygon_barycenter(pts):
    """Area-weighted barycenter of a padded CCW polygon
    (basic_geom.hpp:247-270). pts [..., P, 2] -> [..., 2]."""
    rel = pts - pts[..., :1, :]
    d = _fan_dets(pts)
    mids = rel[..., 1:-1, :] + rel[..., 2:, :]
    num = torch.sum(mids * d[..., None], dim=-2)
    den = torch.sum(d, dim=-1)
    return pts[..., 0, :] + num / (3.0 * den[..., None])


def polygon_measure(pts):
    """Polygon area: |sum of the signed fan triangle areas| (the shoelace
    formula), right for every simple polygon. The JAX package sums the
    |fan triangle| areas instead; the two agree on convex polygons to the
    last bit, but the JAX sum overcounts a non-convex polygon whose fan
    from its first point folds over, as do the L-shaped cells that
    cut/agglomerate.py merges from 128^2 on."""
    return torch.abs(torch.sum(_fan_dets(pts), dim=-1))


def polygon_diameter(pts):
    """Max pairwise point distance."""
    diff = pts[..., :, None, :] - pts[..., None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    return torch.sqrt(torch.amax(d2, dim=(-2, -1)))


def cell_barycenters(mesh):
    return polygon_barycenter(cell_points(mesh))


def cell_measures(mesh):
    return polygon_measure(cell_points(mesh))


def cell_diameters(mesh):
    return polygon_diameter(cell_points(mesh))


def face_points(mesh):
    """[F, 2, 2] endpoints of every global face in sorted-ptid order (the
    order the face basis direction depends on, bases.hpp:260-262)."""
    return mesh.points[mesh.face_ptids]


def face_barycenters(mesh):
    return torch.mean(face_points(mesh), dim=1)


def face_measures(mesh):
    fp = face_points(mesh)
    return torch.linalg.vector_norm(fp[:, 1] - fp[:, 0], dim=-1)


def cell_edge_vertices(mesh):
    """(e0, e1) [C, Pmax, 2]: local edge k joins points (k, k+1 mod n);
    padded edges are degenerate."""
    pts = cell_points(mesh)
    C, P, _ = pts.shape
    k = torch.arange(P, device=pts.device)[None, :]
    npts = mesh.cell_npts[:, None]
    valid = k < npts
    i1 = torch.where(k + 1 < npts, k + 1, 0)
    i1 = torch.where(valid, i1, torch.minimum(k, npts - 1))
    e1 = torch.take_along_dim(pts, i1[..., None].expand(C, P, 2), dim=1)
    return pts, e1


def cell_normals(mesh):
    """Outward unit normal of each cell edge [C, Pmax, 2]; zero on
    degenerate padded edges."""
    e0, e1 = cell_edge_vertices(mesh)
    v = e1 - e0
    n = torch.stack([v[..., 1], -v[..., 0]], dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    return torch.where(norm > 0, n / safe, torch.zeros_like(n))


class CellGeom(NamedTuple):
    """Per-cell geometry shared by the HHO kernels."""

    bar: torch.Tensor          # [C, 2]
    diam: torch.Tensor         # [C]
    meas: torch.Tensor         # [C]
    normals: torch.Tensor      # [C, Pmax, 2]
    edge_valid: torch.Tensor   # [C, Pmax] bool
    face_pts: torch.Tensor     # [C, Pmax, 2, 2] sorted-ptid orientation
    face_bar: torch.Tensor     # [C, Pmax, 2]
    face_h: torch.Tensor       # [C, Pmax]
    face_ids: torch.Tensor     # [C, Pmax]


def cell_geometry(mesh) -> CellGeom:
    pts = cell_points(mesh)
    k = torch.arange(mesh.max_pts, device=pts.device)[None, :]
    valid = k < mesh.cell_npts[:, None]
    fpts = mesh.points[mesh.face_ptids[mesh.cell_faces]]   # [C, P, 2, 2]
    fbar = torch.mean(fpts, dim=2)
    fh = torch.linalg.vector_norm(fpts[:, :, 1] - fpts[:, :, 0], dim=-1)
    return CellGeom(
        bar=polygon_barycenter(pts),
        diam=polygon_diameter(pts),
        meas=polygon_measure(pts),
        normals=cell_normals(mesh),
        edge_valid=valid,
        face_pts=fpts,
        face_bar=fbar,
        face_h=fh,
        face_ids=mesh.cell_faces,
    )
