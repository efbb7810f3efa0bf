"""Cut-cell integration with static padding (JAX counterpart:
proton_tpu/cut/quadrature.py; reference cuthho_geom.hpp:547-895).

The reference's branchy point collection (collect_triangulation_points,
:675-728) becomes a sort-key assignment: each candidate point gets a key
encoding its position in the reference's traversal order, a stable
argsort produces the padded ordered polygon, and the padded fan rule
integrates it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.geometry import polygon_barycenter
from ..core.quadrature import QuadRule, face_rule, poly_cell_rule
from .classify import LOC_CUT, LOC_NEG


class SidePolygon(NamedTuple):
    """Padded ordered polygon of one side of each cut cell."""

    tp: torch.Tensor      # [Cc, T, 2], padding repeats the last point
    count: torch.Tensor   # [Cc]
    bar: torch.Tensor     # [Cc, 2] fan barycenter


def triangulation_points(cell_pts, cell_npts, node_loc_cells, interface,
                         side: int) -> SidePolygon:
    """collect_triangulation_points (cuthho_geom.hpp:675-728) for a batch
    of cut cells: on-side nodes in local order then the interface (forward
    for NEG, reversed for POS); when the first and last node are both on
    the side, the leading run, the interface, then the trailing run."""
    Cc, P, _ = cell_pts.shape
    R1 = interface.shape[1]
    dev = cell_pts.device
    k = torch.arange(P, device=dev)[None, :]
    valid = k < cell_npts[:, None]
    onside = (node_loc_cells == side) & valid

    first_on = onside[:, 0]
    last_on = torch.take_along_dim(onside, (cell_npts - 1)[:, None],
                                   dim=1)[:, 0]
    case4 = first_on & last_on

    prefix = torch.cumprod(onside.to(torch.int64), dim=1).to(torch.bool)
    onside_or_pad = onside | ~valid
    suffix = torch.flip(torch.cumprod(torch.flip(
        onside_or_pad.to(torch.int64), dims=[1]), dim=1),
        dims=[1]).to(torch.bool)
    trailing = suffix & onside & ~prefix

    BIG = 10 * (P + R1 + 2)
    key_iface = P + torch.arange(R1, device=dev)[None, :]
    key_trail = P + R1 + k
    key_nodes = torch.where(
        onside, torch.where(case4[:, None] & trailing, key_trail, k), BIG)

    iface = interface if side == LOC_NEG else torch.flip(interface, dims=[1])
    all_pts = torch.cat([cell_pts, iface], dim=1)
    keys = torch.cat([key_nodes, key_iface.expand(Cc, R1)], dim=1)
    order = torch.argsort(keys, dim=1, stable=True)
    tp = torch.take_along_dim(all_pts, order[..., None].expand(-1, -1, 2),
                              dim=1)
    count = torch.sum(onside, dim=1) + R1

    slot = torch.arange(P + R1, device=dev)[None, :]
    last_pt = torch.take_along_dim(
        tp, (count - 1)[:, None, None].expand(-1, 1, 2), dim=1)
    tp = torch.where((slot < count[:, None])[..., None], tp, last_pt)
    return SidePolygon(tp, count, polygon_barycenter(tp))


def side_cell_rule(poly: SidePolygon, degree: int) -> QuadRule:
    """Barycenter fan + triangle rule per fan triangle
    (cuthho_geom.hpp:798-815); [Cc, T*Qt] points/weights."""
    return poly_cell_rule(poly.tp, poly.count, poly.bar, degree)


def side_measure(poly: SidePolygon) -> torch.Tensor:
    """measure(msh, cl, where): total fan-triangle area
    (cuthho_geom.hpp:779-796)."""
    return torch.sum(side_cell_rule(poly, 1).w, dim=-1)


def interface_rule(interface, side_bar, degree: int) -> QuadRule:
    """integrate_interface (cuthho_geom.hpp:851-895): GL per polyline
    segment, signed by the side-barycenter probe (:862-870).
    interface [Cc, R+1, 2]; side_bar [Cc, 2] -> [Cc, R*n]."""
    pa = interface[:, 0]
    pb = interface[:, 1]
    va = pa - side_bar
    vb_t = pb - pa
    vb = torch.stack([vb_t[..., 1], -vb_t[..., 0]], dim=-1)
    int_sign = torch.where(torch.sum(va * vb, dim=-1) < 0, -1.0, 1.0)
    int_sign = int_sign.to(interface.dtype)

    rule = face_rule(interface[:, :-1], interface[:, 1:], degree)
    Cc, R, n, _ = rule.pts.shape
    w = rule.w * int_sign[:, None, None]
    return QuadRule(rule.pts.reshape(Cc, R * n, 2), w.reshape(Cc, R * n))


def make_test_points(cell_pts4, phi, side: int, N: int = 10):
    """Reference-grid sample points of each (quad) cell filtered by side
    (make_test_points, cuthho_geom.hpp:898-932): an (N+1)^2 grid mapped
    through the bilinear reference transform, with an on-side mask instead
    of a filtered list. cell_pts4 [..., 4, 2] -> (pts [..., (N+1)^2, 2],
    mask [..., (N+1)^2])."""
    t = np.linspace(-1.0, 1.0, N + 1)
    XI, ETA = np.meshgrid(t, t)
    xi = torch.as_tensor(XI.ravel(), dtype=cell_pts4.dtype,
                         device=cell_pts4.device)
    eta = torch.as_tensor(ETA.ravel(), dtype=cell_pts4.dtype,
                          device=cell_pts4.device)
    s = torch.stack([0.25 * (1 - xi) * (1 - eta), 0.25 * (1 + xi) * (1 - eta),
                     0.25 * (1 + xi) * (1 + eta), 0.25 * (1 - xi) * (1 + eta)])
    p = sum(cell_pts4[..., i, None, :] * s[i][:, None] for i in range(4))
    v = phi(p)
    return p, (v < 0) if side == LOC_NEG else (v > 0)


def side_face_rule(face_pts, face_loc, face_isect, fnode0_loc, fnode1_loc,
                   degree: int, side: int) -> QuadRule:
    """integrate(msh, fc, degree, where) (cuthho_geom.hpp:817-849): the
    full GL rule on faces located on ``side``, GL on the on-side
    sub-segment of cut faces, zero weights elsewhere."""
    cut = face_loc == LOC_CUT
    p0 = face_pts[..., 0, :]
    p1 = face_pts[..., 1, :]
    p0e = torch.where((cut & (fnode0_loc != side))[..., None], face_isect, p0)
    p1e = torch.where((cut & (fnode1_loc != side))[..., None], face_isect, p1)
    rule = face_rule(p0e, p1e, degree)
    live = cut | (face_loc == side)
    return QuadRule(rule.pts, rule.w * live[..., None])
