"""Structure-of-arrays mesh of the generated structured grid (JAX
counterpart: proton_tpu/core/mesh.py, structured path only).

Conventions mirrored from the reference:

- Point grid is row-major, j (y) outer / i (x) inner
  (basic_mesh.hpp:239-251).
- Quad cell point ids are (bl, br, tr, tl), counter-clockwise.
- Faces store their two point ids sorted ascending, and the global face
  list is sorted lexicographically (basic_mesh.hpp:289-291); face k of a
  cell joins local points (k, k+1 mod 4).
- Every boundary face of a generated mesh is DIRICHLET.

Index arrays are int64 (torch's index type); coordinates take the caller's
dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import DEFAULT_DTYPE, resolve_device

BND_NONE = 0
BND_DIRICHLET = 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """points [P, 2]; cell_ptids [C, Pmax]; cell_npts [C];
    cell_faces [C, Pmax] (global face of local edge (pt k, pt k+1));
    face_ptids [F, 2] sorted; face_bnd [F] int8 BND_* codes.
    ``kind`` selects the cell quadrature ("quad" or "poly")."""

    points: torch.Tensor
    cell_ptids: torch.Tensor
    cell_npts: torch.Tensor
    cell_faces: torch.Tensor
    face_ptids: torch.Tensor
    face_bnd: torch.Tensor
    kind: str = "quad"
    all_quads: bool = False

    @property
    def num_points(self) -> int:
        return self.points.shape[0]

    @property
    def num_cells(self) -> int:
        return self.cell_ptids.shape[0]

    @property
    def num_faces(self) -> int:
        return self.face_ptids.shape[0]

    @property
    def max_pts(self) -> int:
        return self.cell_ptids.shape[1]

    def with_points(self, points) -> "Mesh":
        """Same topology, new coordinates (cut node displacement)."""
        return dataclasses.replace(self, points=points)


@dataclasses.dataclass(frozen=True)
class MeshInitParams:
    """Domain box + subdivision counts (mesh_init_params,
    basic_mesh.hpp:178-197)."""

    min_x: float = 0.0
    max_x: float = 1.0
    min_y: float = 0.0
    max_y: float = 1.0
    Nx: int = 4
    Ny: int = 4

    @property
    def hx(self) -> float:
        return (self.max_x - self.min_x) / self.Nx

    @property
    def hy(self) -> float:
        return (self.max_y - self.min_y) / self.Ny


def _structured_topology(params: MeshInitParams, kind: str, device,
                         dtype) -> Mesh:
    """Closed-form topology of the structured generator: the sorted
    lexicographic face order has an explicit formula on the grid (for
    point p=(j,i) its H-edge precedes its V-edge), so every index array
    is vectorized arithmetic."""
    Nx, Ny = params.Nx, params.Ny
    W = Nx + 1

    i = np.arange(W)
    j = np.arange(Ny + 1)
    X, Y = np.meshgrid(params.min_x + i * params.hx,
                       params.min_y + j * params.hy)
    points = np.stack([X.ravel(), Y.ravel()], axis=1)

    def f_H(jj, ii):
        return np.where(jj < Ny, jj * (2 * Nx + 1) + 2 * ii,
                        Ny * (2 * Nx + 1) + ii)

    def f_V(jj, ii):
        return jj * (2 * Nx + 1) + 2 * ii + (ii < Nx)

    ci, cj = np.meshgrid(np.arange(Nx), np.arange(Ny))
    ci, cj = ci.ravel(), cj.ravel()
    pt0 = cj * W + ci
    cell_ptids = np.stack([pt0, pt0 + 1, pt0 + W + 1, pt0 + W], axis=1)
    cell_faces = np.stack([f_H(cj, ci), f_V(cj, ci + 1),
                           f_H(cj + 1, ci), f_V(cj, ci)], axis=1)

    F = (Ny + 1) * Nx + Ny * W
    face_ptids = np.zeros((F, 2), dtype=np.int64)
    face_bnd = np.zeros((F,), dtype=np.int8)
    hi_, hj = np.meshgrid(np.arange(Nx), np.arange(Ny + 1))
    hi_, hj = hi_.ravel(), hj.ravel()
    hidx = f_H(hj, hi_)
    hp = hj * W + hi_
    face_ptids[hidx, 0] = hp
    face_ptids[hidx, 1] = hp + 1
    face_bnd[hidx] = np.where((hj == 0) | (hj == Ny), BND_DIRICHLET,
                              BND_NONE)
    vi, vj = np.meshgrid(np.arange(W), np.arange(Ny))
    vi, vj = vi.ravel(), vj.ravel()
    vidx = f_V(vj, vi)
    vp = vj * W + vi
    face_ptids[vidx, 0] = vp
    face_ptids[vidx, 1] = vp + W
    face_bnd[vidx] = np.where((vi == 0) | (vi == Nx), BND_DIRICHLET,
                              BND_NONE)

    def idx(a):
        return torch.as_tensor(a.astype(np.int64), device=device)

    C = Nx * Ny
    return Mesh(
        points=torch.as_tensor(points, dtype=dtype, device=device),
        cell_ptids=idx(cell_ptids),
        cell_npts=idx(np.full(C, 4)),
        cell_faces=idx(cell_faces),
        face_ptids=idx(face_ptids),
        face_bnd=torch.as_tensor(face_bnd, device=device),
        kind=kind,
        all_quads=True,
    )


def make_quad_mesh(params: Optional[MeshInitParams] = None, *, device=None,
                   dtype=DEFAULT_DTYPE, **kw) -> Mesh:
    """Structured quad mesh of an axis-aligned box (mesh_impl<T,4>,
    basic_mesh.hpp:230-298)."""
    params = params or MeshInitParams(**kw)
    return _structured_topology(params, "quad", resolve_device(device), dtype)


def make_poly_mesh(params: Optional[MeshInitParams] = None, *, device=None,
                   dtype=DEFAULT_DTYPE, **kw) -> Mesh:
    """The same grid stored as a polygonal mesh (mesh_impl<T,0>,
    basic_mesh.hpp:321-403); geometry identical to the quad mesh."""
    params = params or MeshInitParams(**kw)
    return _structured_topology(params, "poly", resolve_device(device), dtype)


def unit_cell_mesh(h: float, *, device=None) -> Mesh:
    """The one-cell quad mesh [0, h]^2 in float64: the uniform cell of the
    generated mesh of spacing ``h``. The unit-cell operator, the transfer
    matrices and their checks all take it from here, so they see one set
    of coordinates."""
    return make_quad_mesh(Nx=1, Ny=1, min_x=0.0, max_x=h, min_y=0.0, max_y=h,
                          device=device, dtype=torch.float64)
