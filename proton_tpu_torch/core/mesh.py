"""Structure-of-arrays mesh: the generated structured grid and the
polygonal text-format loader (JAX counterpart: proton_tpu/core/mesh.py).

Conventions mirrored from the reference:

- Point grid is row-major, j (y) outer / i (x) inner
  (basic_mesh.hpp:239-251).
- Quad cell point ids are (bl, br, tr, tl), counter-clockwise.
- Faces store their two point ids sorted ascending, and the global face
  list is sorted lexicographically and deduplicated
  (basic_mesh.hpp:289-291); face k of a cell joins local points
  (k, k+1 mod n).
- Every boundary face of a generated mesh is DIRICHLET.

Polygonal meshes are stored padded: ``cell_ptids`` [C, Pmax] repeats the
last valid point id in the padding slots, so padded edges are degenerate,
and ``cell_faces`` repeats the cell's last face there. The topology is
built with NumPy on the host, then moved to the device.

Index arrays are int64 (torch's index type); coordinates take the caller's
dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import DEFAULT_DTYPE, resolve_device

# boundary condition codes (the reference's `boundary` enum,
# basic_mesh.hpp:105-111)
BND_NONE = 0
BND_DIRICHLET = 1
BND_NEUMANN = 2
BND_ROBIN = 3


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


def _dedupe_faces(raw_faces: np.ndarray, raw_bnd: np.ndarray):
    """Sort faces lexicographically by (p0, p1), deduplicate, and take the
    largest boundary code of the duplicates (sort + unique,
    basic_mesh.hpp:290-291). Returns (faces, inverse, codes)."""
    uniq, inverse = np.unique(raw_faces, axis=0, return_inverse=True)
    bnd = np.zeros(len(uniq), dtype=np.int8)
    np.maximum.at(bnd, inverse.reshape(-1), raw_bnd)
    return uniq, inverse.reshape(-1), bnd


def _cell_edges(cell_ptids: np.ndarray, cell_npts: np.ndarray):
    """(p0, p1, valid) [C, Pmax]: edge k joins points (k, k+1 mod n),
    unsorted within the pair; padded slots give the degenerate edge
    (last, last)."""
    Pmax = cell_ptids.shape[1]
    k = np.arange(Pmax)[None, :]
    n = cell_npts[:, None]
    valid = k < n
    i0 = np.minimum(k, n - 1)
    i1 = np.where(valid, np.where(k + 1 < n, k + 1, 0), i0)
    return (np.take_along_axis(cell_ptids, i0, axis=1),
            np.take_along_axis(cell_ptids, i1, axis=1), valid)


def _mesh_to(points, cell_ptids, cell_npts, cell_faces, face_ptids,
             face_bnd, kind: str, device, dtype) -> Mesh:
    def idx(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    return Mesh(
        points=torch.as_tensor(points, dtype=dtype, device=device),
        cell_ptids=idx(cell_ptids),
        cell_npts=idx(cell_npts),
        cell_faces=idx(cell_faces),
        face_ptids=idx(face_ptids),
        face_bnd=torch.as_tensor(np.asarray(face_bnd, dtype=np.int8),
                                 device=device),
        kind=kind,
        all_quads=bool((np.asarray(cell_npts) == 4).all()),
    )


def _build_topology(points: np.ndarray, cell_ptids: np.ndarray,
                    cell_npts: np.ndarray, raw_bnd_fn, kind: str, *,
                    device, dtype=DEFAULT_DTYPE) -> Mesh:
    """Face extraction, deduplication and per-cell face ids on the host
    (NumPy), then the arrays on ``device``. ``raw_bnd_fn(lo, hi, valid)``
    gives the boundary code of every cell edge [C, Pmax]."""
    C, Pmax = cell_ptids.shape
    p0, p1, valid = _cell_edges(cell_ptids, cell_npts)
    lo, hi = np.minimum(p0, p1), np.maximum(p0, p1)
    raw_bnd = raw_bnd_fn(lo, hi, valid).astype(np.int8).ravel()
    raw = np.stack([lo.ravel(), hi.ravel()], axis=1)
    # padded (degenerate) edges are not faces: dedupe the valid edges only
    valid_flat = valid.ravel()
    uniq, inverse, bnd = _dedupe_faces(raw[valid_flat], raw_bnd[valid_flat])

    face_of_edge = np.zeros(C * Pmax, dtype=np.int64)
    face_of_edge[valid_flat] = inverse
    face_of_edge = face_of_edge.reshape(C, Pmax)
    last = np.maximum(cell_npts[:, None] - 1, 0)
    face_of_edge = np.where(valid, face_of_edge,
                            np.take_along_axis(face_of_edge, last, axis=1))
    return _mesh_to(points, cell_ptids, cell_npts, face_of_edge, uniq, bnd,
                    kind, device, dtype)


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

    return _mesh_to(points, cell_ptids, np.full(Nx * Ny, 4), cell_faces,
                    face_ptids, face_bnd, kind, device, dtype)


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


def load_poly_mesh(filename: str, *, device=None,
                   dtype=DEFAULT_DTYPE) -> Mesh:
    """Text-format polygonal mesh loader (mesh_impl<T,0>::mesh_impl(string),
    basic_mesh.hpp:405-475).

    Format: #points; x y per point; #cells; per cell: npts domain ids...;
    #boundary-faces; per face: domain p0 p1 (marked DIRICHLET). Cells are
    sorted by their point-id lists, as the reference does
    (basic_mesh.hpp:452).
    """
    device = resolve_device(device)
    with open(filename) as fh:
        tokens = fh.read().split()
    pos = 0

    def take(n):
        nonlocal pos
        out = tokens[pos:pos + n]
        pos += n
        return out

    npoints = int(take(1)[0])
    coords = np.array(take(2 * npoints), dtype=np.float64).reshape(npoints, 2)

    ncells = int(take(1)[0])
    cells = []
    for _ in range(ncells):
        n = int(take(1)[0])
        take(1)  # domain id (unused, as in the reference loader)
        cells.append([int(t) for t in take(n)])
    cells.sort()
    npts = np.array([len(c) for c in cells], dtype=np.int64)
    cell_ptids = np.zeros((ncells, int(npts.max())), dtype=np.int64)
    for ci, c in enumerate(cells):
        cell_ptids[ci, :len(c)] = c
        cell_ptids[ci, len(c):] = c[-1]

    nbnd = int(take(1)[0])
    pairs = np.array(take(3 * nbnd), dtype=np.int64).reshape(nbnd, 3)[:, 1:]
    bnd_keys = (np.minimum(pairs[:, 0], pairs[:, 1]) * npoints +
                np.maximum(pairs[:, 0], pairs[:, 1]))

    def raw_bnd(lo, hi, valid):
        on = np.isin(lo * npoints + hi, bnd_keys)
        return np.where(on, BND_DIRICHLET, BND_NONE)

    return _build_topology(coords, cell_ptids, npts, raw_bnd, "poly",
                           device=device, dtype=dtype)


def unit_cell_mesh(h: float, *, device=None) -> Mesh:
    """The one-cell quad mesh [0, h]^2 in float64: the uniform cell of the
    generated mesh of spacing ``h``. The unit-cell operator, the transfer
    matrices and their checks all take it from here, so they see one set
    of coordinates."""
    return make_quad_mesh(Nx=1, Ny=1, min_x=0.0, max_x=h, min_y=0.0, max_y=h,
                          device=device, dtype=torch.float64)
