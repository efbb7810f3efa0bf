"""Degree-of-freedom map and Dirichlet data of the generated mesh (JAX
counterpart: proton_tpu/methods/assembly.py; reference
assembler<Mesh>, hho.hpp:252-463).

DOF layout of the reference: all cell dofs [0, C*cbs), then the
non-Dirichlet face dofs in the order of a compress table that skips
Dirichlet faces (hho.hpp:298-335). Dirichlet and padded slots point at
the sentinel index ``n_dofs``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import bases
from ..core.mesh import BND_DIRICHLET, make_poly_mesh
from ..core.ops import HHODegreeInfo, cho_solve_batched, face_mass_matrices, \
    face_rhs


@dataclasses.dataclass(frozen=True)
class DofMap:
    """asm_idx [C, d] global dof of each local dof (sentinel n_dofs on
    Dirichlet/padded slots); free_local [C, d]; dirichlet_local [C, d];
    face_compress [F]; is_dirichlet_face [F]."""

    asm_idx: torch.Tensor
    free_local: torch.Tensor
    dirichlet_local: torch.Tensor
    face_compress: torch.Tensor
    is_dirichlet_face: torch.Tensor
    cbs: int = 0
    fbs: int = 0
    n_cells: int = 0
    n_dofs: int = 0

    @property
    def d(self) -> int:
        return self.asm_idx.shape[1]


def build_dofmap_structured(N: int, hdi: HHODegreeInfo, *,
                            device) -> DofMap:
    """DofMap of the generated N x N mesh, built on the host from the
    closed-form topology (assembler ctor, hho.hpp:298-335) and moved to
    ``device``."""
    mesh = make_poly_mesh(Nx=N, Ny=N, device="cpu")
    cbs = bases.cell_basis_size(hdi.cell_degree)
    fbs = bases.face_basis_size(hdi.face_degree)
    C, nF = mesh.num_cells, mesh.max_pts
    d = cbs + nF * fbs

    is_dir = mesh.face_bnd.numpy() == BND_DIRICHLET
    compress = np.cumsum(~is_dir) - 1
    n_dofs = C * cbs + int((~is_dir).sum()) * fbs

    cell_faces = mesh.cell_faces.numpy()
    edge_valid = np.arange(nF)[None, :] < mesh.cell_npts.numpy()[:, None]
    asm_idx = np.empty((C, d), dtype=np.int64)
    asm_idx[:, :cbs] = np.arange(C)[:, None] * cbs + np.arange(cbs)[None, :]
    face_base = C * cbs + compress[cell_faces] * fbs
    face_idx = face_base[:, :, None] + np.arange(fbs)[None, None, :]
    dir_face = is_dir[cell_faces]
    face_idx = np.where((dir_face | ~edge_valid)[:, :, None], n_dofs,
                        face_idx)
    asm_idx[:, cbs:] = face_idx.reshape(C, nF * fbs)

    dirichlet_local = np.zeros((C, d), dtype=bool)
    dirichlet_local[:, cbs:] = np.repeat(dir_face & edge_valid, fbs, axis=1)

    def t(a):
        return torch.as_tensor(a, device=device)

    return DofMap(asm_idx=t(asm_idx), free_local=t(asm_idx < n_dofs),
                  dirichlet_local=t(dirichlet_local),
                  face_compress=t(compress.astype(np.int64)),
                  is_dirichlet_face=t(is_dir), cbs=cbs, fbs=fbs, n_cells=C,
                  n_dofs=n_dofs)


def dirichlet_face_data(mesh, hdi: HHODegreeInfo, bc_fn):
    """L2 projection of the boundary function onto every face's basis
    [F, fbs] (hho.hpp:381-386); only the Dirichlet rows are read."""
    fpts = mesh.points[mesh.face_ptids]
    mass = face_mass_matrices(fpts, hdi.face_degree)
    rhs = face_rhs(fpts, hdi.face_degree, bc_fn)
    return cho_solve_batched(mass, rhs[..., None])[..., 0]


def local_dirichlet_data(dofmap: DofMap, mesh, face_data):
    """g_loc [C, d]: the per-face boundary projections on Dirichlet face
    slots, zeros elsewhere (hho.hpp:368-387)."""
    C = dofmap.asm_idx.shape[0]
    g_faces = face_data[mesh.cell_faces].reshape(C, mesh.max_pts * dofmap.fbs)
    g_loc = torch.cat([torch.zeros((C, dofmap.cbs), dtype=face_data.dtype,
                                   device=face_data.device), g_faces], dim=1)
    return torch.where(dofmap.dirichlet_local, g_loc,
                       torch.zeros_like(g_loc))
