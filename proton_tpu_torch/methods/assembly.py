"""Global assembly as gather / batched product / indexed-add scatter
(JAX counterpart: proton_tpu/methods/assembly.py; reference
assembler<Mesh>, hho.hpp:252-463).

DOF layout of the reference: all cell dofs [0, C*cbs), then the
non-Dirichlet face dofs in the order of a compress table that skips
Dirichlet faces (hho.hpp:298-335). The operator stays matrix-free: the
local matrices lc [C, d, d] stay on the device and A @ x is

    gather  x_loc = x_ext[asm_idx]      (Dirichlet/padded slots read 0)
    batched y_loc = lc @ x_loc
    scatter y     = index_add(y_loc)    (Dirichlet/padded slots land in
                                         a sentinel bin that is dropped)

Duplicate indices must accumulate, so every scatter is ``index_add_`` on
an ``n_dofs + 1`` vector: ``y[idx] += v`` would keep only one of them.
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
class FaceIncidence:
    """Transpose of the cell -> face map, for the gather-based apply.

    face_cells [F, 2]: the (<= 2) cells owning each face; missing -> C.
    face_slot  [F, 2]: the local edge index of the face within that cell.
    expand [n_other_faces]: face id of each compressed free face (the
    assembler's expand_table, hho.hpp:310-323).
    """

    face_cells: torch.Tensor
    face_slot: torch.Tensor
    expand: torch.Tensor


@dataclasses.dataclass(frozen=True)
class DofMap:
    """asm_idx [C, d] global dof of each local dof (sentinel n_dofs on
    Dirichlet/padded slots); free_local [C, d]; dirichlet_local [C, d]
    (local dofs on a Dirichlet face); face_compress [F] (compressed index
    of non-Dirichlet faces, junk on Dirichlet ones); is_dirichlet_face
    [F]."""

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


def build_dofmap(mesh, hdi: HHODegreeInfo) -> DofMap:
    """The assembler tables (assembler ctor, hho.hpp:298-335), built on
    the host from the mesh's index arrays and placed on the mesh's
    device."""
    cbs = bases.cell_basis_size(hdi.cell_degree)
    fbs = bases.face_basis_size(hdi.face_degree)
    C, nF = mesh.num_cells, mesh.max_pts
    d = cbs + nF * fbs

    is_dir = mesh.face_bnd.cpu().numpy() == BND_DIRICHLET
    compress = np.cumsum(~is_dir) - 1
    n_dofs = C * cbs + int((~is_dir).sum()) * fbs

    cell_faces = mesh.cell_faces.cpu().numpy()
    edge_valid = np.arange(nF)[None, :] < mesh.cell_npts.cpu().numpy()[:, None]
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
        return torch.as_tensor(a, device=mesh.points.device)

    return DofMap(asm_idx=t(asm_idx), free_local=t(asm_idx < n_dofs),
                  dirichlet_local=t(dirichlet_local),
                  face_compress=t(compress.astype(np.int64)),
                  is_dirichlet_face=t(is_dir), cbs=cbs, fbs=fbs, n_cells=C,
                  n_dofs=n_dofs)


def build_dofmap_structured(N: int, hdi: HHODegreeInfo, *,
                            device) -> DofMap:
    """build_dofmap of the generated N x N mesh, built on the host from
    the closed-form topology and moved to ``device``."""
    dm = build_dofmap(make_poly_mesh(Nx=N, Ny=N, device="cpu"), hdi)
    return dataclasses.replace(dm, **{
        f: getattr(dm, f).to(device) for f in (
            "asm_idx", "free_local", "dirichlet_local", "face_compress",
            "is_dirichlet_face")})


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


def scatter_values(asm_idx, n_dofs: int, values):
    """Sum values [..., d] into a global vector [n_dofs] by asm_idx,
    accumulating duplicates; indices == n_dofs are dropped."""
    y = torch.zeros(n_dofs + 1, dtype=values.dtype, device=values.device)
    y.index_add_(0, asm_idx.reshape(-1), values.reshape(-1))
    return y[:n_dofs]


def gather_values(asm_idx, x):
    """x_ext[asm_idx] with x_ext = [x, 0]: sentinel slots read 0."""
    return torch.cat([x, x.new_zeros(1)])[asm_idx]


def _scatter(dofmap: DofMap, values_loc):
    return scatter_values(dofmap.asm_idx, dofmap.n_dofs, values_loc)


def gather_local(dofmap: DofMap, x):
    """x_loc [C, d] with zeros in Dirichlet/padded slots."""
    return gather_values(dofmap.asm_idx, x)


def _apply_local(lc, x_loc):
    return torch.bmm(lc, x_loc[..., None])[..., 0]


def make_operator(dofmap: DofMap, lc):
    """Matrix-free SPD operator A(x) from local matrices lc [C, d, d]."""

    def apply_A(x):
        return _scatter(dofmap, _apply_local(lc, gather_local(dofmap, x)))

    return apply_A


def operator_diagonal(dofmap: DofMap, lc):
    """diag(A) for the Jacobi preconditioner (solver_cg.hpp:78-81)."""
    return _scatter(dofmap, torch.diagonal(lc, dim1=1, dim2=2))


def assemble_rhs(dofmap: DofMap, cell_loads, lc, g_loc=None):
    """Global RHS [n_dofs]: cell loads [C, cbs] on the cell dofs
    (hho.hpp:405), Dirichlet data folded in as RHS -= lc @ g_loc
    (hho.hpp:396-402)."""
    C, d = dofmap.asm_idx.shape
    loads = cell_loads.new_zeros((C, d))
    loads[:, :cell_loads.shape[1]] = cell_loads
    if g_loc is not None:
        loads = loads - _apply_local(lc, g_loc)
    return _scatter(dofmap, loads)


def take_local_data(dofmap: DofMap, solution, g_loc=None):
    """Per-cell solution vectors [C, d] from the global solution, with
    the Dirichlet data put back (take_local_data, hho.hpp:408-449)."""
    x_loc = gather_local(dofmap, solution)
    return x_loc if g_loc is None else x_loc + g_loc


def build_face_incidence(mesh, dofmap: DofMap) -> FaceIncidence:
    """Transpose of cell_faces for the gather-based apply, built on the
    host and placed on the mesh's device."""
    cell_faces = mesh.cell_faces.cpu().numpy()
    C, nF = cell_faces.shape
    F = mesh.num_faces
    edge_valid = np.arange(nF)[None, :] < mesh.cell_npts.cpu().numpy()[:, None]
    f_flat = cell_faces[edge_valid]
    c_flat = np.broadcast_to(np.arange(C)[:, None], (C, nF))[edge_valid]
    k_flat = np.broadcast_to(np.arange(nF)[None, :], (C, nF))[edge_valid]
    order = np.argsort(f_flat, kind="stable")
    fs, cs, ks = f_flat[order], c_flat[order], k_flat[order]
    first = np.concatenate([[True], fs[1:] != fs[:-1]])
    group_start = np.maximum.accumulate(np.where(first,
                                                 np.arange(len(fs)), 0))
    occ = np.arange(len(fs)) - group_start          # 0 or 1 per entry
    face_cells = np.full((F, 2), C, dtype=np.int64)
    face_slot = np.zeros((F, 2), dtype=np.int64)
    face_cells[fs, occ] = cs
    face_slot[fs, occ] = ks
    expand = np.nonzero(~dofmap.is_dirichlet_face.cpu().numpy())[0]
    dev = mesh.points.device
    return FaceIncidence(torch.as_tensor(face_cells, device=dev),
                         torch.as_tensor(face_slot, device=dev),
                         torch.as_tensor(expand, device=dev))


def _incidence_gather(inc: FaceIncidence, contrib, offset: int, fbs: int):
    """[n_other_faces * fbs] sums of the <= 2 owning cells' rows of the
    face slots, read from contrib [C, width] through the incidence."""
    ext = torch.cat([contrib, contrib.new_zeros((1, contrib.shape[1]))])
    span = torch.arange(fbs, device=contrib.device)
    fvals = 0.0
    for copy in range(2):
        cols = offset + inc.face_slot[:, copy, None] * fbs + span
        fvals = fvals + ext[inc.face_cells[:, copy, None], cols]
    return fvals[inc.expand].reshape(-1)


def make_gather_operator(dofmap: DofMap, inc: FaceIncidence, lc):
    """A @ x with no scatter: cell rows are written directly (a cell dof
    belongs to one cell) and face rows gather the <= 2 owning cells'
    contributions through the FaceIncidence transpose."""
    C = dofmap.asm_idx.shape[0]
    cbs, fbs = dofmap.cbs, dofmap.fbs

    def apply_A(x):
        contrib = _apply_local(lc, gather_local(dofmap, x))
        return torch.cat([contrib[:, :cbs].reshape(C * cbs),
                          _incidence_gather(inc, contrib, cbs, fbs)])

    return apply_A


# Multi-block machinery (the doubled-dof interface assembler,
# cuthho_square.cpp:1091-1443): a block is (asm_idx [n, d], lc [n, d, d])
# with the same sentinel convention.

def make_multi_operator(n_dofs: int, blocks):
    """Matrix-free operator from several (asm_idx, lc) blocks."""

    def apply_A(x):
        y = x.new_zeros(n_dofs)
        for asm_idx, lc in blocks:
            y = y + scatter_values(asm_idx, n_dofs,
                                   _apply_local(lc, gather_values(asm_idx,
                                                                  x)))
        return y

    return apply_A


def multi_operator_diagonal(n_dofs: int, blocks):
    lc0 = blocks[0][1]
    d = lc0.new_zeros(n_dofs)
    for asm_idx, lc in blocks:
        d = d + scatter_values(asm_idx, n_dofs,
                               torch.diagonal(lc, dim1=1, dim2=2))
    return d


def multi_assemble_rhs(n_dofs: int, contributions):
    """Global RHS from (asm_idx [n, d], values [n, d]) contributions."""
    rhs = contributions[0][1].new_zeros(n_dofs)
    for asm_idx, vals in contributions:
        rhs = rhs + scatter_values(asm_idx, n_dofs, vals)
    return rhs


def assemble_bcoo(dofmap: DofMap, lc):
    """The explicit sparse matrix of the system, a coalesced
    ``torch.sparse_coo_tensor`` (duplicates summed, Dirichlet and padded
    rows and columns dropped), for tests, the direct solve and dumps
    (dump_sparse_matrix, utils.hpp:376-386)."""
    C, d = dofmap.asm_idx.shape
    rows = dofmap.asm_idx[:, :, None].expand(C, d, d)
    cols = dofmap.asm_idx[:, None, :].expand(C, d, d)
    keep = (rows < dofmap.n_dofs) & (cols < dofmap.n_dofs)
    idx = torch.stack([rows[keep], cols[keep]])
    return torch.sparse_coo_tensor(idx, lc[keep],
                                   (dofmap.n_dofs, dofmap.n_dofs),
                                   check_invariants=False).coalesce()
