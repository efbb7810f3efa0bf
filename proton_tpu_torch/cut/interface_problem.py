"""Elliptic interface problem with doubled unknowns on cut cells and faces
(JAX counterpart: proton_tpu/cut/interface_problem.py; reference
interface_assembler + run_cuthho_interface,
apps/cuthho/cuthho_square.cpp:1091-1443, 1625-1846).

DOF layout of the reference: all cell blocks first (cut cells own two
consecutive cbs blocks, negative then positive; cell_table holds the
cumulative offsets, :1144-1152), then the non-Dirichlet face blocks (cut
faces own two consecutive fbs blocks, :1155-1182). Dirichlet faces on cut
cells are unsupported, as in the reference (:1305-1307). The reference's
take_local_data reads the faces at the wrong base offset when cut cells
exist (cbs*num_cells instead of cbs*num_all_cells, :1423); this module
uses the right one, as the JAX package does.

Index maps are built on the host with NumPy once and moved to the device
once. Every scatter accumulates duplicate indices (``index_add_``), and
every sentinel slot (``n_dofs`` / ``n_face_dofs``) lands on a real extra
entry that is dropped.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..config import DEFAULT_DTYPE, resolve_device
from ..core import bases, quadrature
from ..core.geometry import cell_geometry
from ..core.mesh import BND_DIRICHLET
from ..core.ops import HHODegreeInfo, cell_rhs, cho_solve_batched, \
    robust_spd_solve, spd_inverse
from ..methods import assembly, condensation, hho
from ..solvers import cg
from ..utils.timing import count, sink, span
from . import methods as cut_methods
from .classify import LOC_CUT, LOC_NEG, LOC_POS, CutData, cut_preprocess
from .levelset import LevelSet
from .methods import CutCellBatch, InterfaceParams, make_cut_batch
from .quadrature import side_cell_rule

DEFAULT_CG = cg.CGParams(convergence_threshold=1e-9,
                         divergence_threshold=1e8, max_iter=200000,
                         apply_preconditioner=True)


@dataclasses.dataclass(frozen=True)
class InterfaceDofMap:
    """Doubled-dof index maps (int64 tensors on the mesh's device).

    asm_uncut [Cun, d']  global dofs of each uncut cell's locals
                         (sentinel n_dofs on Dirichlet face slots)
    asm_cut   [Cc, 2d']  global dofs of each cut cell's doubled locals,
                         local layout [cbs-, cbs+, nfd-, nfd+]
    uncut_ids [Cun], cut_ids [Cc]: the cell ids of each class
    """

    asm_uncut: torch.Tensor
    asm_cut: torch.Tensor
    uncut_ids: torch.Tensor
    cut_ids: torch.Tensor
    dirichlet_uncut: torch.Tensor   # [Cun, d'] bool
    cell_table: torch.Tensor        # [C]
    face_table: torch.Tensor        # [F]
    face_is_cut: torch.Tensor       # [F] bool
    cbs: int = 0
    fbs: int = 0
    num_all_cells: int = 0
    n_dofs: int = 0


def build_interface_dofmap(mesh, cutdata: CutData,
                           hdi: HHODegreeInfo) -> InterfaceDofMap:
    """The interface assembler's tables (interface_assembler ctor,
    cuthho_square.cpp:1137-1194), built on the host."""
    cbs = bases.cell_basis_size(hdi.cell_degree)
    fbs = bases.face_basis_size(hdi.face_degree)
    cell_faces = mesh.cell_faces.cpu().numpy()
    C, nF = cell_faces.shape

    is_dir = mesh.face_bnd.cpu().numpy() == BND_DIRICHLET
    cell_is_cut = cutdata.cell_loc.cpu().numpy() == LOC_CUT
    face_is_cut = cutdata.face_loc.cpu().numpy() == LOC_CUT
    if (is_dir & face_is_cut).any():
        raise ValueError("Dirichlet boundary on cut cell not supported.")

    mult_c = np.where(cell_is_cut, 2, 1)
    cell_table = np.concatenate([[0], np.cumsum(mult_c)[:-1]])
    num_all_cells = int(mult_c.sum())
    mult_f = np.where(is_dir, 0, np.where(face_is_cut, 2, 1))
    face_table = np.concatenate([[0], np.cumsum(mult_f)[:-1]])
    n_dofs = cbs * num_all_cells + fbs * int(mult_f.sum())
    face_base = cbs * num_all_cells

    edge_valid = np.arange(nF)[None, :] < \
        mesh.cell_npts.cpu().numpy()[:, None]
    uncut_ids = np.nonzero(~cell_is_cut)[0]
    cut_ids = np.nonzero(cell_is_cut)[0]
    d = cbs + nF * fbs

    def face_block(f_ids, valid, copy):
        """Global dofs per face slot; copy 0 = first, 1 = second (cut)."""
        base = face_base + face_table[f_ids] * fbs + \
            copy * np.where(face_is_cut[f_ids], fbs, 0)
        dead = is_dir[f_ids] | ~valid
        idx = base[..., None] + np.arange(fbs)[None, None, :]
        return np.where(dead[..., None], n_dofs, idx)

    # uncut cells (assemble(), :1203-1272)
    au = np.empty((len(uncut_ids), d), dtype=np.int64)
    au[:, :cbs] = cell_table[uncut_ids, None] * cbs + np.arange(cbs)
    au[:, cbs:] = face_block(cell_faces[uncut_ids], edge_valid[uncut_ids],
                             0).reshape(len(uncut_ids), nF * fbs)
    dir_u = np.zeros((len(uncut_ids), d), dtype=bool)
    dir_u[:, cbs:] = np.repeat(
        is_dir[cell_faces[uncut_ids]] & edge_valid[uncut_ids], fbs, axis=1)

    # cut cells (assemble_cut(), :1274-1354): [cbs-, cbs+, nfd-, nfd+]
    ac = np.empty((len(cut_ids), 2 * d), dtype=np.int64)
    base_c = cell_table[cut_ids, None] * cbs
    ac[:, :cbs] = base_c + np.arange(cbs)
    ac[:, cbs:2 * cbs] = base_c + cbs + np.arange(cbs)
    for copy, col in ((0, 2 * cbs), (1, 2 * cbs + nF * fbs)):
        ac[:, col:col + nF * fbs] = face_block(
            cell_faces[cut_ids], edge_valid[cut_ids], copy).reshape(
            len(cut_ids), -1)

    def t(a):
        return torch.as_tensor(a, device=mesh.points.device)

    return InterfaceDofMap(
        asm_uncut=t(au), asm_cut=t(ac), uncut_ids=t(uncut_ids),
        cut_ids=t(cut_ids), dirichlet_uncut=t(dir_u),
        cell_table=t(cell_table.astype(np.int64)),
        face_table=t(face_table.astype(np.int64)),
        face_is_cut=t(face_is_cut), cbs=cbs, fbs=fbs,
        num_all_cells=num_all_cells, n_dofs=int(n_dofs))


class InterfaceResult(NamedTuple):
    x: torch.Tensor
    local_neg: torch.Tensor     # [C, d'] per-cell dofs seen from NEG side
    local_pos: torch.Tensor     # [C, d'] per-cell dofs seen from POS side
    h1_error: float
    iterations: int
    exit_reason: int
    rel_residual: float = float("nan")   # CG's relative residual


def _flat_scatter(n: int, idx, vals):
    """zeros(n).index_add_(idx, vals), flattened: duplicates accumulate."""
    return vals.new_zeros(n).index_add_(0, idx.reshape(-1),
                                        vals.reshape(-1))


def _interface_mg_precond(mesh, dm: InterfaceDofMap, n_face_dofs: int,
                          sys_c_S, idx_c, blocks_and_idx, N: int,
                          hdi: HHODegreeInfo, dtype, coarsest: int = 8):
    """Additive two-part preconditioner of the condensed doubled-dof
    interface system on the generated N x N mesh:

      M^-1 = P MG_u^-1 P^T  +  sum_patches w B_cut^-1 w

    MG_u is the uniform fitted V-cycle of solvers/multigrid.py (the
    kappa_1 = kappa_2 operator away from the interface is the fitted
    Poisson stencil): unit-cell levels with no irregular cells, n_smooth
    1, Chebyshev(4), no patch smoother. P injects each structured
    face-grid value into both copies of a doubled face (P^T sums them).
    Every condensed face dof is copy 0 of a non-Dirichlet face or copy 1
    of a cut face, so it has exactly one grid entry: P is one gather
    (``inv``), P^T the copy-0 gather plus the cut faces' second copies,
    and neither writes any entry twice or needs atomics. The band term
    is exact-solve additive Schwarz over the cut cells' condensed blocks
    on their deduplicated face dofs, 1/sqrt(multiplicity)-weighted. Both
    parts are SPD. Every index map is built here, on the host, and moved
    to the device once: the returned apply copies nothing from the host
    and reads nothing back. Counts ``iface_copy_sentinel_writes``: the
    entries of P's map that name the sentinel slot instead of a grid
    value (0)."""
    from ..methods.cells_last import GridVecCL
    from ..solvers import multigrid
    from .fictdom_structured import _unit_cell_host

    fbs = dm.fbs
    sent = n_face_dofs
    dev = sys_c_S.device

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    with span("mg_setup", dev):
        # ---- host maps: grid face -> condensed dof start (both copies) ----
        cf = mesh.cell_faces.cpu().numpy()
        cells = np.arange(N * N).reshape(N, N)
        fH = np.empty((N + 1, N), np.int64)
        fH[:N] = cf[cells, 0]
        fH[N] = cf[cells[N - 1], 2]
        fV = np.empty((N, N + 1), np.int64)
        fV[:, :N] = cf[cells, 3]
        fV[:, N] = cf[cells[:, N - 1], 1]
        face_start = dm.face_table.cpu().numpy() * fbs
        is_cut = dm.face_is_cut.cpu().numpy()
        is_dir = mesh.face_bnd.cpu().numpy() == BND_DIRICHLET

        # the V-cycle's grids [fbs, N+1, N] (H) and [fbs, N, N+1] (V),
        # flattened one after the other: face and basis function per entry
        nH = fbs * fH.size
        faces = np.concatenate([np.tile(fH.reshape(-1), fbs),
                                np.tile(fV.reshape(-1), fbs)])
        comp = np.concatenate([np.repeat(np.arange(fbs), fH.size),
                               np.repeat(np.arange(fbs), fV.size)])
        G = faces.size
        dof0 = face_start[faces] + comp
        live0 = ~is_dir[faces]
        cut_pos = np.nonzero(is_cut[faces])[0]
        # P^T: Dirichlet entries read the zero appended to r
        g0 = np.where(live0, dof0, sent)
        cut_dof = dof0[cut_pos] + fbs
        # P: the grid entry of every condensed dof; the last entry, the
        # band's dropped slot, reads a zero appended to the grids
        inv = np.full(sent + 1, G, np.int64)
        inv[dof0[live0]] = np.nonzero(live0)[0]
        inv[cut_dof] = cut_pos
        count("iface_copy_sentinel_writes",
              int(np.count_nonzero(inv[:sent] == G)))
        if G + 1 > np.iinfo(np.int32).max:
            raise ValueError(f"{N}x{N} face grids exceed int32 indices")
        g0, cut_pos, cut_dof, inv = (t(a.astype(np.int32)) for a in
                                     (g0, cut_pos, cut_dof, inv))

        # ---- uniform fitted MG hierarchy (no cut sets) ----
        nfd4 = 4 * fbs
        sizes = multigrid._mg_sizes(N, coarsest)
        uniform_per_level = {
            n: (_unit_cell_host(hdi, 1.0 / n, dev)[0],
                np.zeros(0, np.int64)) for n in sizes}
        S_per_level = {n: torch.zeros((nfd4 * nfd4, 0), dtype=dtype,
                                      device=dev) for n in sizes}
        mg = multigrid.build_multigrid(N, fbs, S_per_level, hdi, n_smooth=1,
                                       coarsest=coarsest, cheb_degree=4,
                                       uniform_per_level=uniform_per_level)

    with span("band_setup", dev):
        # ---- cut-band additive Schwarz over deduplicated patch dofs ----
        # A cut cell's condensed block is singular (local constants), and
        # the uncut faces of a cut cell map both copies to the same global
        # dofs. The patch block lives on the cell's global face-dof set:
        # scatter the cell couplings (duplicates merge), then overwrite each
        # face's diagonal block with the fully assembled one, which adds
        # the neighbours' contribution and breaks the constant kernel.
        Cc, d2 = sys_c_S.shape[:2]
        P = 8 * fbs                                   # 4 faces x max 2 copies
        cf_c = cf[dm.cut_ids.cpu().numpy()]           # [Cc, 4]
        wf = np.where(is_cut[cf_c], 2 * fbs, fbs)     # [Cc, 4] face widths
        offs = np.concatenate([np.zeros((Cc, 1), np.int64),
                               np.cumsum(wf, axis=1)], axis=1)     # [Cc, 5]
        idx_c_np = idx_c.cpu().numpy()                # [Cc, 2nfd]
        # local slot s (s%4 = geometric face, s//4 = copy) -> patch position
        pos_map = np.empty((Cc, d2), np.int64)
        for s in range(8):
            f = cf_c[:, s % 4]
            pos0 = offs[:, s % 4] + (idx_c_np[:, s * fbs] - face_start[f])
            pos_map[:, s * fbs:(s + 1) * fbs] = \
                pos0[:, None] + np.arange(fbs)
        # global dof of each patch position (sentinel past the face width)
        gidx = np.full((Cc, P), sent, np.int64)
        for s in range(4):
            for off in range(2 * fbs):
                live = off < wf[:, s]
                gidx[np.arange(Cc)[live], offs[live, s] + off] = \
                    face_start[cf_c[live, s]] + off
        # out-of-range positions (a Dirichlet face of a cut cell at the end
        # of the numbering) land on the sentinel: JAX clamps such gathers
        # and drops such scatters
        gidx_p = t(np.minimum(gidx, sent))

        # scatter the cell couplings into [Cc, P, P] (duplicates merge; out
        # of range -> a dropped extra slot)
        flat = (np.arange(Cc)[:, None, None] * (P * P) +
                pos_map[:, :, None] * P + pos_map[:, None, :])
        B = _flat_scatter(Cc * P * P + 1, t(np.minimum(flat, Cc * P * P)),
                          sys_c_S)[:-1].reshape(Cc, P, P)
        # overwrite the face-diagonal blocks with the assembled ones
        FB = _assembled_face_blocks(dm, n_face_dofs, blocks_and_idx)
        wmax = 2 * fbs
        cell_rows = np.arange(Cc)[:, None, None] * ((P + 1) * (P + 1))
        for s in range(4):
            fb_s = FB[t(cf_c[:, s])]                  # [Cc, wmax, wmax]
            ii = offs[:, s, None] + np.arange(wmax)[None, :]
            live = np.arange(wmax)[None, :] < wf[:, s, None]
            ii = np.where(live, ii, P)                # park dead at col P
            rows = t(ii[:, :, None] * (P + 1) + ii[:, None, :] + cell_rows)
            Bp = _flat_scatter(Cc * (P + 1) * (P + 1), rows, fb_s).reshape(
                Cc, P + 1, P + 1)[:, :P, :P]
            # zero the old diagonal block, then add the assembled one
            blkmask = _flat_scatter(Cc * (P + 1) * (P + 1), rows,
                                    torch.ones_like(fb_s)).reshape(
                Cc, P + 1, P + 1)[:, :P, :P]
            B = B * (1.0 - torch.clamp(blkmask, max=1.0)) + Bp
        live_p = gidx_p < sent
        eye = torch.eye(P, dtype=dtype, device=dev)
        B = torch.where(live_p[:, :, None] & live_p[:, None, :], B,
                        torch.zeros_like(B)) + \
            eye[None] * (~live_p)[:, None, :]
        Binv = spd_inverse(B)
        mult = _flat_scatter(sent + 1, gidx_p, live_p.to(dtype))
        w_ext = torch.where(mult > 0, 1.0 / torch.sqrt(torch.clamp(mult,
                                                                   min=1.0)),
                            torch.zeros_like(mult))
        w_loc = w_ext[gidx_p] * live_p

    def precond(r):
        r_ext = torch.cat([r, r.new_zeros(1)])
        # P^T r on the grids; the cut faces' indices are distinct
        g = r_ext.index_select(0, g0).index_add_(
            0, cut_pos, r.index_select(0, cut_dof))
        z = mg.precondition(GridVecCL(g[:nH].view(fbs, N + 1, N),
                                      g[nH:].view(fbs, N, N + 1)))
        out = torch.cat([z.H.reshape(-1), z.V.reshape(-1),
                         r.new_zeros(1)]).index_select(0, inv)
        rl = w_loc * r_ext[gidx_p]
        zl = torch.bmm(Binv, rl[..., None])[..., 0]
        out.index_add_(0, gidx_p.reshape(-1), (w_loc * zl).reshape(-1))
        return out[:sent]

    return precond


def _assembled_face_blocks(dm: InterfaceDofMap, n_face_dofs: int,
                           blocks_and_idx):
    """[F, 2*fbs, 2*fbs] assembled per-face diagonal blocks of the
    condensed interface system (the sum of both adjacent cells' slot
    contributions; single-copy faces fill the leading fbs x fbs corner).

    blocks_and_idx: [(S [Cx, m*fbs, m*fbs], fidx [Cx, m] rebased face
    dof starts with sentinel >= n_face_dofs, faces [Cx, m] face ids)]."""
    fbs = dm.fbs
    w = 2 * fbs
    F = dm.face_table.shape[0]
    face_start = dm.face_table * fbs
    S0 = blocks_and_idx[0][0]
    FB = S0.new_zeros((F + 1) * w * w)
    i = torch.arange(fbs, device=S0.device)
    for S, fidx, faces in blocks_and_idx:
        m = faces.shape[1]
        S = S.reshape(S.shape[0], m, fbs, m, fbs)
        dead = fidx >= n_face_dofs
        f_safe = torch.where(dead, F, faces)
        pos = torch.where(dead, 0, fidx - face_start[torch.clamp(faces,
                                                                 max=F - 1)])
        diag = torch.einsum("csisj->csij", S)      # [Cx, m, fbs, fbs]
        flat = (f_safe[:, :, None, None] * (w * w) +
                (pos[:, :, None, None] + i[None, None, :, None]) * w +
                (pos[:, :, None, None] + i[None, None, None, :]))
        FB.index_add_(0, flat.reshape(-1), torch.where(
            dead[:, :, None, None], torch.zeros_like(diag), diag).reshape(-1))
    return FB.reshape(F + 1, w, w)[:F]


def _face_block_jacobi(dm: InterfaceDofMap, n_face_dofs: int,
                       blocks_and_idx):
    """Per-face block-Jacobi preconditioner of the condensed interface
    system. Every non-Dirichlet face owns a contiguous dof range of width
    fbs (single) or 2*fbs (doubled cut face, cuthho_square.cpp:1155-1182)
    starting at face_table[f]*fbs: the ranges partition the condensed
    space, so the apply is gather / batched product / scatter."""
    fbs = dm.fbs
    w = 2 * fbs
    face_start = dm.face_table.cpu().numpy() * fbs
    width = np.where(dm.face_is_cut.cpu().numpy(), w, fbs)
    dev = dm.face_table.device

    FB = _assembled_face_blocks(dm, n_face_dofs, blocks_and_idx)
    # identity on the unused trailing positions of single-copy faces and
    # on Dirichlet faces, whose blocks stayed zero
    used = torch.arange(w, device=dev)[None, :] < \
        torch.as_tensor(width, device=dev)[:, None]
    used = used & (torch.abs(FB).sum((1, 2)) > 0)[:, None]
    eye = torch.eye(w, dtype=FB.dtype, device=dev)
    FB = torch.where(used[:, :, None] & used[:, None, :], FB,
                     torch.zeros_like(FB)) + eye[None] * (~used[:, None, :])
    Binv = spd_inverse(FB)

    # gather index [F, w] into the condensed vector (sentinel-padded). A
    # Dirichlet face owns no dofs: its range starts at the next face's
    # first dof, and with its identity block that dof gets r once more,
    # as in the JAX package; past the end its range reads and writes the
    # sentinel (JAX clamps the gather and drops the scatter there).
    gidx = face_start[:, None] + np.arange(w)[None, :]
    gidx = np.where(np.arange(w)[None, :] < width[:, None], gidx,
                    n_face_dofs)
    gidx = torch.as_tensor(np.minimum(gidx, n_face_dofs), device=dev)

    def precond(r):
        rf = torch.cat([r, r.new_zeros(1)])[gidx]
        zf = torch.bmm(Binv, rf[..., None])[..., 0]
        return _flat_scatter(n_face_dofs + 1, gidx, zf)[:n_face_dofs]

    return precond


def take_local_data(mesh, dm: InterfaceDofMap, cutdata: CutData, solution,
                    dirichlet_data, side: int):
    """[C, d'] per-cell local vectors for one side (take_local_data,
    cuthho_square.cpp:1357-1429, with the face offset corrected)."""
    C, nF = mesh.cell_faces.shape
    cbs, fbs = dm.cbs, dm.fbs
    dev = solution.device
    copy = 1 if side == LOC_POS else 0
    cell_is_cut = cutdata.cell_loc == LOC_CUT

    cell_base = dm.cell_table * cbs + torch.where(cell_is_cut, copy * cbs, 0)
    cell_idx = cell_base[:, None] + torch.arange(cbs, device=dev)[None, :]

    f_ids = mesh.cell_faces
    fbase = dm.num_all_cells * cbs + dm.face_table[f_ids] * fbs + \
        copy * torch.where(dm.face_is_cut[f_ids], fbs, 0)
    is_dir = (mesh.face_bnd == BND_DIRICHLET)[f_ids]
    fidx = fbase[..., None] + torch.arange(fbs, device=dev)[None, None, :]
    fidx = torch.where(is_dir[..., None], dm.n_dofs, fidx)

    idx = torch.cat([cell_idx, fidx.reshape(C, nF * fbs)], dim=1)
    vals = assembly.gather_values(idx, solution)

    # re-insert the Dirichlet projections
    g = dirichlet_data[f_ids]                       # [C, nF, fbs]
    g = torch.where(is_dir[..., None], g, torch.zeros_like(g))
    return vals + torch.cat([g.new_zeros((C, cbs)), g.reshape(C, nF * fbs)],
                            dim=1)


class InterfaceSystem(NamedTuple):
    """The assembled doubled-dof system of solve_interface."""

    dm: InterfaceDofMap
    geom: object
    batch: CutCellBatch
    lc_uncut: torch.Tensor       # [Cun, d', d']
    lc_cut: torch.Tensor         # [Cc, 2d', 2d']
    f_uncut: torch.Tensor        # [Cun, cbs]
    loads_uncut: torch.Tensor    # [Cun, d'] Dirichlet folded
    loads_cut: torch.Tensor      # [Cc, 2d']
    g_uncut: torch.Tensor        # [Cun, d'] Dirichlet data
    face_data: torch.Tensor      # [F, fbs] Dirichlet projections


def assemble_interface(mesh, cutdata: CutData, ls: LevelSet,
                       hdi: HHODegreeInfo, rhs_fun, sol_fun,
                       parms: InterfaceParams) -> InterfaceSystem:
    """Local matrices and loads of both cell classes
    (cuthho_square.cpp:1668-1710)."""
    geom = cell_geometry(mesh)
    dm = build_interface_dofmap(mesh, cutdata, hdi)
    nF = mesh.max_pts
    cbs = dm.cbs
    nfd = nF * dm.fbs
    batch = make_cut_batch(mesh, geom, cutdata, dm.cut_ids)

    # uncut cells: kappa-weighted fitted operator + naive stabilization
    # (:1668-1681)
    kap = geom.meas.new_tensor([parms.kappa_1, parms.kappa_2])
    kappa = torch.where(cutdata.cell_loc == LOC_NEG, kap[0], kap[1])
    _, data_fit = hho.hho_laplacian(mesh, geom, hdi)
    lc_all = kappa[:, None, None] * data_fit + \
        hho.naive_stabilization(mesh, geom, hdi)
    lc_uncut = lc_all[dm.uncut_ids]
    del lc_all, data_fit
    f_uncut = cell_rhs(mesh, geom, hdi.cell_degree, rhs_fun)[dm.uncut_ids]

    # cut cells: doubled operator + the two side stabilizations mapped
    # into the doubled layout (:1690-1704)
    _, lc_cut = cut_methods.interface_laplacian(batch, ls, hdi, parms)
    for side, kap, c0, f0 in ((LOC_NEG, parms.kappa_1, 0, 2 * cbs),
                              (LOC_POS, parms.kappa_2, cbs,
                               2 * cbs + nfd)):
        stab = kap * cut_methods.cut_stabilization(batch, hdi, side)
        lc_cut[:, c0:c0 + cbs, c0:c0 + cbs] += stab[:, :cbs, :cbs]
        lc_cut[:, c0:c0 + cbs, f0:f0 + nfd] += stab[:, :cbs, cbs:]
        lc_cut[:, f0:f0 + nfd, c0:c0 + cbs] += stab[:, cbs:, :cbs]
        lc_cut[:, f0:f0 + nfd, f0:f0 + nfd] += stab[:, cbs:, cbs:]

    # cut loads: plain side sources, no Nitsche lifting (:1708-1710)
    loads_cut = lc_cut.new_zeros((len(dm.cut_ids), 2 * (cbs + nfd)))
    for side, c0 in ((LOC_NEG, 0), (LOC_POS, cbs)):
        poly = cut_methods.side_polygon(batch, side)
        rule, phi, _ = cut_methods._side_cell_evals(
            batch, poly, hdi.cell_degree, 2 * hdi.cell_degree,
            want_grads=False)
        loads_cut[:, c0:c0 + cbs] = torch.einsum(
            "cq,cqi,cq->ci", rule.w, phi, rhs_fun(rule.pts))

    # Dirichlet data and the uncut loads
    fd = assembly.dirichlet_face_data(mesh, hdi, sol_fun)
    g_faces = fd[mesh.cell_faces[dm.uncut_ids]].reshape(
        len(dm.uncut_ids), nfd)
    g_uncut = torch.cat([g_faces.new_zeros((g_faces.shape[0], cbs)),
                         g_faces], dim=1)
    g_uncut = torch.where(dm.dirichlet_uncut, g_uncut,
                          torch.zeros_like(g_uncut))
    loads_uncut = torch.zeros_like(g_uncut)
    loads_uncut[:, :cbs] = f_uncut
    loads_uncut = loads_uncut - torch.bmm(lc_uncut, g_uncut[..., None])[..., 0]
    return InterfaceSystem(dm, geom, batch, lc_uncut, lc_cut, f_uncut,
                            loads_uncut, loads_cut, g_uncut, fd)


class InterfaceFaceSystem(NamedTuple):
    """The condensed face-only system: apply, rhs and preconditioner of
    its PCG, and what the cell back-substitution needs."""

    apply: Callable
    rhs: torch.Tensor
    precond: Callable
    sys_u: condensation.CondensedSystem
    sys_c: condensation.CondensedSystem
    idx_u: torch.Tensor          # [Cun, nfd] rebased face dofs
    idx_c: torch.Tensor          # [Cc, 2nfd]
    preconditioner: str          # "mg" or "block_jacobi"


def _is_structured(mesh, parms: InterfaceParams, precond_kind: str) -> bool:
    """The uniform-stencil premise of the MG preconditioner: the
    generated N x N box and kappa_1 = kappa_2."""
    C = mesh.num_cells
    n = int(round(np.sqrt(C)))
    return (n * n == C and mesh.num_faces == 2 * n * (n + 1) and
            float(parms.kappa_1) == float(parms.kappa_2) and
            precond_kind in ("auto", "mg"))


def condensed_face_system(mesh, asm: InterfaceSystem, hdi: HHODegreeInfo,
                          parms: InterfaceParams,
                          precond_kind: str = "auto"
                          ) -> InterfaceFaceSystem:
    """Static condensation of the doubled-dof system: uncut cells
    eliminate cbs dofs, cut cells their 2*cbs doubled block (robust
    solve, the ill-conditioned class). The face system gets the uniform
    MG + cut-band Schwarz preconditioner on the generated mesh with
    constant kappa (``precond_kind`` 'auto' or 'mg'), per-face
    block-Jacobi otherwise ('bj'). Into the caller's sink it records the
    spans ``condense`` (both classes, the Dirichlet fold, the right-hand
    side and the operator) and, on the MG branch, ``mg_setup`` and
    ``band_setup``, and counts ``iface_cut_cells``, ``iface_face_dofs``
    (the condensed system's size) and, on the MG branch,
    ``iface_copy_sentinel_writes``."""
    if precond_kind not in ("auto", "mg", "bj"):
        raise ValueError(f"unknown precond_kind '{precond_kind}'")
    dm = asm.dm
    cbs, fbs = dm.cbs, dm.fbs
    face_base = cbs * dm.num_all_cells
    n_face_dofs = dm.n_dofs - face_base

    def rebase(idx):
        return torch.where(idx >= dm.n_dofs, n_face_dofs, idx - face_base)

    count("iface_cut_cells", len(dm.cut_ids))
    count("iface_face_dofs", n_face_dofs)
    with span("condense", asm.lc_uncut.device):
        idx_u = rebase(dm.asm_uncut[:, cbs:])
        idx_c = rebase(dm.asm_cut[:, 2 * cbs:])
        sys_u = condensation.condense(asm.lc_uncut, asm.f_uncut, cbs)
        sys_c = condensation.condense(asm.lc_cut, asm.loads_cut[:, :2 * cbs],
                                      2 * cbs, robust=True)
        # Dirichlet folds through the condensed operator (exact
        # elimination)
        gF_u = asm.g_uncut[:, cbs:]
        bload_u = sys_u.bF - torch.bmm(sys_u.S, gF_u[..., None])[..., 0]
        rhs = assembly.multi_assemble_rhs(n_face_dofs, [(idx_u, bload_u),
                                                        (idx_c, sys_c.bF)])
        apply = assembly.make_multi_operator(n_face_dofs,
                                             [(idx_u, sys_u.S),
                                              (idx_c, sys_c.S)])
    faces_u = mesh.cell_faces[dm.uncut_ids]
    faces_c = mesh.cell_faces[dm.cut_ids].repeat(1, 2)
    blocks_and_idx = [(sys_u.S, idx_u[:, ::fbs], faces_u),
                      (sys_c.S, idx_c[:, ::fbs], faces_c)]
    if _is_structured(mesh, parms, precond_kind):
        N = int(round(np.sqrt(mesh.num_cells)))
        M = _interface_mg_precond(mesh, dm, n_face_dofs, sys_c.S, idx_c,
                                  blocks_and_idx, N, hdi, sys_u.S.dtype)
        kind = "mg"
    else:
        M = _face_block_jacobi(dm, n_face_dofs, blocks_and_idx)
        kind = "block_jacobi"
    return InterfaceFaceSystem(apply, rhs, M, sys_u, sys_c, idx_u, idx_c,
                               kind)


def recover_interface(asm: InterfaceSystem, fsys: InterfaceFaceSystem,
                      xf):
    """Back-substitute the cell dofs and rebuild the full-layout vector
    [n_dofs] from the face solution xf [n_face_dofs]."""
    dm = asm.dm
    cbs = dm.cbs
    face_base = cbs * dm.num_all_cells
    xf_ext = torch.cat([xf, xf.new_zeros(1)])
    su, sc = fsys.sys_u, fsys.sys_c
    uF_u = xf_ext[fsys.idx_u] + asm.g_uncut[:, cbs:]
    uT_u = cho_solve_batched(su.ATT, (su.fT - torch.bmm(
        su.ATF, uF_u[..., None])[..., 0])[..., None])[..., 0]
    uF_c = xf_ext[fsys.idx_c]
    uT_c = robust_spd_solve(sc.ATT, (sc.fT - torch.bmm(
        sc.ATF, uF_c[..., None])[..., 0])[..., None])[..., 0]
    x = xf.new_zeros(dm.n_dofs + 1)
    x[face_base:face_base + xf.shape[0]] = xf
    x[dm.asm_uncut[:, :cbs]] = uT_u
    x[dm.asm_cut[:, :2 * cbs]] = uT_c
    return x[:dm.n_dofs]


def solve_interface(mesh, cutdata: CutData, ls: LevelSet, degree: int,
                    rhs_fun: Callable, sol_fun: Callable, sol_grad: Callable,
                    parms: InterfaceParams = InterfaceParams(),
                    cg_params: cg.CGParams = DEFAULT_CG,
                    condensed: bool = True, precond_kind: str = "auto",
                    timings: Optional[dict] = None) -> InterfaceResult:
    """Assemble and solve the kappa-weighted elliptic interface problem
    (run_cuthho_interface, cuthho_square.cpp:1625-1846); hdi =
    (degree+1, degree) (:1662). ``condensed`` (default) eliminates the
    cell blocks and solves the face-only Schur system
    (condensed_face_system); ``condensed=False`` is the reference's
    full-system Jacobi PCG. With a ``timings`` dict the seconds of each
    phase are recorded in it (device synchronized after each)."""
    hdi = HHODegreeInfo(degree + 1, degree)
    dev = mesh.points.device
    with sink(timings):
        with span("assemble", dev):
            asm = assemble_interface(mesh, cutdata, ls, hdi, rhs_fun, sol_fun,
                                     parms)
        dm = asm.dm
        if condensed:
            with span("setup", dev):
                fsys = condensed_face_system(mesh, asm, hdi, parms,
                                             precond_kind)
            with span("cg", dev):
                res = cg.conjugated_gradient(fsys.apply, fsys.rhs, None,
                                             cg_params, precond=fsys.precond)
            with span("recover", dev):
                res = res._replace(x=recover_interface(asm, fsys, res.x))
        else:
            with span("setup", dev):
                blocks = [(dm.asm_uncut, asm.lc_uncut),
                          (dm.asm_cut, asm.lc_cut)]
                rhs = assembly.multi_assemble_rhs(dm.n_dofs, [
                    (dm.asm_uncut, asm.loads_uncut),
                    (dm.asm_cut, asm.loads_cut)])
                apply_A = assembly.make_multi_operator(dm.n_dofs, blocks)
                diag = assembly.multi_operator_diagonal(dm.n_dofs, blocks)
            with span("cg", dev):
                res = cg.conjugated_gradient(apply_A, rhs, diag, cg_params)

        with span("h1", dev):
            local_neg = take_local_data(mesh, dm, cutdata, res.x,
                                        asm.face_data, LOC_NEG)
            local_pos = take_local_data(mesh, dm, cutdata, res.x,
                                        asm.face_data, LOC_POS)
            h1 = interface_h1_error(mesh, asm.geom, asm.batch, cutdata, hdi,
                                    local_neg, local_pos, sol_grad)
    return InterfaceResult(res.x, local_neg, local_pos, float(h1),
                           res.iterations, res.exit_reason,
                           float(res.rel_residual))


def interface_h1_error(mesh, geom, batch: CutCellBatch, cutdata: CutData,
                       hdi: HHODegreeInfo, local_neg, local_pos, sol_grad):
    """H1 error over both sides (cuthho_square.cpp:1763-1834): the
    cell-degree gradient, side rules on cut cells, the standard rule
    elsewhere. A 0-d tensor."""
    celdeg = hdi.cell_degree
    cbs = bases.cell_basis_size(celdeg)
    is_cut = cutdata.cell_loc == LOC_CUT

    # uncut cells (either side's local data is the same there)
    rule = quadrature.cell_rule(mesh, geom, 2 * celdeg)
    dphi = bases.eval_cell_gradients(rule.pts, geom.bar[:, None, :],
                                     geom.diam[:, None], celdeg)
    gh = torch.einsum("cqix,ci->cqx", dphi[:, :, 1:, :], local_pos[:, 1:cbs])
    per_cell = torch.sum(rule.w * torch.sum((sol_grad(rule.pts) - gh) ** 2,
                                            dim=-1), dim=1)
    err = torch.sum(torch.where(~is_cut, per_cell,
                                torch.zeros_like(per_cell)))

    # cut cells, each side with its own cell dofs
    g = batch.geom
    for side, local in ((LOC_NEG, local_neg), (LOC_POS, local_pos)):
        crule = side_cell_rule(cut_methods.side_polygon(batch, side),
                               2 * celdeg)
        cdphi = bases.eval_cell_gradients(crule.pts, g.bar[:, None, :],
                                          g.diam[:, None], celdeg)
        cgh = torch.einsum("cqix,ci->cqx", cdphi[:, :, 1:, :],
                           local[batch.ids][:, 1:cbs])
        err = err + torch.sum(crule.w * torch.sum(
            (sol_grad(crule.pts) - cgh) ** 2, dim=-1))
    return torch.sqrt(err)


def run_interface(N: int, degree: int, radius: float = 0.35,
                  center=(0.5, 0.5), int_refsteps: int = 4,
                  parms: InterfaceParams = InterfaceParams(), *,
                  device=None, dtype=DEFAULT_DTYPE,
                  timings: Optional[dict] = None, **kw) -> InterfaceResult:
    """End-to-end ``cuthho_square -i`` (cuthho_square.cpp:2064-2065): the
    continuous solution sin(pi x) sin(pi y), kappa_1 = kappa_2 = 1 by
    default. Runs on CUDA unless ``device`` is given; raises without one
    when CUDA is absent."""
    from ..core.mesh import make_poly_mesh
    from .fictdom_structured import default_problem

    device = resolve_device(device)
    p = default_problem(radius, center)
    with sink(timings), span("classify", device):
        mesh = make_poly_mesh(Nx=N, Ny=N, device=device, dtype=dtype)
        mesh, cutdata = cut_preprocess(mesh, p.ls, levels=int_refsteps)
    return solve_interface(mesh, cutdata, p.ls, degree, p.rhs_fun,
                           p.sol_fun, p.sol_grad, parms, timings=timings,
                           **kw)
