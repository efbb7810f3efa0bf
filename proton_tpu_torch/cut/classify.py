"""Level-set cut classification (JAX counterpart:
proton_tpu/cut/classify.py; reference cuthho_geom.hpp:68-673): the
generic pipeline on any mesh (``cut_preprocess``: node displacement,
agglomeration detection or plain classification) and the
band-restricted displacement path of the generated mesh
(``cut_preprocess_band``).

Each stage is one batched tensor computation producing parallel arrays.
Location codes are int8 and masks bool, as in the JAX package, so
equality tests compare like with like. Duplicate-index accumulation
(``jax.ops.segment_sum``) is ``index_add_``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core.geometry import cell_points

# element_location (cuthho_mesh.hpp:31-36)
LOC_NEG = 0
LOC_POS = 1
LOC_CUT = 2
LOC_UNDEF = 3

# cell_agglo_set (cuthho_mesh.hpp:38-43), encoded as in output_mesh_info
AGGLO_UNDEF = 0
AGGLO_OK = 1
AGGLO_KO_NEG = 2
AGGLO_KO_POS = 3


@dataclasses.dataclass(frozen=True)
class CutData:
    """Parallel classification arrays (cuthho_mesh.hpp:45-90).

    node_loc [P] int8; face_loc [F] int8; face_isect [F, 2];
    face_node_inside [F] int8; cell_loc [C] int8;
    interface [C, R+1, 2] oriented refined polyline (junk for uncut cells);
    agglo_set [C] int8; distorted [C] bool.
    """

    node_loc: torch.Tensor
    face_loc: torch.Tensor
    face_isect: torch.Tensor
    face_node_inside: torch.Tensor
    cell_loc: torch.Tensor
    interface: torch.Tensor
    agglo_set: torch.Tensor
    distorted: torch.Tensor


def _same_sign(a, b):
    return ((a >= 0) & (b >= 0)) | ((a < 0) & (b < 0))


def find_zero_crossings(pa, pb, phi, iters: int = 30):
    """Batched bisection for the zero of phi on segments [pa, pb]
    (find_zero_crossing, cuthho_geom.hpp:68-116): a fixed 30 steps."""
    a, b = pa, pb
    for _ in range(iters):
        m = 0.5 * (a + b)
        same = _same_sign(phi(b), phi(m))[..., None]
        a, b = torch.where(same, a, m), torch.where(same, m, b)
    return 0.5 * (a + b)


def detect_node_position(mesh, phi):
    """[P] node side: phi < 0 -> NEG else POS (cuthho_geom.hpp:118-130)."""
    return torch.where(phi(mesh.points) < 0, LOC_NEG, LOC_POS).to(torch.int8)


class FaceCuts(NamedTuple):
    loc: torch.Tensor           # [F] int8
    isect: torch.Tensor         # [F, 2]
    node_inside: torch.Tensor   # [F] int8


def detect_cut_faces(mesh, phi) -> FaceCuts:
    """Per-face sign analysis + zero crossing (cuthho_geom.hpp:132-161);
    the bisection runs on every face, meaningful where loc == LOC_CUT."""
    fp = mesh.points[mesh.face_ptids]
    l0 = phi(fp[:, 0])
    l1 = phi(fp[:, 1])
    loc = torch.where((l0 >= 0) & (l1 >= 0), LOC_POS,
                      torch.where((l0 < 0) & (l1 < 0), LOC_NEG, LOC_CUT))
    isect = find_zero_crossings(fp[:, 0], fp[:, 1], phi)
    node_inside = torch.where(l0 < 0, 0, 1)
    return FaceCuts(loc.to(torch.int8), isect, node_inside.to(torch.int8))


class CellCuts(NamedTuple):
    loc: torch.Tensor        # [C] int8
    p0: torch.Tensor         # [C, 2] oriented interface start
    p1: torch.Tensor         # [C, 2]
    cut_count: torch.Tensor  # [C]


def detect_cut_cells(mesh, phi, fc: FaceCuts) -> CellCuts:
    """Classify cells and orient the interface segment so the negative
    side is consistent (cuthho_geom.hpp:275-340): if phi(p0 + rot90(p1 -
    p0)) >= 0, swap p0/p1."""
    C = mesh.num_cells
    dev = mesh.points.device
    floc = fc.loc[mesh.cell_faces]
    k = torch.arange(mesh.max_pts, device=dev)[None, :]
    valid = k < mesh.cell_npts[:, None]
    is_cut_f = (floc == LOC_CUT) & valid
    count = torch.sum(is_cut_f, dim=1)

    big = mesh.max_pts + 1
    order = torch.where(is_cut_f, k, big)
    first = torch.argmin(order, dim=1)
    rows = torch.arange(C, device=dev)
    order2 = order.clone()
    order2[rows, first] = big
    second = torch.argmin(order2, dim=1)

    isect_cell = fc.isect[mesh.cell_faces]
    p0 = isect_cell[rows, first]
    p1 = isect_cell[rows, second]
    pt = p1 - p0
    pn = p0 + torch.stack([-pt[..., 1], pt[..., 0]], dim=-1)
    swap = (phi(pn) >= 0)[:, None]
    p0o = torch.where(swap, p1, p0)
    p1o = torch.where(swap, p0, p1)

    # uncut: POS iff all cell points strictly positive
    # (cuthho_geom.hpp:301-309)
    all_pos = torch.all((phi(cell_points(mesh)) > 0) |
                        (k >= mesh.cell_npts[:, None]), dim=1)
    loc = torch.where(count >= 2, LOC_CUT,
                      torch.where(all_pos, LOC_POS, LOC_NEG))
    return CellCuts(loc.to(torch.int8), p0o, p1o, count)


class MoveNodesResult(NamedTuple):
    points: torch.Tensor      # [P, 2]
    displaced: torch.Tensor   # [P] bool
    distorted: torch.Tensor   # [C] bool
    concave: torch.Tensor     # [C] bool (must be all False)


def _segment_sum(values, segments, num_segments: int):
    out = torch.zeros((num_segments,) + values.shape[1:], dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, segments, values)


def move_nodes(mesh, fc: FaceCuts) -> MoveNodesResult:
    """Bad-cut fix #1: displace nodes whose face intersection is within
    closeness 0.4 of them by (face midpoint - intersection)/2,
    accumulating displacements (cuthho_geom.hpp:466-543)."""
    closeness_thresh = 0.4
    fp = mesh.points[mesh.face_ptids]
    bar = 0.5 * (fp[:, 0] + fp[:, 1])
    lf = torch.linalg.vector_norm(fp[:, 1] - fp[:, 0], dim=-1)
    dp = torch.linalg.vector_norm(fc.isect - fp[:, 0], dim=-1)
    closeness = dp / lf

    on_iface = fc.loc == LOC_CUT
    move0 = on_iface & (closeness < closeness_thresh)
    move1 = on_iface & (closeness > 1.0 - closeness_thresh)
    delta = 0.5 * (bar - fc.isect)

    P = mesh.num_points
    zero = torch.zeros_like(delta)
    target0 = torch.where(move0, mesh.face_ptids[:, 0], P)
    target1 = torch.where(move1, mesh.face_ptids[:, 1], P)
    disp = torch.zeros((P, 2), dtype=mesh.points.dtype,
                       device=mesh.points.device)
    disp = disp - _segment_sum(torch.where(move0[:, None], delta, zero),
                               target0, P + 1)[:P]
    disp = disp - _segment_sum(torch.where(move1[:, None], delta, zero),
                               target1, P + 1)[:P]
    moved = move0 | move1
    target = torch.where(moved, torch.where(move0, mesh.face_ptids[:, 0],
                                            mesh.face_ptids[:, 1]), P)
    displaced = _segment_sum(moved.to(torch.int64), target, P + 1)[:P] > 0

    new_points = mesh.points + disp
    distorted = torch.any(displaced[mesh.cell_ptids], dim=1)

    # concavity check on distorted cells (cuthho_geom.hpp:517-542)
    pts = new_points[mesh.cell_ptids]
    C, Pm = mesh.cell_ptids.shape
    k = torch.arange(Pm, device=pts.device)[None, :]
    npts = mesh.cell_npts[:, None]

    def shifted(d):
        idx = torch.where(k + d < npts, k + d, k + d - npts)
        return torch.take_along_dim(pts, idx[..., None].expand(C, Pm, 2),
                                    dim=1)

    pb, pc = shifted(1), shifted(2)
    v1 = pb - pts
    v2 = pc - pb
    cross = v1[..., 0] * v2[..., 1] - v2[..., 0] * v1[..., 1]
    concave = distorted & torch.any((cross < 0) & (k < npts), dim=1)
    return MoveNodesResult(new_points, displaced, distorted, concave)


def refine_interface(mesh, phi, cells: CellCuts, levels: int):
    """Bisect the interface polyline to 2^levels segments, projecting each
    midpoint onto the zero level set along the (unnormalized) span normal
    (cuthho_geom.hpp:609-673). Returns [C, 2^levels + 1, 2]."""
    C = mesh.num_cells
    pts = torch.stack([cells.p0, cells.p1], dim=1)
    for _ in range(levels):
        p0 = pts[:, :-1]
        p1 = pts[:, 1:]
        pm = 0.5 * (p0 + p1)
        pt = p1 - p0
        pn = torch.stack([-pt[..., 1], pt[..., 0]], dim=-1)
        ps1 = pm + pn
        ps2 = pm - pn
        diff1 = ~_same_sign(phi(pm), phi(ps1))
        pb = torch.where(diff1[..., None], ps1, ps2)
        ip = find_zero_crossings(pm, pb, phi)
        S = p0.shape[1]
        inter = torch.stack([p0, ip], dim=2).reshape(C, 2 * S, 2)
        pts = torch.cat([inter, pts[:, -1:]], dim=1)
    return pts


def detect_cell_agglo_set(mesh, phi, fc: FaceCuts, node_loc, cell_loc):
    """Classify bad cuts against the 6 quad cut configurations with
    cut-fraction threshold 0.3 (detect_cell_agglo_set,
    cuthho_geom.hpp:163-273). Quad-only like the reference. Returns [C]
    int8 AGGLO_* codes."""
    if mesh.max_pts != 4:
        raise ValueError("agglomeration sets work only on quads for now")
    threshold = 0.3
    pts = cell_points(mesh)                             # [C, 4, 2]
    floc = fc.loc[mesh.cell_faces]                      # [C, 4]
    fisect = fc.isect[mesh.cell_faces]                  # [C, 4, 2]
    fp = mesh.points[mesh.face_ptids[mesh.cell_faces]]  # [C, 4, 2, 2]
    fmeas = torch.linalg.vector_norm(fp[:, :, 1] - fp[:, :, 0], dim=-1)
    nloc = node_loc[mesh.cell_ptids]                    # [C, 4]
    cut_f = floc == LOC_CUT

    def frac(n, f):
        """Distance of node n to the crossing on face f, over |f|."""
        return torch.linalg.vector_norm(pts[:, n] - fisect[:, f],
                                        dim=-1) / fmeas[:, f]

    def codes(ok, ko_neg):
        return torch.where(ok, AGGLO_OK,
                           torch.where(ko_neg, AGGLO_KO_NEG, AGGLO_KO_POS))

    agglo = torch.full((mesh.num_cells,), AGGLO_UNDEF, dtype=torch.int64,
                       device=pts.device)
    # single-node cases: faces (i, i+1) both cut -> corner node n = i+1
    # (cuthho_geom.hpp:184-251)
    for i in range(4):
        n = (i + 1) % 4
        fire = cut_f[:, i] & cut_f[:, n]
        ok = torch.minimum(frac(n, i), frac(n, n)) > threshold
        agglo = torch.where(fire, codes(ok, nloc[:, n] == LOC_NEG), agglo)

    # double-node cases: opposite faces (0,2) and (1,3) both cut
    # (cuthho_geom.hpp:212-240,253-257)
    for f1, f2 in ((0, 2), (1, 3)):
        n1, n2 = f1, (f2 + 1) % 4
        fire = cut_f[:, f1] & cut_f[:, f2]
        da, db = frac(n1, f1), frac(n2, f2)
        m1 = torch.maximum(da, db)
        m2 = torch.maximum(1 - da, 1 - db)
        ok = torch.minimum(m1, m2) > threshold
        ko_neg = torch.where(nloc[:, n1] == LOC_NEG, m1 <= threshold,
                             m2 <= threshold)
        agglo = torch.where(fire, codes(ok, ko_neg), agglo)
    return agglo.to(torch.int8)


def make_neighbors_info(mesh, max_neighbors: int = 8):
    """Point-sharing cell neighbor lists [C, max_neighbors], -1 padded,
    ascending (make_neighbors_info, cuthho_geom.hpp:343-380), through the
    point -> cell incidence transpose instead of the reference's O(C^2)
    pair scan. NumPy on the host; the result is on the mesh's device."""
    cp = mesh.cell_ptids.cpu().numpy()
    npts = mesh.cell_npts.cpu().numpy()
    C, Pmax = cp.shape
    valid = np.arange(Pmax)[None, :] < npts[:, None]
    p_flat = cp[valid].astype(np.int64)
    c_flat = np.broadcast_to(np.arange(C)[:, None], (C, Pmax))[valid]

    # point -> cells padded table [P, M] via grouped ranks
    order = np.argsort(p_flat, kind="stable")
    ps, cs = p_flat[order], c_flat[order]
    first = np.concatenate([[True], ps[1:] != ps[:-1]])
    gstart = np.maximum.accumulate(np.where(first, np.arange(len(ps)), 0))
    rank = np.arange(len(ps)) - gstart
    M = int(rank.max()) + 1 if len(ps) else 1
    p2c = -np.ones((mesh.num_points, M), dtype=np.int64)
    p2c[ps, rank] = cs

    # candidates per cell: the cells of each of its points, self dropped,
    # duplicates removed, ascending
    big = np.iinfo(np.int64).max
    cand = p2c[cp].reshape(C, Pmax * M)
    cand = np.where(cand == np.arange(C)[:, None], -1, cand)
    cand.sort(axis=1)
    dup = np.concatenate([np.zeros((C, 1), bool),
                          cand[:, 1:] == cand[:, :-1]], axis=1)
    cand = np.where(dup | (cand < 0), big, cand)
    cand.sort(axis=1)
    out = cand[:, :max_neighbors]
    out = np.where(out == big, -1, out)
    return torch.as_tensor(out, device=mesh.points.device)


def _preprocess_core(mesh, phi, levels: int, agglomeration: bool = False,
                     displacement: bool = True):
    """The preprocessing pipeline. Displacement path (default): detect
    nodes and faces, move nodes, re-detect faces on the moved points,
    detect cells, refine the interface. Agglomeration path: detect nodes,
    faces and cells on the input points, then the agglo sets. Plain
    classification (``displacement=False``, used on agglomerated meshes):
    detect on the input points. Returns (points', CutData, concave_any,
    n_bad) with the two flags read on the host."""
    node_loc = detect_node_position(mesh, phi)
    fcuts = detect_cut_faces(mesh, phi)
    dev = node_loc.device
    distorted = torch.zeros((mesh.num_cells,), dtype=torch.bool, device=dev)
    agglo = torch.full((mesh.num_cells,), AGGLO_UNDEF, dtype=torch.int8,
                       device=dev)
    concave_any = False

    if agglomeration:
        ccuts = detect_cut_cells(mesh, phi, fcuts)
        agglo = detect_cell_agglo_set(mesh, phi, fcuts, node_loc, ccuts.loc)
    elif not displacement:
        ccuts = detect_cut_cells(mesh, phi, fcuts)
    else:
        mv = move_nodes(mesh, fcuts)
        concave_any = bool(torch.any(mv.concave))
        mesh = mesh.with_points(mv.points)
        distorted = mv.distorted
        fcuts = detect_cut_faces(mesh, phi)   # re-run on moved points
        ccuts = detect_cut_cells(mesh, phi, fcuts)

    n_bad = int(torch.sum((ccuts.cut_count != 0) & (ccuts.cut_count != 2)))
    iface = refine_interface(mesh, phi, ccuts, levels)
    cutdata = CutData(
        node_loc=node_loc,
        face_loc=fcuts.loc,
        face_isect=fcuts.isect,
        face_node_inside=fcuts.node_inside,
        cell_loc=ccuts.loc,
        interface=iface,
        agglo_set=agglo,
        distorted=distorted,
    )
    return mesh.points, cutdata, concave_any, n_bad


def _check_flags(concave_any: bool, n_bad: int) -> None:
    """The reference's throws (cuthho_geom.hpp:335-336, :538-540)."""
    if concave_any:
        raise RuntimeError("concave poly generated by node displacement")
    if n_bad != 0:
        raise RuntimeError(f"invalid number of cuts in {n_bad} cell(s)")


def cut_preprocess(mesh, phi, levels: int = 4, agglomeration: bool = False,
                   displacement: bool = True):
    """The level-set mesh preprocessing of the reference main
    (cuthho_square.cpp:2035-2052) on every cell of any mesh.
    Displacement path (default, -D): detect nodes and faces, move nodes,
    re-detect faces, detect cells, refine the interface. Agglomeration
    path (-A): detect nodes, faces and cells and the agglo sets
    (detection only: the reference's merge is dead code; cut/agglomerate.py
    merges). ``displacement=False``: plain classification.

    Returns (mesh', CutData). Raises on concave cells or invalid cut
    counts, one scalar read each."""
    points, cutdata, concave_any, n_bad = _preprocess_core(
        mesh, phi, levels, agglomeration, displacement)
    _check_flags(concave_any, n_bad)
    return mesh.with_points(points), cutdata


def band_cell_ids(mesh, phi):
    """Host ids of the interface band: every cell touching a node of a
    sign-change face. Outside the band no node moves and no face or cell
    can be cut. Returns (band_ids [B], lnode [P] numpy phi values)."""
    lnode = phi(mesh.points).cpu().numpy()
    neg = lnode < 0
    fp = mesh.face_ptids.cpu().numpy()
    fcut = neg[fp[:, 0]] != neg[fp[:, 1]]
    marked = np.zeros(mesh.num_points, dtype=bool)
    marked[fp[fcut].ravel()] = True
    cp = mesh.cell_ptids.cpu().numpy()
    band = marked[cp].any(axis=1)
    return np.nonzero(band)[0], lnode


def cut_preprocess_band(mesh, phi, levels: int = 4):
    """Band-restricted preprocessing (displacement path): the bisections,
    node displacement, cell classification and interface refinement run
    on the O(N) band sub-mesh, and the full-mesh arrays are the band
    results scattered over the trivial corner-sign classification.
    Returns (mesh', CutData); raises on concave or badly cut cells
    (cuthho_geom.hpp:335-336, :538-540)."""
    dev = mesh.points.device
    band_ids, lnode = band_cell_ids(mesh, phi)
    cp = mesh.cell_ptids.cpu().numpy()
    fp = mesh.face_ptids.cpu().numpy()
    cf = mesh.cell_faces.cpu().numpy()
    C, F = mesh.num_cells, mesh.num_faces
    R = 2 ** max(levels, 1) if levels else 1
    dtype = mesh.points.dtype

    def t(a):
        return torch.as_tensor(a, device=dev)

    both_pos = (lnode[fp[:, 0]] >= 0) & (lnode[fp[:, 1]] >= 0)
    all_pos = (lnode[cp] > 0).all(axis=1)
    face_loc = np.where(both_pos, LOC_POS, LOC_NEG).astype(np.int8)
    face_node_inside = np.where(lnode[fp[:, 0]] < 0, 0, 1).astype(np.int8)
    cell_loc = np.where(all_pos, LOC_POS, LOC_NEG).astype(np.int8)
    face_isect = torch.zeros((F, 2), dtype=dtype, device=dev)
    interface = torch.zeros((C, R + 1, 2), dtype=dtype, device=dev)
    distorted = torch.zeros((C,), dtype=torch.bool, device=dev)
    agglo = torch.full((C,), AGGLO_UNDEF, dtype=torch.int8, device=dev)

    if len(band_ids) == 0:
        node_loc = t(np.where(lnode < 0, LOC_NEG, LOC_POS).astype(np.int8))
        return mesh, CutData(node_loc, t(face_loc), face_isect,
                             t(face_node_inside), t(cell_loc), interface,
                             agglo, distorted)

    sub_cf_g = cf[band_ids]
    fsub, inv = np.unique(sub_cf_g, return_inverse=True)
    sub = dataclasses.replace(
        mesh,
        cell_ptids=t(cp[band_ids]),
        cell_npts=mesh.cell_npts[t(band_ids)],
        cell_faces=t(inv.reshape(sub_cf_g.shape).astype(np.int64)),
        face_ptids=t(fp[fsub]),
        face_bnd=mesh.face_bnd[t(fsub)],
    )
    points2, sub_cut, concave_any, n_bad = _preprocess_core(sub, phi, levels)
    _check_flags(concave_any, n_bad)

    face_loc[fsub] = sub_cut.face_loc.cpu().numpy()
    face_node_inside[fsub] = sub_cut.face_node_inside.cpu().numpy()
    cell_loc[band_ids] = sub_cut.cell_loc.cpu().numpy()
    fsub_t, band_t = t(fsub), t(band_ids)
    face_isect[fsub_t] = sub_cut.face_isect
    interface[band_t] = sub_cut.interface
    distorted[band_t] = sub_cut.distorted

    cutdata = CutData(
        node_loc=sub_cut.node_loc,
        face_loc=t(face_loc),
        face_isect=face_isect,
        face_node_inside=t(face_node_inside),
        cell_loc=t(cell_loc),
        interface=interface,
        agglo_set=agglo,
        distorted=distorted,
    )
    return mesh.with_points(points2), cutdata
