"""Cell agglomeration: merge badly cut cells with a neighbour (JAX
counterpart: proton_tpu/cut/agglomerate.py).

The reference only detects bad cuts (-A computes agglo sets and the
neighbour info); its merge routine is dead code (agglomerate_cells
hardcodes Nx = 0 and the consuming assembler is #if 0). This module
completes it: every KO cell is merged with the face neighbour owning the
largest portion of the deficient side, which gives a polygonal mesh on
which the generic cut pipeline and solvers run unchanged (a merged
polygon is a row with a larger npts).

The algorithm is host-side mesh preprocessing, like all topology work:
  1. classify (detect_* + detect_cell_agglo_set) on the device;
  2. each KO cell picks its best face neighbour (largest area of the
     deficient side, never a cell that is KO of the same side);
  3. union-find the picks into groups;
  4. each group's union polygon = its boundary edges (edges not shared by
     two members) walked into a CCW loop;
  5. rebuild the mesh with core/mesh._build_topology (boundary codes
     inherited from the old faces) on the input mesh's device, and repeat
     until no KO cell remains (round >= 2 uses a side-area-fraction
     criterion, since the reference's edge-fraction test is quad-only).
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.geometry import cell_geometry, cell_points
from ..core.mesh import Mesh, _build_topology
from . import quadrature as cq
from .classify import (AGGLO_KO_NEG, AGGLO_KO_POS, AGGLO_OK, LOC_CUT,
                       LOC_NEG, LOC_POS, detect_cell_agglo_set,
                       detect_cut_cells, detect_cut_faces,
                       detect_node_position, refine_interface)


def _side_measures(mesh, phi):
    """(neg_area [C], pos_area [C], cell_loc [C]) as host arrays, plus the
    device classification (node_loc, FaceCuts, CellCuts), for the
    neighbour choice."""
    node_loc = detect_node_position(mesh, phi)
    fcuts = detect_cut_faces(mesh, phi)
    ccuts = detect_cut_cells(mesh, phi, fcuts)
    loc = ccuts.loc.cpu().numpy()
    meas = cell_geometry(mesh).meas.cpu().numpy()
    neg = np.where(loc == LOC_NEG, meas, 0.0)
    pos = np.where(loc == LOC_POS, meas, 0.0)
    ids = np.nonzero(loc == LOC_CUT)[0]
    if len(ids):
        iface = refine_interface(mesh, phi, ccuts, 1)
        idt = torch.as_tensor(ids, device=mesh.points.device)
        poly_n = cq.triangulation_points(
            cell_points(mesh)[idt], mesh.cell_npts[idt],
            node_loc[mesh.cell_ptids[idt]], iface[idt], LOC_NEG)
        sn = cq.side_measure(poly_n).cpu().numpy()
        neg[ids] = sn
        pos[ids] = meas[ids] - sn
    return neg, pos, loc, node_loc, fcuts, ccuts


def _face_neighbor_table(mesh):
    """[C, Pmax] face-sharing neighbour ids (-1 at boundary and padded
    slots), through the face -> cells incidence (the reference builds the
    point-sharing variant in an O(C^2) scan, cuthho_geom.hpp:343-380)."""
    from ..core.ops import HHODegreeInfo
    from ..methods.assembly import build_dofmap, build_face_incidence

    dm = build_dofmap(mesh, HHODegreeInfo(0, 0))
    fc = build_face_incidence(mesh, dm).face_cells.cpu().numpy()  # sent. C
    cf = mesh.cell_faces.cpu().numpy()
    C = mesh.num_cells
    pair = fc[cf]                              # [C, Pmax, 2]
    cid = np.arange(C)[:, None]
    other = np.where(pair[..., 0] == cid, pair[..., 1], pair[..., 0])
    other = np.where(other >= C, -1, other).astype(np.int64)
    valid = np.arange(cf.shape[1])[None, :] < \
        mesh.cell_npts.cpu().numpy()[:, None]
    return np.where(valid, other, -1)


class _UnionFind:
    def __init__(self, n):
        self.p = list(range(n))

    def find(self, a):
        while self.p[a] != a:
            self.p[a] = self.p[self.p[a]]
            a = self.p[a]
        return a

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[ra] = rb


def _walk_boundary(edges):
    """Order a set of undirected boundary edges (a, b) into a closed loop
    of point ids, starting at the smallest id."""
    adj = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, []).append(a)
    if any(len(lst) != 2 for lst in adj.values()):
        raise RuntimeError("non-manifold agglomeration boundary")
    start = min(adj)
    loop = [start]
    prev, cur = None, start
    while True:
        nxts = adj[cur]
        nxt = nxts[0] if nxts[0] != prev else nxts[1]
        if nxt == start:
            break
        loop.append(nxt)
        prev, cur = cur, nxt
    return loop


def _tick(timings: Optional[dict], name: str, t0: float) -> float:
    """Add the seconds since t0 to timings[name]; returns the clock."""
    now = time.perf_counter()
    if timings is not None:
        timings[name] = timings.get(name, 0.0) + now - t0
    return now


def _merge_round(mesh, phi, use_reference_classifier: bool,
                 timings: Optional[dict] = None):
    """One merge round; returns (mesh', number of merged groups). With a
    ``timings`` dict, adds the seconds of the classification
    (classify_s), the host merge (merge_s) and the topology rebuild
    (rebuild_s) to it."""
    t0 = time.perf_counter()
    neg, pos, loc, node_loc, fcuts, ccuts = _side_measures(mesh, phi)
    C = mesh.num_cells
    meas = cell_geometry(mesh).meas.cpu().numpy()

    if use_reference_classifier and mesh.max_pts == 4:
        agglo = detect_cell_agglo_set(mesh, phi, fcuts, node_loc,
                                      ccuts.loc).cpu().numpy()
    else:
        # the side-area criterion of the polygonal rounds
        frac_neg = np.where(loc == LOC_CUT, neg / meas, 1.0)
        frac_pos = np.where(loc == LOC_CUT, pos / meas, 1.0)
        thr = 0.09  # ~ the reference's 0.3 edge fraction, squared
        agglo = np.where(loc != LOC_CUT, 0,
                         np.where(frac_neg < thr, AGGLO_KO_NEG,
                                  np.where(frac_pos < thr, AGGLO_KO_POS,
                                           AGGLO_OK)))

    t0 = _tick(timings, "classify_s", t0)
    ko = np.isin(agglo, (AGGLO_KO_NEG, AGGLO_KO_POS))
    if not ko.any():
        return mesh, 0

    # neighbour choice, vectorized over the O(N) KO set
    nbr_tab = _face_neighbor_table(mesh)
    ko_ids = np.nonzero(ko)[0]
    cand = nbr_tab[ko_ids]                                # [K, Pmax]
    safe = np.maximum(cand, 0)
    deficient = np.where((agglo[ko_ids] == AGGLO_KO_NEG)[:, None],
                         neg[safe], pos[safe])
    same = agglo[safe] == agglo[ko_ids][:, None]
    score = np.where(cand < 0, -np.inf, np.where(same, -np.inf, deficient))
    best = cand[np.arange(len(ko_ids)), np.argmax(score, axis=1)]
    # all partners deficient on the same side: take the largest anyway
    none = ~np.isfinite(np.max(score, axis=1))
    if none.any():
        score2 = np.where(cand[none] < 0, -np.inf, deficient[none])
        best[none] = cand[none][np.arange(none.sum()),
                                np.argmax(score2, axis=1)]

    # union-find over the involved cells only (groups are tiny; the other
    # C - O(N) cells pass through untouched)
    involved = np.unique(np.concatenate([ko_ids, best]))
    uf = _UnionFind(len(involved))
    lookup = {int(c): i for i, c in enumerate(involved)}
    for c, b in zip(ko_ids, best):
        uf.union(lookup[int(c)], lookup[int(b)])
    groups = {}
    for i, c in enumerate(involved):
        groups.setdefault(uf.find(i), []).append(int(c))
    groups = [g for g in groups.values() if len(g) > 1]
    grouped = np.zeros(C, dtype=bool)
    for g in groups:
        grouped[g] = True

    cp = mesh.cell_ptids.cpu().numpy()
    npts = mesh.cell_npts.cpu().numpy()
    points = mesh.points.cpu().numpy()

    keep_ids = np.nonzero(~grouped)[0]
    new_cells = []                      # merged polygons only (few)
    for members in groups:
        edge_count = {}
        for c in members:
            ids = cp[c, :npts[c]]
            for k in range(len(ids)):
                a, b = int(ids[k]), int(ids[(k + 1) % len(ids)])
                key = (min(a, b), max(a, b))
                edge_count[key] = edge_count.get(key, 0) + 1
        loop = _walk_boundary([e for e, n in edge_count.items() if n == 1])
        # CCW orientation by the shoelace sign
        pts = points[loop]
        area2 = np.sum(pts[:, 0] * np.roll(pts[:, 1], -1) -
                       np.roll(pts[:, 0], -1) * pts[:, 1])
        new_cells.append(loop[::-1] if area2 < 0 else loop)

    # boundary codes inherited from the old face table (sorted edge keys
    # + searchsorted)
    fp = mesh.face_ptids.cpu().numpy().astype(np.int64)
    fb = mesh.face_bnd.cpu().numpy()
    P = mesh.num_points
    old_keys = fp[:, 0] * P + fp[:, 1]
    korder = np.argsort(old_keys)
    old_keys_s = old_keys[korder]
    old_bnd_s = fb[korder]

    # untouched rows + merged polygons, padded with the last point and
    # lexsorted into the reference's sorted generation order
    m_npts = np.fromiter((len(c) for c in new_cells), np.int64,
                         count=len(new_cells))
    Pmax = int(max(cp.shape[1], m_npts.max() if len(m_npts) else 0))
    n_new = len(keep_ids) + len(new_cells)
    cell_ptids = np.zeros((n_new, Pmax), dtype=np.int64)
    cell_npts = np.concatenate([npts[keep_ids], m_npts])
    cell_ptids[:len(keep_ids), :cp.shape[1]] = cp[keep_ids]
    for i, c in enumerate(new_cells):
        cell_ptids[len(keep_ids) + i, :len(c)] = c
    last = cell_ptids[np.arange(n_new), cell_npts - 1]
    pad = np.arange(Pmax)[None, :] >= cell_npts[:, None]
    cell_ptids = np.where(pad, last[:, None], cell_ptids)
    sort_key = np.where(~pad, cell_ptids, -1)
    order = np.lexsort(sort_key.T[::-1])
    cell_ptids = cell_ptids[order]
    cell_npts = cell_npts[order]

    def raw_bnd(lo, hi, valid):
        keys = lo.astype(np.int64) * P + hi.astype(np.int64)
        pos = np.minimum(np.searchsorted(old_keys_s, keys),
                         len(old_keys_s) - 1)
        hit = old_keys_s[pos] == keys
        return np.where(valid & hit, old_bnd_s[pos], 0).astype(fb.dtype)

    t0 = _tick(timings, "merge_s", t0)
    new_mesh = _build_topology(points, cell_ptids, cell_npts, raw_bnd,
                               "poly", device=mesh.points.device,
                               dtype=mesh.points.dtype)
    _tick(timings, "rebuild_s", t0)
    return new_mesh, len(groups)


def agglomerate(mesh, phi, max_rounds: int = 3,
                timings: Optional[dict] = None) -> Tuple[Mesh, int]:
    """Merge every badly cut cell; returns (mesh', total merges). The
    result feeds cut_preprocess(..., displacement=False) and the fictdom
    and interface solves like any polygonal mesh. ``timings``: see
    _merge_round (summed over the rounds)."""
    total = 0
    for rnd in range(max_rounds):
        mesh, merged = _merge_round(mesh, phi, rnd == 0, timings)
        total += merged
        if merged == 0:
            break
    return mesh, total
