"""Invariant checks of a classified cut mesh and of local matrices (JAX
counterpart: proton_tpu/utils/debug.py, minus ``enable_nan_debugging``,
which toggles JAX's jax_debug_nans and has no torch counterpart)."""

from __future__ import annotations

import numpy as np

from ..io.vtk import _host


def check_classification(mesh, cutdata):
    """Host-side invariant sweep over a classified cut mesh (the asserts
    and throws of cuthho_geom.hpp:31-47, 335-336). Returns a dict of
    violation counts, all zero on a healthy mesh."""
    from ..cut.classify import LOC_CUT, LOC_NEG, LOC_POS

    node_loc = _host(cutdata.node_loc)
    face_loc = _host(cutdata.face_loc)
    cell_loc = _host(cutdata.cell_loc)
    out = {
        "undef_nodes": int((~np.isin(node_loc, [LOC_NEG, LOC_POS])).sum()),
        "undef_faces": int((~np.isin(face_loc,
                                     [LOC_NEG, LOC_POS, LOC_CUT])).sum()),
        "undef_cells": int((~np.isin(cell_loc,
                                     [LOC_NEG, LOC_POS, LOC_CUT])).sum()),
    }

    # cut faces must separate the sides
    fp_loc = node_loc[_host(mesh.face_ptids)]
    cut = face_loc == LOC_CUT
    out["bad_cut_faces"] = int((fp_loc[cut, 0] == fp_loc[cut, 1]).sum())

    # cut cells: exactly two cut faces
    cf_loc = face_loc[_host(mesh.cell_faces)]
    valid = np.arange(mesh.max_pts)[None, :] < _host(mesh.cell_npts)[:, None]
    counts = ((cf_loc == LOC_CUT) & valid).sum(axis=1)
    out["bad_cut_counts"] = int(((counts != 0) & (counts != 2)).sum())
    out["cut_cells_wrong_loc"] = int(
        ((counts == 2) != (cell_loc == LOC_CUT)).sum())
    return out


def assert_spd(matrices, atol: float = 1e-9, name: str = "matrix"):
    """Host-side SPD check of a batch of local matrices (the coercivity
    companion of check_eigs, cuthho_square.cpp:504-560). Returns the
    smallest eigenvalue."""
    M = _host(matrices)
    sym = np.max(np.abs(M - np.swapaxes(M, -1, -2)))
    if sym > atol:
        raise AssertionError(f"{name} not symmetric: max asym {sym:.3e}")
    eigs = np.linalg.eigvalsh(M)
    if eigs.min() < -atol:
        raise AssertionError(
            f"{name} not PSD: min eigenvalue {eigs.min():.3e}")
    return float(eigs.min())
