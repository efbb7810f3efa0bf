"""VTK / NumPy field export (JAX counterpart: proton_tpu/io/vtk.py; it
replaces the reference's SILO writer, src/dataio/silo_io.hpp).

A self-contained legacy-VTK (ASCII unstructured grid) writer plus an
.npz dump of the same data. Zonal (per-cell) and nodal (per-point)
variables mirror silo_io.hpp's centering (:141-171). Tensors are copied
to the host when they are added.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

VTK_QUAD = 9
VTK_POLYGON = 7


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


class VtkWriter:
    """Collects a mesh and variables, then writes .vtk and/or .npz
    (silo_database equivalent, silo_io.hpp:56-171)."""

    def __init__(self, mesh):
        self.points = _host(mesh.points)
        self.cell_ptids = _host(mesh.cell_ptids)
        self.cell_npts = _host(mesh.cell_npts)
        self.zonal: Dict[str, np.ndarray] = {}
        self.nodal: Dict[str, np.ndarray] = {}

    def add_variable(self, name: str, data, centering: str = "zonal"):
        data = _host(data).reshape(-1)
        if centering == "zonal":
            if len(data) != len(self.cell_ptids):
                raise ValueError(f"zonal variable '{name}' has wrong size")
            self.zonal[name] = data
        elif centering == "nodal":
            if len(data) != len(self.points):
                raise ValueError(f"nodal variable '{name}' has wrong size")
            self.nodal[name] = data
        else:
            raise ValueError(f"unknown centering '{centering}'")

    def write_vtk(self, filename: str):
        P, C = len(self.points), len(self.cell_ptids)
        with open(filename, "w") as fh:
            fh.write("# vtk DataFile Version 3.0\n")
            fh.write("proton_tpu export\nASCII\n")
            fh.write("DATASET UNSTRUCTURED_GRID\n")
            fh.write(f"POINTS {P} double\n")
            for x, y in self.points:
                fh.write(f"{x} {y} 0.0\n")
            fh.write(f"CELLS {C} {int(self.cell_npts.sum()) + C}\n")
            for ids, n in zip(self.cell_ptids, self.cell_npts):
                fh.write(str(n) + " " + " ".join(map(str, ids[:n])) + "\n")
            fh.write(f"CELL_TYPES {C}\n")
            for n in self.cell_npts:
                fh.write(f"{VTK_QUAD if n == 4 else VTK_POLYGON}\n")
            for header, fields in ((f"CELL_DATA {C}", self.zonal),
                                   (f"POINT_DATA {P}", self.nodal)):
                if not fields:
                    continue
                fh.write(header + "\n")
                for name, data in fields.items():
                    fh.write(f"SCALARS {name} double 1\n"
                             "LOOKUP_TABLE default\n")
                    fh.write("\n".join(map(str, data)) + "\n")

    def write_npz(self, filename: str):
        np.savez(filename, points=self.points, cell_ptids=self.cell_ptids,
                 cell_npts=self.cell_npts,
                 **{f"zonal_{k}": v for k, v in self.zonal.items()},
                 **{f"nodal_{k}": v for k, v in self.nodal.items()})


def output_mesh_info(mesh, cutdata, ls, basename: str = "cuthho_meshinfo"):
    """Cut-mesh diagnostic export (output_mesh_info,
    cuthho_square.cpp:1451-1519): cut-cell markers, level-set nodal
    values, node side, agglo-set class; writes ``basename``.vtk and .npz."""
    from ..cut.classify import LOC_NEG, LOC_POS

    w = VtkWriter(mesh)
    loc = _host(cutdata.cell_loc)
    w.add_variable("cut_cells", np.where(loc == LOC_POS, 1.0,
                                         np.where(loc == LOC_NEG, -1.0, 0.0)),
                   "zonal")
    w.add_variable("level_set", ls(mesh.points), "nodal")
    w.add_variable("node_pos", np.where(_host(cutdata.node_loc) == LOC_POS,
                                        1.0, -1.0), "nodal")
    w.add_variable("agglo_set", _host(cutdata.agglo_set).astype(float),
                   "zonal")
    w.write_vtk(basename + ".vtk")
    w.write_npz(basename + ".npz")
    return w


def dump_sparse_matrix(mat, filename: str):
    """Triplet dump "row col value" of a sparse COO tensor
    (dump_sparse_matrix, utils.hpp:376-386)."""
    mat = mat.coalesce()
    idx, vals = _host(mat.indices()), _host(mat.values())
    with open(filename, "w") as fh:
        for r, c, v in zip(idx[0], idx[1], vals):
            fh.write(f"{r} {c} {v}\n")
