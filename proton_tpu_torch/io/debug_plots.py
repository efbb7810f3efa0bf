"""Debug dumps of the cut mesh, its quadratures and its bases (JAX
counterpart: proton_tpu/io/debug_plots.py; they replace the reference's
MATLAB .m dumps: dump_mesh at cuthho_geom.hpp:937-997, test_triangulation
at cuthho_square.cpp:275-291, and the quiver / normals dumps of
test_integration, :670-732).

The .dat writers need only NumPy. The renderers need matplotlib, which is
optional: importing this module without it works, and ``dump_mesh``,
``plot_triangulation`` and ``plot_field`` raise ImportError when called.
"""

from __future__ import annotations

import numpy as np
import torch

from .vtk import _host


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def dump_mesh(mesh, cutdata=None, filename: str = "mesh_dump.png"):
    """Faces coloured by kind (boundary red / cut green / interior black),
    and the interface polylines of the cut cells."""
    from ..cut.classify import LOC_CUT

    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 8))
    fp = _host(mesh.points)[_host(mesh.face_ptids)]
    bnd = _host(mesh.face_bnd) != 0
    cut = (_host(cutdata.face_loc) == LOC_CUT) if cutdata is not None \
        else np.zeros(len(fp), dtype=bool)
    for sel, color in ((bnd, "r"), (cut & ~bnd, "g"), (~bnd & ~cut, "k")):
        for p0, p1 in fp[sel]:
            ax.plot([p0[0], p1[0]], [p0[1], p1[1]], color=color,
                    linewidth=0.6)
    if cutdata is not None:
        iface = _host(cutdata.interface)
        for c in np.nonzero(_host(cutdata.cell_loc) == LOC_CUT)[0]:
            ax.plot(iface[c, :, 0], iface[c, :, 1], "b.-", markersize=2,
                    linewidth=0.8)
    ax.set_aspect("equal")
    fig.savefig(filename, dpi=150)
    plt.close(fig)
    return filename


def plot_triangulation(mesh, cutdata, side, filename="triangulation.png"):
    """Fan triangulation of the cut cells (test_triangulation)."""
    from ..core.geometry import cell_points
    from ..cut import quadrature as cq
    from ..cut.classify import LOC_CUT

    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 8))
    ids = torch.as_tensor(
        np.nonzero(_host(cutdata.cell_loc) == LOC_CUT)[0],
        device=mesh.points.device)
    poly = cq.triangulation_points(
        cell_points(mesh)[ids], mesh.cell_npts[ids],
        cutdata.node_loc[mesh.cell_ptids[ids]], cutdata.interface[ids], side)
    tp, count, bar = _host(poly.tp), _host(poly.count), _host(poly.bar)
    for c in range(len(ids)):
        n = count[c]
        for i in range(n):
            a, b = tp[c, i], tp[c, (i + 1) % n]
            ax.plot([a[0], b[0]], [a[1], b[1]], "k-", linewidth=0.5)
            ax.plot([bar[c, 0], a[0]], [bar[c, 1], a[1]], "b-",
                    linewidth=0.3)
    ax.set_aspect("equal")
    fig.savefig(filename, dpi=150)
    plt.close(fig)
    return filename


def make_test_points_cells(mesh, n: int = 10):
    """(n+1)^2 reference-grid points per cell through the bilinear map
    (make_test_points cell overload, basic_geom.hpp:406-431), [C,
    (n+1)^2, 2] on the mesh's device."""
    from ..core.geometry import cell_points
    from ..core.quadrature import bilinear_ref_to_phys

    t = np.linspace(-1.0, 1.0, n + 1)
    xi, eta = np.meshgrid(t, t)                       # i fast, j slow
    cp = cell_points(mesh)[:, :4, :]
    ref = torch.as_tensor(np.stack([xi.ravel(), eta.ravel()], axis=1),
                          dtype=cp.dtype, device=cp.device)
    return bilinear_ref_to_phys(cp, ref)


def make_test_points_faces(mesh, n: int = 10):
    """n+1 equispaced points per face (make_test_points face overload,
    basic_geom.hpp:435-454), [F, n+1, 2]."""
    fp = mesh.points[mesh.face_ptids]                      # [F, 2, 2]
    t = torch.linspace(0.0, 1.0, n + 1, dtype=fp.dtype,
                       device=fp.device)[None, :, None]
    return fp[:, :1, :] + t * (fp[:, 1:2, :] - fp[:, :1, :])


def _write_dat(filename, pts, vals):
    """Rows 'x y v0 v1 ...' flattened over (entity, point)."""
    pts2 = _host(pts).reshape(-1, 2)
    vals2 = _host(vals).reshape(len(pts2), -1)
    with open(filename, "w") as fh:
        for p, v in zip(pts2, vals2):
            fh.write(" ".join(f"{x:.17g}" for x in (*p, *v)) + "\n")
    return filename


def _face_frames(mesh):
    """(fp [F, 2, 2], bar [F, 2], base [F, 2], h [F]) of every face."""
    fp = mesh.points[mesh.face_ptids]
    bar = 0.5 * (fp[:, 0] + fp[:, 1])
    return fp, bar, bar - fp[:, 0], torch.linalg.vector_norm(
        fp[:, 1] - fp[:, 0], dim=-1)


def plot_basis_functions(mesh, cell_file="cell_basis_check.dat",
                         face_file="face_basis_check.dat"):
    """Basis values at the test-point grids: the cell basis at degree 3,
    the face basis at degree 2, as the reference hard-codes
    (plot_basis_functions, cuthho_square.cpp:130-177)."""
    from ..core import bases
    from ..core.geometry import cell_geometry

    geom = cell_geometry(mesh)
    tps = make_test_points_cells(mesh)
    _write_dat(cell_file, tps, bases.eval_cell_basis(
        tps, geom.bar[:, None, :], geom.diam[:, None], 3))
    _, fbar, fbase, fh = _face_frames(mesh)
    ftps = make_test_points_faces(mesh)
    _write_dat(face_file, ftps, bases.eval_face_basis(
        ftps, fbar[:, None, :], fbase[:, None, :], fh[:, None], 2))
    return cell_file, face_file


def plot_quadrature_points(mesh, degree: int,
                           cell_file="cell_quadrature_check.dat",
                           face_file="face_quadrature_check.dat"):
    """Quadrature nodes and weights of every cell and face
    (plot_quadrature_points, cuthho_square.cpp:179-212)."""
    from ..core import quadrature
    from ..core.geometry import cell_geometry

    crule = quadrature.cell_rule(mesh, cell_geometry(mesh), degree)
    _write_dat(cell_file, crule.pts, crule.w[..., None])
    fp = mesh.points[mesh.face_ptids]
    frule = quadrature.face_rule(fp[:, 0], fp[:, 1], degree)
    _write_dat(face_file, frule.pts, frule.w[..., None])
    return cell_file, face_file


def test_mass_matrices(mesh, degree: int,
                       cell_file="cell_mass_check.dat",
                       face_file="face_mass_check.dat"):
    """L2-project sin(pi x) sin(pi y) on every cell and face basis and
    dump the projections at the test points (test_mass_matrices,
    cuthho_square.cpp:215-273)."""
    from ..core import bases, ops
    from ..core.geometry import cell_geometry

    def fun(p):
        return torch.sin(np.pi * p[..., 0]) * torch.sin(np.pi * p[..., 1])

    geom = cell_geometry(mesh)
    mass = ops.cell_mass_matrices(mesh, geom, degree)
    rhs = ops.cell_rhs(mesh, geom, degree, fun)
    sol = ops.cho_solve_batched(mass, rhs[..., None])[..., 0]
    tps = make_test_points_cells(mesh)
    cphi = bases.eval_cell_basis(tps, geom.bar[:, None, :],
                                 geom.diam[:, None], degree)
    _write_dat(cell_file, tps,
               torch.einsum("cqi,ci->cq", cphi, sol)[..., None])

    fp, fbar, fbase, fh = _face_frames(mesh)
    fsol = ops.cho_solve_batched(
        ops.face_mass_matrices(fp, degree),
        ops.face_rhs(fp, degree, fun)[..., None])[..., 0]
    ftps = make_test_points_faces(mesh)
    fphi = bases.eval_face_basis(ftps, fbar[:, None, :], fbase[:, None, :],
                                 fh[:, None], degree)
    _write_dat(face_file, ftps,
               torch.einsum("fqi,fi->fq", fphi, fsol)[..., None])
    return cell_file, face_file


def plot_field(pts, vals, filename="field.png", title=""):
    """Scatter plot of a point-cloud field (the gnuplot .dat equivalent)."""
    plt = _plt()
    pts = _host(pts).reshape(-1, 2)
    vals = _host(vals).reshape(-1)
    fig, ax = plt.subplots(figsize=(8, 7))
    sc = ax.scatter(pts[:, 0], pts[:, 1], c=vals, s=3, cmap="viridis")
    fig.colorbar(sc, ax=ax)
    ax.set_aspect("equal")
    ax.set_title(title)
    fig.savefig(filename, dpi=150)
    plt.close(fig)
    return filename
