"""The port's API against proton_tpu's on the CPU, float64: the package
namespace (every name of proton_tpu/__init__.py, the mesh constructors
and the cell geometry called through both), the module constants, and the
face-grid layout conversions of methods/cells_last.py (row-major GridVec
<-> cells-last GridVecCL)."""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proton_tpu
import proton_tpu_torch as pt
from proton_tpu.cut import classify as jclassify
from proton_tpu.methods import cells_last as jcl, structured as jstructured
from proton_tpu_torch.core import quadrature
from proton_tpu_torch.cut import classify
from proton_tpu_torch.methods import cells_last, structured

ROOT = Path(__file__).resolve().parent.parent

CPU = torch.device("cpu")


def _close(a, ref, tol=1e-12):
    ref = np.asarray(ref)
    assert np.asarray(a).shape == ref.shape
    assert np.max(np.abs(np.asarray(a) - ref)) <= tol * np.max(np.abs(ref))


@pytest.mark.parametrize("fbs", [1, 2])
def test_grid_layout_conversions_match(fbs):
    """to_cells_last and from_cells_last against JAX on a 7 x 5 face
    grid; the round trip is the identity."""
    Nx, Ny = 7, 5
    rng = np.random.default_rng(fbs)
    H = rng.standard_normal((Ny + 1, Nx, fbs))
    V = rng.standard_normal((Ny, Nx + 1, fbs))
    jx = jcl.to_cells_last(jstructured.GridVec(jnp.asarray(H),
                                               jnp.asarray(V)))
    x = cells_last.to_cells_last(structured.GridVec(torch.as_tensor(H),
                                                    torch.as_tensor(V)))
    for a, b in zip(x, jx):
        _close(a.numpy(), b, 0.0)
    back = cells_last.from_cells_last(x)
    assert isinstance(back, structured.GridVec)
    for a, b in zip(back, jcl.from_cells_last(jx)):
        _close(a.numpy(), b, 0.0)
    _close(back.H.numpy(), H, 0.0)
    _close(back.V.numpy(), V, 0.0)


def _init_imports():
    """(module, name) of every name proton_tpu/__init__.py imports, with
    the module relative to the package ("" for the package itself)."""
    tree = ast.parse((ROOT / "proton_tpu" / "__init__.py").read_text())
    return [(node.module or "", a.asname or a.name)
            for node in tree.body if isinstance(node, ast.ImportFrom)
            for a in node.names]


def test_namespace_holds_every_name_of_proton_tpu():
    """Every name proton_tpu/__init__.py imports resolves on
    proton_tpu_torch, and is the object of the port module it comes from;
    __version__ and the boundary codes are the JAX package's."""
    pairs = _init_imports()
    assert len(pairs) == 16
    for module, name in pairs:
        src = importlib.import_module(
            "proton_tpu_torch" + ("." + module if module else ""))
        assert getattr(pt, name) is getattr(src, name), name
        assert hasattr(proton_tpu, name), name
    assert pt.__version__ == proton_tpu.__version__ == "0.1.0"
    for name in ("BND_NONE", "BND_DIRICHLET", "BND_NEUMANN", "BND_ROBIN"):
        assert getattr(pt, name) == getattr(proton_tpu, name)
    assert (pt.BND_NEUMANN, pt.BND_ROBIN) == (2, 3)
    assert quadrature.edge_quadrature is quadrature.gauss_legendre


def test_namespace_import_builds_no_kernel():
    """Importing the package imports no JAX, loads no kernel library and
    starts no compiler: K1 is built on its first launch."""
    code = ("import ctypes, subprocess, sys\n"
            "sys.modules['jax'] = None\n"
            "seen = []\n"
            "cdll, popen = ctypes.CDLL, subprocess.Popen\n"
            "ctypes.CDLL = lambda name, *a, **k: (seen.append(str(name)),"
            " cdll(name, *a, **k))[1]\n"
            "subprocess.Popen = lambda args, *a, **k: (seen.append("
            "str(args)), popen(args, *a, **k))[1]\n"
            "import proton_tpu_torch as pt\n"
            "pt.HHODegreeInfo(2, 1)\n"
            "print([s for s in seen if 'fused' in s or 'nvcc' in s])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("kind", ["quad", "poly"])
def test_namespace_mesh_and_geometry_match(kind):
    """make_quad_mesh / make_poly_mesh at 8^2 and cell_geometry, each
    called through both namespaces on the same inputs: points, cell areas
    and centroids, and every other member of the geometry, within 1e-12;
    the topology equal."""
    make = "make_quad_mesh" if kind == "quad" else "make_poly_mesh"
    jmesh = getattr(proton_tpu, make)(Nx=8, Ny=8)
    mesh = getattr(pt, make)(Nx=8, Ny=8, device="cpu")
    assert mesh.kind == jmesh.kind == kind
    np.testing.assert_allclose(mesh.points.numpy(), np.asarray(jmesh.points),
                               rtol=0, atol=1e-12)
    for name in ("cell_ptids", "cell_npts", "cell_faces", "face_ptids",
                 "face_bnd"):
        np.testing.assert_array_equal(getattr(mesh, name).numpy(),
                                      np.asarray(getattr(jmesh, name)))
    geom = pt.cell_geometry(mesh)
    jgeom = jax.jit(proton_tpu.cell_geometry)(jmesh)
    assert isinstance(geom, pt.CellGeom)
    np.testing.assert_allclose(geom.meas.numpy(), 1.0 / 64, atol=1e-12)
    for name, a in zip(geom._fields, geom):
        b = np.asarray(getattr(jgeom, name))
        if a.dtype.is_floating_point:
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-12,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def test_namespace_keeps_the_device_rule():
    """A constructor of the namespace runs on CUDA unless asked for the
    CPU: without a device and without CUDA it raises."""
    if torch.cuda.is_available():
        assert pt.make_quad_mesh(Nx=4, Ny=4).points.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            pt.make_quad_mesh(Nx=4, Ny=4)
    assert pt.make_quad_mesh(Nx=4, Ny=4, device="cpu").num_cells == 16


def test_cut_data_interface_points_match():
    """CutData.n_interface_points, the width of the refined interface
    polyline, equals the JAX package's on the same 8^2 classification
    (JAX's traced, not compiled: only its shapes are read)."""
    from proton_tpu.cut import levelset as jlevelset
    from proton_tpu_torch.cut import levelset
    jmesh = proton_tpu.make_quad_mesh(Nx=8, Ny=8)
    mesh = pt.make_quad_mesh(Nx=8, Ny=8, device="cpu")
    for levels in (1, 3):
        jcd = jax.eval_shape(lambda m: jclassify._preprocess_core(
            m, phi=jlevelset.circle_level_set(0.35, 0.5, 0.5), levels=levels,
            agglomeration=False, displacement=True)[1], jmesh)
        cd = classify.cut_preprocess(
            mesh, levelset.circle_level_set(0.35, 0.5, 0.5), levels)[1]
        assert cd.n_interface_points == jcd.n_interface_points
        assert cd.n_interface_points == tuple(cd.interface.shape)[1]
