"""proton_tpu_torch.core against proton_tpu.core on the CPU, float64:
bases, quadrature tables, the generated mesh and the cell geometry.

The JAX package's quadrature rules and cell geometry on random points are
read from tests/jax_refs/test_torch_core.npz (REFS below;
tests/torch_jax_reference.py writes it on the same seeded inputs)."""

import numpy as np
import jax.numpy as jnp
import pytest
import threadpoolctl
import torch

import proton_tpu as pt
from proton_tpu.core import bases as jbases, geometry as jgeometry, \
    quadrature as jquad
from proton_tpu_torch import convert
from proton_tpu_torch.core import bases, geometry, quadrature
from proton_tpu_torch.core.mesh import make_poly_mesh, make_quad_mesh
from torch_jax_reference import Refs

CPU = torch.device("cpu")
REFS = Refs(__name__)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """BLAS and torch on one thread: with a pool per core in every test
    worker the cores are oversubscribed many times over."""
    with threadpoolctl.threadpool_limits(1):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_bases_match(degree):
    """Cell values/gradients and face values at random points, 1e-14."""
    rng = np.random.default_rng(degree)
    pts = rng.uniform(0, 1, (5, 7, 2))
    bar = rng.uniform(0.3, 0.7, (5, 1, 2))
    h = rng.uniform(0.1, 0.5, (5, 1))
    fbase = rng.uniform(-1, 1, (5, 1, 2))
    t = lambda a: torch.as_tensor(a)
    for jf, tf in ((jbases.eval_cell_basis, bases.eval_cell_basis),
                   (jbases.eval_cell_gradients, bases.eval_cell_gradients)):
        ref = np.asarray(jf(jnp.asarray(pts), jnp.asarray(bar),
                            jnp.asarray(h), degree))
        out = tf(t(pts), t(bar), t(h), degree).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-14, atol=1e-14)
    ref = np.asarray(jbases.eval_face_basis(
        jnp.asarray(pts), jnp.asarray(bar), jnp.asarray(fbase),
        jnp.asarray(h), degree))
    out = bases.eval_face_basis(t(pts), t(bar), t(fbase), t(h), degree)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-14, atol=1e-14)
    for a, b in zip(bases._exponent_tables(degree),
                    jbases._exponent_tables(degree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("degree", [0, 1, 2, 5, 8])
def test_quadrature_tables_match(degree):
    """GL, Golub-Welsch and Duffy host tables are exact copies."""
    for tf, jf in ((quadrature.gauss_legendre, jquad.gauss_legendre),
                   (quadrature.golub_welsch, jquad.golub_welsch),
                   (quadrature.duffy_triangle, jquad.duffy_triangle)):
        for a, b in zip(tf(degree), jf(degree)):
            np.testing.assert_array_equal(a, b)


def _rule_points():
    rng = np.random.default_rng(0)
    base = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], float)
    return base[None] + rng.uniform(-0.2, 0.2, (6, 4, 2))


def _jax_rules():
    """The JAX package's quad cell, triangle and face rules of degrees 2,
    4, 6 on random quads."""
    p4 = _rule_points()
    return {deg: dict(
        quad=jquad.quad_cell_rule(jnp.asarray(p4), deg),
        triangle=jquad.triangle_rule(*(jnp.asarray(p4[:, i])
                                       for i in range(3)), deg),
        face=jquad.face_rule(jnp.asarray(p4[:, 0]), jnp.asarray(p4[:, 1]),
                             deg)) for deg in (2, 4, 6)}


REFS.add("rules", "quadrature",
         "quad_cell_rule, triangle_rule and face_rule of degrees 2, 4, 6 on "
         "6 random quads", _jax_rules, seed=0)


def test_device_rules_match():
    """Quad, triangle and face rules on random geometry, 1e-14."""
    p4 = _rule_points()
    rules = REFS["rules"]
    for deg in (2, 4, 6):
        r = quadrature.quad_cell_rule(torch.as_tensor(p4), deg)
        j = rules[deg].quad
        np.testing.assert_allclose(r.pts.numpy(), np.asarray(j.pts),
                                   rtol=1e-14, atol=1e-14)
        np.testing.assert_allclose(r.w.numpy(), np.asarray(j.w),
                                   rtol=1e-14, atol=1e-14)
        r = quadrature.triangle_rule(*(torch.as_tensor(p4[:, i])
                                       for i in range(3)), deg)
        j = rules[deg].triangle
        np.testing.assert_allclose(r.w.numpy(), np.asarray(j.w), rtol=1e-14)
        r = quadrature.face_rule(torch.as_tensor(p4[:, 0]),
                                 torch.as_tensor(p4[:, 1]), deg)
        j = rules[deg].face
        np.testing.assert_allclose(r.pts.numpy(), np.asarray(j.pts),
                                   rtol=1e-14, atol=1e-14)
        np.testing.assert_allclose(r.w.numpy(), np.asarray(j.w), rtol=1e-14)


@pytest.mark.parametrize("kind", ["poly", "quad"])
@pytest.mark.parametrize("nx,ny", [(4, 4), (5, 3), (16, 16)])
def test_mesh_arrays_exact(kind, nx, ny):
    jmake = pt.make_poly_mesh if kind == "poly" else pt.make_quad_mesh
    tmake = make_poly_mesh if kind == "poly" else make_quad_mesh
    jm = jmake(Nx=nx, Ny=ny)
    tm = tmake(Nx=nx, Ny=ny, device=CPU)
    assert tm.kind == jm.kind and tm.all_quads == jm.all_quads
    for f in ("points", "cell_ptids", "cell_npts", "cell_faces",
              "face_ptids", "face_bnd"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(jm, f)))
    assert tm.face_bnd.dtype == torch.int8


def _jittered_mesh():
    """The JAX package's 8x8 mesh with its points jittered."""
    jm = pt.make_poly_mesh(Nx=8, Ny=8)
    rng = np.random.default_rng(1)
    pts = np.asarray(jm.points) + rng.uniform(-0.02, 0.02, (81, 2))
    return jm.with_points(jnp.asarray(pts))


REFS.add("cell_geometry", "geometry",
         "cell_geometry(make_poly_mesh(8, 8) with points jittered)",
         lambda: jgeometry.cell_geometry(_jittered_mesh()), seed=1)


def test_cell_geometry_matches():
    """cell_geometry on a jittered 8x8 mesh, from identical points, 1e-14."""
    tm = convert.mesh(_jittered_mesh(), CPU)
    jg = REFS["cell_geometry"]
    tg = geometry.cell_geometry(tm)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14,
                                   atol=1e-14)


def test_entry_points_raise_without_cuda(monkeypatch):
    """No device and no CUDA: the mesh generator raises, never falls back
    to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_poly_mesh(Nx=4, Ny=4)
