"""The port's geometry families (cut/batched.py, apps/fictdom_family.py)
against proton_tpu on the CPU, float64: the padded cut class, circle,
ellipse and flower families geometry by geometry (H1 rtol 1e-8,
iterations within 2, equal cut counts and flags), the capacity overflow,
the H1 error of a padded batch, the app, and the device rule.

Each JAX family is one compiled program per (family, size, capacity); it
is computed once here, in a module fixture."""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import threadpoolctl
import torch

from proton_tpu.cut import batched as jbatched
from proton_tpu.cut import fictdom_structured as jfs
from proton_tpu.cut import methods as jcut_methods
from proton_tpu.core.geometry import cell_geometry as jcell_geometry
from proton_tpu.core.ops import HHODegreeInfo as JHHODegreeInfo
from proton_tpu.cut.classify import _preprocess_core as j_preprocess_core
from proton_tpu.core.mesh import make_poly_mesh as jmake_poly_mesh
from proton_tpu.solvers import cg as jcg
from proton_tpu_torch import convert
from proton_tpu_torch.apps import fictdom_family
from proton_tpu_torch.core.geometry import cell_geometry
from proton_tpu_torch.core.ops import HHODegreeInfo
from proton_tpu_torch.cut import batched
from proton_tpu_torch.cut import fictdom_structured as fs
from proton_tpu_torch.cut import methods as cut_methods
from proton_tpu_torch.cut.classify import LOC_CUT
from proton_tpu_torch.solvers import cg

CPU = torch.device("cpu")
N = 16
CG = dict(convergence_threshold=1e-10, divergence_threshold=1e8,
          max_iter=20000, apply_preconditioner=True)
# the JAX package's test_family_matches_unbatched geometries
RADII = np.array([0.30, 0.35, 0.41])
CENTERS = np.array([[0.5, 0.5], [0.5, 0.5], [0.48, 0.52]])
# two-geometry ellipse (a, b, cx, cy) and flower (r0, amp, cx, cy)
# families: the first of each degenerates to the circle of radius 0.33
ELLIPSES = (np.array([0.33, 0.30]), np.array([0.33, 0.22]),
            np.array([0.5, 0.48]), np.array([0.5, 0.52]))
FLOWERS = (np.array([0.33, 0.32]), np.array([0.0, 0.04]),
           np.array([0.5, 0.49]), np.array([0.5, 0.51]))
OVERFLOW_CAPACITY = 20


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """BLAS and torch on one thread (one pool per core in every test
    worker oversubscribes the cores)."""
    with threadpoolctl.threadpool_limits(1):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_families():
    """The JAX package's families at 16^2 k=1, CG tol 1e-10, as the
    port's FamilyResult."""
    cgp = jcg.CGParams(**CG)

    def host(r):
        return convert.family_result(r, CPU)

    return dict(
        circle=host(jbatched.solve_fictdom_family(N, 1, RADII, CENTERS,
                                                  cg_params=cgp)),
        ellipse=host(jbatched.solve_fictdom_family_params(
            N, 1, tuple(jnp.asarray(a) for a in ELLIPSES),
            jbatched.ellipse_family, cg_params=cgp)),
        flower=host(jbatched.solve_fictdom_family_params(
            N, 1, tuple(jnp.asarray(a) for a in FLOWERS),
            jbatched.flower_family(5), cg_params=cgp)),
        overflow=host(jbatched.solve_fictdom_family(
            N, 1, RADII[1:2], CENTERS[1:2], capacity=OVERFLOW_CAPACITY,
            cg_params=cgp)))


@pytest.fixture(scope="module")
def circles():
    return batched.solve_fictdom_family(N, 1, RADII, CENTERS,
                                        cg_params=cg.CGParams(**CG),
                                        device="cpu")


def _assert_matches(res, jres):
    """Geometry by geometry: H1 rtol 1e-8, iterations within 2, cut
    counts and flags equal, all converged with no overflow."""
    assert res.exit_reason.tolist() == jres.exit_reason.tolist()
    assert set(res.exit_reason.tolist()) == {cg.CONVERGED}
    assert torch.all((res.iterations - jres.iterations).abs() <= 2)
    np.testing.assert_allclose(res.h1_error.numpy(), jres.h1_error.numpy(),
                               rtol=1e-8)
    for field in ("n_cut", "n_cut_overflow", "n_bad_cuts", "concave"):
        assert getattr(res, field).tolist() == \
            getattr(jres, field).tolist(), field
    assert res.n_cut_overflow.tolist() == [0] * len(res.n_cut)


def test_padded_cut_ids():
    """The JAX package's cases, in both packages."""
    loc = np.array([0, LOC_CUT, 0, LOC_CUT, LOC_CUT], dtype=np.int8)
    for cap, want_ids, want_valid, want_over in (
            (4, [1, 3, 4, 5], [True, True, True, False], 0),
            (2, [1, 3], [True, True], 1),
            (8, [1, 3, 4, 5, 5], [True, True, True, False, False], 0)):
        ids, valid, n_cut, n_over = batched.padded_cut_ids(
            torch.as_tensor(loc), cap)
        jids, jvalid, jn_cut, jn_over = jbatched.padded_cut_ids(
            jnp.asarray(loc), cap)
        assert ids.tolist() == jids.tolist() == want_ids
        assert valid.tolist() == jvalid.tolist() == want_valid
        assert int(n_cut) == int(jn_cut) == 3
        assert int(n_over) == int(jn_over) == want_over


def test_circle_family_matches_jax(jax_families, circles):
    _assert_matches(circles, jax_families["circle"])


def test_family_matches_unbatched(circles):
    """Each geometry equals the structured solve of the same circle with
    Jacobi PCG on the fully assembled system (rtol 1e-8), and its cut
    count that of the host classification."""
    for b in range(len(RADII)):
        p = fs.default_problem(float(RADII[b]),
                               tuple(map(float, CENTERS[b])))
        r = fs.solve_fictdom_structured(N, 1, p, precond="jacobi",
                                        fitted="full",
                                        cg_params=cg.CGParams(**CG),
                                        device="cpu")
        assert np.isclose(float(circles.h1_error[b]), r.h1_error,
                          rtol=1e-8), (b, float(circles.h1_error[b]),
                                       r.h1_error)
        cut_ids = fs.classify_level(N, p, 4, device=CPU)[2]
        assert int(circles.n_cut[b]) == len(cut_ids)


def test_geom_chunk_matches_untiled():
    """A tile of 2 over 3 geometries (an uneven last tile) returns the
    untiled results exactly; a tile that is not a positive int raises."""
    radii = np.array([0.30, 0.33, 0.36])
    centers = np.tile(np.array([[0.5, 0.5]]), (3, 1))
    cgp = cg.CGParams(**dict(CG, convergence_threshold=1e-9))
    full = batched.solve_fictdom_family(12, 1, radii, centers,
                                        cg_params=cgp, device="cpu")
    tiled = batched.solve_fictdom_family(12, 1, radii, centers,
                                         geom_chunk=2, cg_params=cgp,
                                         device="cpu")
    for a, b in zip(full, tiled):
        assert torch.equal(a, b)
    for bad in (0, -1, 1.5):
        with pytest.raises(ValueError, match="geom_chunk"):
            batched.solve_fictdom_family(12, 1, radii, centers,
                                         geom_chunk=bad, device="cpu")


@pytest.mark.parametrize("shape", ["ellipse", "flower"])
def test_shape_families_match_jax(jax_families, shape):
    """Ellipse and 5-petal flower families at 16^2 B=2 against JAX; the
    degenerate ellipse (a = b) and the zero-amplitude flower equal the
    circle of the same radius."""
    params, family = ((ELLIPSES, batched.ellipse_family)
                      if shape == "ellipse" else
                      (FLOWERS, batched.flower_family(5)))
    cgp = cg.CGParams(**CG)
    res = batched.solve_fictdom_family_params(N, 1, params, family,
                                              cg_params=cgp, device="cpu")
    _assert_matches(res, jax_families[shape])
    circ = batched.solve_fictdom_family(N, 1, [0.33], [[0.5, 0.5]],
                                        cg_params=cgp, device="cpu")
    assert int(res.n_cut[0]) == int(circ.n_cut[0])
    assert int(res.iterations[0]) == int(circ.iterations[0])
    np.testing.assert_allclose(float(res.h1_error[0]),
                               float(circ.h1_error[0]), rtol=1e-10)


def test_capacity_overflow_matches_jax(jax_families):
    """A capacity below the cut count: NaN H1 and JAX's n_cut_overflow."""
    jres = jax_families["overflow"]
    res = batched.solve_fictdom_family(
        N, 1, RADII[1:2], CENTERS[1:2], capacity=OVERFLOW_CAPACITY,
        cg_params=cg.CGParams(**CG), device="cpu")
    assert int(res.n_cut_overflow[0]) == int(jres.n_cut_overflow[0]) > 0
    assert int(res.n_cut[0]) == int(jres.n_cut[0])
    assert int(res.n_cut[0]) - OVERFLOW_CAPACITY == \
        int(res.n_cut_overflow[0])
    assert np.isnan(float(res.h1_error[0]))
    assert np.isnan(float(jres.h1_error[0]))


def test_h1_error_cut_valid_matches_jax():
    """fictdom_h1_error_chunked on a padded batch (the JAX family's: cut
    ids padded to the capacity, clamped to C - 1) with cut_valid, against
    the JAX function on the same data: rtol 1e-12; and equal to the error
    over the unpadded batch."""
    k, cap = 1, 60
    hdi, jhdi = HHODegreeInfo(k + 1, k), JHHODegreeInfo(k + 1, k)
    p, jp = fs.default_problem(0.35), jfs.default_problem(0.35)
    jmesh = jmake_poly_mesh(Nx=N, Ny=N)
    pts, jcutdata, _, _ = j_preprocess_core(jmesh, jp.ls, 4,
                                            agglomeration=False,
                                            displacement=True)
    jmesh2 = jmesh.with_points(pts)
    jgeom = jcell_geometry(jmesh2)
    jids, jvalid, _, _ = jbatched.padded_cut_ids(jcutdata.cell_loc, cap)
    jbatch = jcut_methods.make_cut_batch(jmesh2, jgeom, jcutdata,
                                         jnp.minimum(jids, N * N - 1))
    rng = np.random.default_rng(5)
    local = rng.standard_normal((N * N, 14))
    jh1 = float(jfs.fictdom_h1_error_chunked(
        jmesh2, jgeom, jbatch, jcutdata.cell_loc, jhdi, jnp.asarray(local),
        jp.sol_grad, cut_valid=jvalid))

    mesh = convert.mesh(jmesh2, CPU)
    geom = cell_geometry(mesh)
    cutdata = convert.cut_data(jcutdata, CPU)
    ids, valid, n_cut, _ = batched.padded_cut_ids(cutdata.cell_loc, cap)
    assert ids.tolist() == np.asarray(jids).tolist()
    padded = cut_methods.make_cut_batch(mesh, geom, cutdata,
                                        torch.clamp(ids, max=N * N - 1))
    h1 = fs.fictdom_h1_error_chunked(mesh, geom, padded, cutdata.cell_loc,
                                     hdi, torch.as_tensor(local),
                                     p.sol_grad, cut_valid=valid)
    np.testing.assert_allclose(h1, jh1, rtol=1e-12)
    plain = cut_methods.make_cut_batch(mesh, geom, cutdata,
                                       ids[:int(n_cut)])
    np.testing.assert_allclose(
        fs.fictdom_h1_error_chunked(mesh, geom, plain, cutdata.cell_loc,
                                    hdi, torch.as_tensor(local),
                                    p.sol_grad), h1, rtol=1e-12)


def test_family_app_on_cpu(capsys):
    """The app at 16^2 B=3 on the CPU prints one JSON line with the JAX
    app's keys, all converged."""
    assert fictdom_family.main(["-N", "16", "-B", "3", "--device",
                                "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"N", "k", "B", "total_s", "per_geometry_s",
                        "h1_errors", "iterations", "n_cut",
                        "all_converged", "overflow", "shape", "backend"}
    assert out["all_converged"] and out["overflow"] == 0
    assert out["backend"] == "cpu" and len(out["h1_errors"]) == 3
    assert all(0 < h < 0.05 for h in out["h1_errors"])


def test_family_device_rule(monkeypatch):
    """No device given and no CUDA: the family and its app raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        batched.solve_fictdom_family(8, 1, [0.3], [[0.5, 0.5]])
    with pytest.raises(RuntimeError, match="CUDA"):
        fictdom_family.main(["-N", "8", "-B", "1"])
