"""proton_tpu_torch's generic cut path against proton_tpu on the CPU,
float64: the level sets, the three branches of cut_preprocess (and the
generic classification against the band one), make_test_points, the
fictitious-domain local operators, loads, solve, H1 error and fields,
and the cuthho_square app. The JAX package's fictdom solves run once per
module with their per-cell stages under jax.jit."""

import contextlib
import io
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import threadpoolctl
import torch

import proton_tpu as pt
from proton_tpu.core.geometry import cell_geometry as jcell_geometry
from proton_tpu.core.ops import HHODegreeInfo as JHDI
from proton_tpu.cut import classify as jclassify, fictdom as jfictdom, \
    levelset as jlevelset, methods as jmethods, quadrature as jquadrature
from proton_tpu.methods import assembly as jassembly
from proton_tpu_torch import convert
from proton_tpu_torch.apps import cuthho_square
from proton_tpu_torch.core.geometry import cell_geometry, cell_points
from proton_tpu_torch.core.mesh import make_poly_mesh
from proton_tpu_torch.core.ops import HHODegreeInfo
from proton_tpu_torch.cut import classify, fictdom, levelset, methods
from proton_tpu_torch.cut.fictdom_structured import default_problem
from proton_tpu_torch.cut.quadrature import make_test_points
from proton_tpu_torch.solvers import cg

CPU = torch.device("cpu")
PI = np.pi
CUTDATA_FIELDS = ("node_loc", "face_loc", "face_node_inside", "cell_loc",
                  "agglo_set", "distorted")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """BLAS and torch on one thread: with a pool per core in every test
    worker the cores are oversubscribed many times over."""
    with threadpoolctl.threadpool_limits(1):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)


def _jax_problem():
    def sol(p):
        return jnp.sin(PI * p[..., 0]) * jnp.sin(PI * p[..., 1])

    def grad(p):
        return jnp.stack([PI * jnp.cos(PI * p[..., 0]) * jnp.sin(PI * p[..., 1]),
                          PI * jnp.sin(PI * p[..., 0]) * jnp.cos(PI * p[..., 1])],
                         -1)

    return (lambda p: 2.0 * PI ** 2 * sol(p)), sol, grad


JLS = jlevelset.circle_level_set(0.35, 0.5, 0.5)


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(scope="module")
def refs():
    """N -> the JAX package's classified N^2 mesh, cut data and
    solve_fictdom result (k=1, check_coercivity) for N = 8, 16. Its
    stages, and those of fictdom_fields, run under jax.jit for the whole
    module."""
    from proton_tpu.core import bases as jbases, quadrature as jcore_quad
    from proton_tpu.methods import hho as jhho

    rhs, sol, grad = _jax_problem()
    mp = pytest.MonkeyPatch()
    for mod, name, static in (
            (jfictdom, "assemble_fictdom_local", (3, 4, 5, 6, 7)),
            (jfictdom, "assemble_fictdom_rhs", (3, 4, 5, 6, 8)),
            (jfictdom, "fictdom_h1_error", (4, 6, 7)),
            (jfictdom, "make_cut_batch", ()),
            (jmethods, "check_eigs", (1, 2, 3)),
            (jassembly, "dirichlet_face_data", (1, 2)),
            (jassembly, "local_dirichlet_data", ()),
            (jassembly, "assemble_rhs", ()),
            (jassembly, "operator_diagonal", ()),
            (jassembly, "take_local_data", ()),
            (jhho, "hho_laplacian", (2,)),
            (jbases, "eval_cell_basis", (3,)),
            (jcore_quad, "cell_rule", (2,))):
        mp.setattr(mod, name, jax.jit(getattr(mod, name),
                                      static_argnums=static))
    out = {}
    for N in (8, 16):
        jmesh, jcd = jclassify.cut_preprocess(pt.make_poly_mesh(Nx=N, Ny=N),
                                              JLS, levels=4)
        res = jfictdom.solve_fictdom(jmesh, jcd, JLS, 1, rhs, sol, grad,
                                     check_coercivity=True)
        out[N] = (jmesh, jcd, res)
    yield out
    mp.undo()


def test_levelsets_match():
    """line, ellipse and flower level sets: values, gradients and normals
    equal to the JAX package's (1e-13; the flower's gradient comes from
    autodiff in both)."""
    pts = np.random.default_rng(2).uniform(0.05, 0.95, (7, 3, 2))
    pairs = ((levelset.line_level_set(0.41), jlevelset.line_level_set(0.41)),
             (levelset.ellipse_level_set(0.3, 0.2, 0.5, 0.45),
              jlevelset.ellipse_level_set(0.3, 0.2, 0.5, 0.45)),
             (levelset.flower_level_set(0.3, 0.06, 5, 0.5, 0.5),
              jlevelset.flower_level_set(0.3, 0.06, 5, 0.5, 0.5)))
    tp, jp = torch.as_tensor(pts), jnp.asarray(pts)
    for ls, jls in pairs:
        want = jax.jit(lambda p: (jls(p), jls.gradient(p), jls.normal(p)))(jp)
        for got, ref in zip((ls(tp), ls.gradient(tp), ls.normal(tp)), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-13, atol=1e-14)


@pytest.mark.parametrize("branch", ["displacement", "agglomeration",
                                    "plain"])
def test_cut_preprocess_matches(branch):
    """cut_preprocess on every cell of the 16^2 mesh, each branch: the
    codes equal to JAX, points and interface polylines within 1e-13.
    Only the displacement branch moves nodes."""
    kw = dict(displacement=branch == "displacement",
              agglomeration=branch == "agglomeration")
    jmesh, jcd = jclassify.cut_preprocess(pt.make_poly_mesh(Nx=16, Ny=16),
                                          JLS, levels=4, **kw)
    mesh0 = make_poly_mesh(Nx=16, Ny=16, device=CPU)
    mesh, cd = classify.cut_preprocess(mesh0, default_problem().ls, 4, **kw)
    for f in CUTDATA_FIELDS:
        a, b = getattr(cd, f).numpy(), np.asarray(getattr(jcd, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_allclose(mesh.points.numpy(), np.asarray(jmesh.points),
                               rtol=0, atol=1e-13)
    cut = cd.cell_loc.numpy() == classify.LOC_CUT
    np.testing.assert_allclose(cd.interface.numpy()[cut],
                               np.asarray(jcd.interface)[cut], atol=1e-13)
    moved = not torch.equal(mesh.points, mesh0.points)
    assert moved == (branch == "displacement")
    assert bool(cd.distorted.any()) == moved
    agglo = cd.agglo_set.numpy()
    if branch == "agglomeration":
        assert set(agglo[cut]) <= {classify.AGGLO_OK, classify.AGGLO_KO_NEG,
                                   classify.AGGLO_KO_POS}
        assert (agglo[~cut] == classify.AGGLO_UNDEF).all()
        assert (agglo != classify.AGGLO_OK).sum() > (~cut).sum()
    else:
        assert (agglo == classify.AGGLO_UNDEF).all()


@pytest.mark.parametrize("N", [16, 32])
def test_generic_equals_band(N):
    """The generic displacement path on every cell equals the
    band-restricted one: codes, moved points and interfaces identical."""
    ls = default_problem().ls
    mesh = make_poly_mesh(Nx=N, Ny=N, device=CPU)
    mg, cg_ = classify.cut_preprocess(mesh, ls, 4)
    mb, cb = classify.cut_preprocess_band(mesh, ls, 4)
    for f in CUTDATA_FIELDS:
        assert torch.equal(getattr(cg_, f), getattr(cb, f)), f
    assert torch.equal(mg.points, mb.points)
    cut = cg_.cell_loc == classify.LOC_CUT
    assert torch.equal(cg_.interface[cut], cb.interface[cut])
    assert torch.equal(cg_.face_isect[cg_.face_loc == classify.LOC_CUT],
                       cb.face_isect[cb.face_loc == classify.LOC_CUT])


def test_cut_preprocess_raises_on_bad_cuts():
    """A saddle (x - 1/2)(y - 1/2) cuts all four faces of the one-cell
    mesh: the invalid cut count raises, as the reference throws
    (cuthho_geom.hpp:335-336)."""
    mesh = make_poly_mesh(Nx=1, Ny=1, device=CPU)
    ls = levelset.LevelSet(lambda p: (p[..., 0] - 0.5) * (p[..., 1] - 0.5))
    for kw in (dict(displacement=False), dict(agglomeration=True)):
        with pytest.raises(RuntimeError, match="invalid number of cuts"):
            classify.cut_preprocess(mesh, ls, 2, **kw)


def test_make_test_points_matches():
    """make_test_points: the bilinear grid and the side masks equal to
    JAX's on the 8^2 mesh's cells."""
    mesh = make_poly_mesh(Nx=8, Ny=8, device=CPU)
    jmesh = pt.make_poly_mesh(Nx=8, Ny=8)
    cp = cell_points(mesh)[:, :4]
    jcp = np.asarray(cp.numpy())
    for side in (classify.LOC_NEG, classify.LOC_POS):
        p, mask = make_test_points(cp, default_problem().ls, side)
        jpts, jmask = jquadrature.make_test_points(jnp.asarray(jcp), JLS,
                                                   side)
        np.testing.assert_allclose(p.numpy(), np.asarray(jpts), rtol=0,
                                   atol=1e-15)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        assert 0 < int(mask.sum()) < mask.numel()
    assert jmesh.num_cells == mesh.num_cells


@pytest.mark.parametrize("k", [0, 1])
def test_fictdom_stages_match(refs, k):
    """assemble_fictdom_local (lc, oper_cut), assemble_fictdom_rhs and
    check_eigs on the JAX classified 16^2 mesh: 1e-12 relative (oper_cut,
    a solve with the Nitsche stiffness of sliver cuts, 1e-10)."""
    jmesh, jcd, _ = refs[16]
    mesh, cd = convert.mesh(jmesh, CPU), convert.cut_data(jcd, CPU)
    ids = fictdom.cut_cell_ids(cd)
    jgeom = jcell_geometry(jmesh)
    jbatch = jmethods.make_cut_batch(jmesh, jgeom, jcd, ids)
    jhdi, hdi = JHDI(k + 1, k), HHODegreeInfo(k + 1, k)
    rhs, sol, _ = _jax_problem()
    jlc, joper = jax.jit(jfictdom.assemble_fictdom_local,
                         static_argnums=(3, 4, 5, 6, 7))(
        jmesh, jgeom, jbatch, JLS, jhdi, rhs, sol, classify.LOC_NEG)
    jf = jax.jit(jfictdom.assemble_fictdom_rhs,
                 static_argnums=(3, 4, 5, 6, 8))(
        jmesh, jgeom, jbatch, JLS, jhdi, rhs, sol, jcd.cell_loc,
        classify.LOC_NEG)
    p = default_problem()
    geom = cell_geometry(mesh)
    batch = methods.make_cut_batch(mesh, geom, cd, ids)
    lc, oper = fictdom.assemble_fictdom_local(mesh, geom, batch, p.ls, hdi)
    f = fictdom.assemble_fictdom_rhs(mesh, geom, batch, p.ls, hdi,
                                     p.rhs_fun, p.sol_fun, cd.cell_loc)
    assert _rel(lc, jlc) < 1e-12
    assert _rel(oper, joper) < 1e-10
    assert _rel(f, jf) < 1e-12
    jeig = jax.jit(jmethods.check_eigs, static_argnums=(1, 2, 3))(
        jbatch, JLS, jhdi, classify.LOC_NEG)
    assert _rel(methods.check_eigs(batch, p.ls, hdi, classify.LOC_NEG),
                jeig) < 1e-11


@pytest.mark.parametrize("N", [8, 16])
def test_solve_fictdom_matches(refs, N):
    """solve_fictdom k=1 on the JAX classified mesh: iterations within 2,
    H1 within 1e-9, local dofs within 1e-8 of their max, the coercivity
    diagnostic positive and within 1e-11; the H1 error recomputed from
    the JAX local dofs within 1e-13."""
    jmesh, jcd, jres = refs[N]
    mesh, cd = convert.mesh(jmesh, CPU), convert.cut_data(jcd, CPU)
    p = default_problem()
    res = fictdom.solve_fictdom(mesh, cd, p.ls, 1, p.rhs_fun, p.sol_fun,
                                p.sol_grad, check_coercivity=True)
    want = convert.fictdom_result(jres, CPU)
    assert res.exit_reason == want.exit_reason == cg.CONVERGED
    assert abs(res.iterations - want.iterations) <= 2
    assert abs(res.h1_error - want.h1_error) < 1e-9 * want.h1_error
    assert _rel(res.local, want.local) < 1e-8
    assert _rel(res.min_eigs, want.min_eigs) < 1e-11
    assert float(res.min_eigs.min()) > 0
    geom = cell_geometry(mesh)
    batch = methods.make_cut_batch(mesh, geom, cd, fictdom.cut_cell_ids(cd))
    h1 = fictdom.fictdom_h1_error(mesh, geom, batch, cd, HHODegreeInfo(2, 1),
                                  want.local, p.sol_grad)
    assert abs(float(h1) - want.h1_error) < 1e-13 * want.h1_error


def test_fictdom_fields_match(refs):
    """fictdom_fields (uT, Ru, diff at a degree-5 rule) from the JAX
    result, 1e-12 relative."""
    jmesh, jcd, jres = refs[8]
    mesh, cd = convert.mesh(jmesh, CPU), convert.cut_data(jcd, CPU)
    p = default_problem()
    out = fictdom.fictdom_fields(mesh, cd, p.ls, 1,
                                 convert.fictdom_result(jres, CPU),
                                 p.sol_fun)
    jout = jfictdom.fictdom_fields(jmesh, jcd, JLS, 1, jres,
                                   _jax_problem()[1])
    for a, b in zip(out, jout):
        assert _rel(a, b) < 1e-12


def test_run_fictdom_order():
    """run_fictdom k=1: the JAX package's 16^2 and 32^2 numbers (CG
    iterations within 2, H1 within 1e-8; JAX: 333 / 1,115 iterations,
    H1 4.434838976686683e-3 / 1.1344765305280414e-3) and H1 order ~2."""
    ref = {16: (333, 4.434838976686683e-3), 32: (1115, 1.1344765305280414e-3)}
    h1 = {}
    for N, (its, err) in ref.items():
        r = fictdom.run_fictdom(N, 1, device=CPU)
        assert abs(r.iterations - its) <= 2
        assert abs(r.h1_error - err) < 1e-8 * err
        h1[N] = r.h1_error
    assert 1.8 < np.log2(h1[16] / h1[32]) < 2.2


def _app(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cuthho_square.main(argv) == 0
    return buf.getvalue()


def test_cuthho_square_app(tmp_path, monkeypatch):
    """The app at 8^2 on the CPU: -f -i print the errors of run_fictdom /
    run_interface; -A -f -d writes the mesh info and the point clouds,
    and without matplotlib it skips the plots and says so."""
    monkeypatch.chdir(tmp_path)
    out = _app(["-f", "-i", "-M", "8", "-N", "8", "-k", "1",
                "--device", "cpu"])
    errors = [float(ln.split()[-1]) for ln in out.splitlines()
              if "Energy-norm absolute error" in ln]
    from proton_tpu_torch.cut import interface_problem
    want = [interface_problem.run_interface(8, 1, device=CPU).h1_error,
            fictdom.run_fictdom(8, 1, device=CPU).h1_error]
    np.testing.assert_allclose(errors, want, rtol=1e-13)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = _app(["-A", "-f", "-d", "-M", "8", "-N", "8", "-k", "1",
                "--device", "cpu"])
    assert "skipped debug plots" in out
    for name in ("cuthho_meshinfo.vtk", "cuthho_meshinfo.npz",
                 "fictdom_uT.dat", "fictdom_Ru.dat", "fictdom_diff.dat"):
        assert (tmp_path / name).stat().st_size > 0, name
    npz = np.load(tmp_path / "cuthho_meshinfo.npz")
    assert set(np.unique(npz["zonal_agglo_set"])) > {0.0}
    rows = np.loadtxt(tmp_path / "fictdom_uT.dat")
    assert rows.shape[1] == 3 and np.isfinite(rows).all()


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """No device given and no CUDA: run_fictdom and the app raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        fictdom.run_fictdom(8, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        cuthho_square.main(["-f", "-M", "8", "-N", "8"])


def test_assemble_fictdom_local_takes_jax_arguments():
    """The JAX argument list (mesh, geom, batch, ls, hdi, rhs_fun,
    bcs_fun, side) works: the two functions are ignored, as in JAX, and
    side lands in side."""
    p = default_problem()
    mesh, cd = classify.cut_preprocess(make_poly_mesh(Nx=8, Ny=8,
                                                      device=CPU), p.ls, 4)
    geom = cell_geometry(mesh)
    batch = methods.make_cut_batch(mesh, geom, cd, fictdom.cut_cell_ids(cd))
    hdi = HHODegreeInfo(2, 1)
    for side in (classify.LOC_NEG, classify.LOC_POS):
        lc, oper = fictdom.assemble_fictdom_local(mesh, geom, batch, p.ls,
                                                  hdi, p.rhs_fun, p.sol_fun,
                                                  side)
        lc_kw, oper_kw = fictdom.assemble_fictdom_local(mesh, geom, batch,
                                                        p.ls, hdi, side=side)
        assert torch.equal(lc, lc_kw) and torch.equal(oper, oper_kw)
    neg, _ = fictdom.assemble_fictdom_local(mesh, geom, batch, p.ls, hdi)
    assert torch.equal(neg, fictdom.assemble_fictdom_local(
        mesh, geom, batch, p.ls, hdi, None, None, classify.LOC_NEG)[0])
    assert not torch.equal(neg, lc)
