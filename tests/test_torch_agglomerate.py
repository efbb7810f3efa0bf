"""proton_tpu_torch's cell agglomeration and the cut-mesh diagnostics
against proton_tpu on the CPU, float64: the side measures, the face
neighbour table, the merge itself at 8^2 and 16^2 (every mesh array
equal), plain classification and the fictdom solve on the merged mesh,
the agglomeration-detection branch with make_neighbors_info,
output_mesh_info, the invariant checks of utils/debug.py and the debug
dumps. The JAX package's merge runs once per size with its device stages
under jax.jit."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import threadpoolctl
import torch

import proton_tpu as pt
from proton_tpu.cut import agglomerate as jagglomerate, \
    classify as jclassify, fictdom as jfictdom, levelset as jlevelset, \
    quadrature as jquadrature
from proton_tpu.io import debug_plots as jdebug_plots, vtk as jvtk
from proton_tpu.utils import debug as jdebug
from proton_tpu_torch import convert
from proton_tpu_torch.core.geometry import cell_geometry
from proton_tpu_torch.core.mesh import make_poly_mesh
from proton_tpu_torch.cut import agglomerate, classify, fictdom
from proton_tpu_torch.cut.fictdom_structured import default_problem
from proton_tpu_torch.cut.methods import make_cut_batch
from proton_tpu_torch.io import debug_plots, vtk
from proton_tpu_torch.solvers import cg
from proton_tpu_torch.utils import debug

CPU = torch.device("cpu")
PI = np.pi
JLS = jlevelset.circle_level_set(0.35, 0.5, 0.5)
MESH_FIELDS = ("cell_ptids", "cell_npts", "cell_faces", "face_ptids",
               "face_bnd")


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


@pytest.fixture(scope="module")
def refs():
    """N -> (JAX agglomerated mesh, merges) for N = 8, 16, and the JAX
    package's plain classification and fictdom solve (k=1) on the 8^2
    merged mesh. The device stages of the merge and of the solve, and the
    bases, rules and mass matrices of the debug dumps, run under jax.jit
    for the whole module."""
    from proton_tpu.core import bases as jbases, ops as jops, \
        quadrature as jcore_quadrature

    mp = pytest.MonkeyPatch()
    jit = jax.jit
    for mod, name, static in (
            (jagglomerate, "detect_node_position", (1,)),
            (jagglomerate, "detect_cut_faces", (1,)),
            (jagglomerate, "detect_cut_cells", (1,)),
            (jagglomerate, "detect_cell_agglo_set", (1,)),
            (jclassify, "refine_interface", (1, 3)),
            (jagglomerate, "cell_geometry", ()),
            (jagglomerate, "cell_points", ()),
            (jquadrature, "triangulation_points", (4,)),
            (jquadrature, "side_measure", ()),
            (jfictdom, "assemble_fictdom_local", (3, 4, 5, 6, 7)),
            (jfictdom, "assemble_fictdom_rhs", (3, 4, 5, 6, 8)),
            (jfictdom, "fictdom_h1_error", (4, 6, 7)),
            (jbases, "eval_cell_basis", (3,)),
            (jbases, "eval_face_basis", (4,)),
            (jops, "cell_mass_matrices", (2,)),
            (jops, "cell_rhs", (2, 3)),
            (jops, "face_mass_matrices", (1,)),
            (jops, "face_rhs", (1, 2)),
            (jcore_quadrature, "cell_rule", (2,)),
            (jcore_quadrature, "face_rule", (2,))):
        mp.setattr(mod, name, jit(getattr(mod, name), static_argnums=static))
    out = {}
    for N in (8, 16):
        out[N] = jagglomerate.agglomerate(pt.make_poly_mesh(Nx=N, Ny=N), JLS)
    m3, cd = jclassify.cut_preprocess(out[8][0], JLS, levels=3,
                                      displacement=False)
    out["solve"] = (m3, cd, jfictdom.solve_fictdom(m3, cd, JLS, 1,
                                                   *_jax_problem()))
    yield out
    mp.undo()


@pytest.mark.parametrize("N", [8, 16])
def test_agglomerate_matches(refs, N):
    """agglomerate on the N^2 mesh: the merge count, every topology array
    and the points equal to the JAX package's; merged polygons (6
    points) appear, the area is conserved, no badly cut cell is left."""
    jm, jn = refs[N]
    ls = default_problem().ls
    timings = {}
    m, n = agglomerate.agglomerate(make_poly_mesh(Nx=N, Ny=N, device=CPU),
                                   ls, timings=timings)
    assert n == jn > 0
    assert m.num_cells == N * N - n and m.max_pts == 6 == jm.max_pts
    for f in MESH_FIELDS:
        np.testing.assert_array_equal(getattr(m, f).numpy(),
                                      np.asarray(getattr(jm, f)), err_msg=f)
    assert torch.equal(m.points, torch.as_tensor(np.array(jm.points)))
    assert (m.kind, m.all_quads) == (jm.kind, jm.all_quads)
    assert set(timings) == {"classify_s", "merge_s", "rebuild_s"}
    geom = cell_geometry(m)
    assert abs(float(geom.meas.sum()) - 1.0) < 1e-12
    neg, pos, loc, *_ = agglomerate._side_measures(m, ls)
    cut = loc == classify.LOC_CUT
    meas = geom.meas.numpy()
    assert (np.minimum(neg, pos)[cut] / meas[cut]).min() > 0.09


def test_side_measures_and_neighbors_match(refs):
    """_side_measures and _face_neighbor_table on the merged 8^2 mesh
    (polygons of 4 and 6 points) equal to JAX's (areas 1e-14)."""
    jm = refs[8][0]
    m = convert.mesh(jm, CPU)
    ls = default_problem().ls
    neg, pos, loc, *_ = agglomerate._side_measures(m, ls)
    jneg, jpos, jloc, *_ = jagglomerate._side_measures(jm, JLS)
    np.testing.assert_allclose(neg, jneg, rtol=0, atol=1e-14)
    np.testing.assert_allclose(pos, jpos, rtol=0, atol=1e-14)
    np.testing.assert_array_equal(loc, jloc)
    np.testing.assert_array_equal(agglomerate._face_neighbor_table(m),
                                  jagglomerate._face_neighbor_table(jm))


def test_union_find_and_boundary_walk():
    """_UnionFind groups, _walk_boundary loops from the smallest id and
    refuses a non-manifold boundary, as the JAX helpers do."""
    uf, juf = agglomerate._UnionFind(6), jagglomerate._UnionFind(6)
    for a, b in ((0, 3), (3, 5), (1, 2)):
        uf.union(a, b)
        juf.union(a, b)
    assert [uf.find(i) for i in range(6)] == [juf.find(i) for i in range(6)]
    assert uf.find(0) == uf.find(5) != uf.find(1) == uf.find(2)
    edges = [(4, 7), (7, 9), (2, 9), (2, 4)]
    assert agglomerate._walk_boundary(edges) == \
        jagglomerate._walk_boundary(edges) == [2, 9, 7, 4]
    with pytest.raises(RuntimeError, match="non-manifold"):
        agglomerate._walk_boundary(edges + [(2, 5)])


def test_fictdom_on_agglomerated_mesh(refs):
    """Plain classification (displacement=False) of the merged 8^2 mesh
    equal to JAX's, and solve_fictdom k=1 on it: iterations within 2, H1
    within 1e-9; on the merged 16^2 mesh the H1 order from 8^2 is above
    1.6 (k+1 = 2)."""
    jm3, jcd, jres = refs["solve"]
    p = default_problem()
    h1 = {}
    for N in (8, 16):
        m, _ = agglomerate.agglomerate(make_poly_mesh(Nx=N, Ny=N, device=CPU),
                                       p.ls)
        m3, cd = classify.cut_preprocess(m, p.ls, 3, displacement=False)
        assert torch.equal(m3.points, m.points)
        res = fictdom.solve_fictdom(m3, cd, p.ls, 1, p.rhs_fun, p.sol_fun,
                                    p.sol_grad)
        assert res.exit_reason == cg.CONVERGED
        h1[N] = res.h1_error
        if N == 8:
            for f in ("cell_loc", "face_loc", "node_loc", "agglo_set"):
                np.testing.assert_array_equal(getattr(cd, f).numpy(),
                                              np.asarray(getattr(jcd, f)))
            assert abs(res.iterations - int(jres.iterations)) <= 2
            assert abs(res.h1_error - float(jres.h1_error)) < \
                1e-9 * float(jres.h1_error)
    assert np.log2(h1[8] / h1[16]) > 1.6


def test_agglomeration_detection_and_neighbors_match():
    """The -A branch of cut_preprocess at 16^2 (agglo sets on the input
    points) and make_neighbors_info equal to JAX's."""
    jm, jcd = jclassify.cut_preprocess(pt.make_poly_mesh(Nx=16, Ny=16), JLS,
                                       levels=4, agglomeration=True)
    mesh = make_poly_mesh(Nx=16, Ny=16, device=CPU)
    _, cd = classify.cut_preprocess(mesh, default_problem().ls, 4,
                                    agglomeration=True)
    np.testing.assert_array_equal(cd.agglo_set.numpy(),
                                  np.asarray(jcd.agglo_set))
    assert set(cd.agglo_set.tolist()) == {classify.AGGLO_UNDEF,
                                          classify.AGGLO_OK,
                                          classify.AGGLO_KO_NEG,
                                          classify.AGGLO_KO_POS}
    nb = classify.make_neighbors_info(mesh)
    np.testing.assert_array_equal(nb.numpy(),
                                  np.asarray(jclassify.make_neighbors_info(jm)))
    assert nb.device == mesh.points.device
    # agglo sets are quad-only, as in the reference
    with pytest.raises(ValueError, match="quads"):
        classify.detect_cell_agglo_set(
            agglomerate.agglomerate(make_poly_mesh(Nx=8, Ny=8, device=CPU),
                                    default_problem().ls)[0],
            default_problem().ls, None, None, None)


def test_output_mesh_info_and_checks_match(refs, tmp_path):
    """output_mesh_info's .npz arrays and .vtk text equal to the JAX
    package's on the same classified mesh; check_classification's counts
    (all zero) and assert_spd's smallest eigenvalue equal too."""
    jm, jcd = jclassify.cut_preprocess(refs[8][0], JLS, levels=3,
                                       agglomeration=False,
                                       displacement=False)
    m, cd = convert.mesh(jm, CPU), convert.cut_data(jcd, CPU)
    vtk.output_mesh_info(m, cd, default_problem().ls, str(tmp_path / "p"))
    jvtk.output_mesh_info(jm, jcd, JLS, str(tmp_path / "j"))
    a, b = np.load(tmp_path / "p.npz"), np.load(tmp_path / "j.npz")
    assert sorted(a.files) == sorted(b.files)
    for f in a.files:
        np.testing.assert_allclose(a[f], b[f], rtol=1e-15, atol=1e-15,
                                   err_msg=f)
    assert (tmp_path / "p.vtk").read_text() == \
        (tmp_path / "j.vtk").read_text()
    counts = debug.check_classification(m, cd)
    assert counts == jdebug.check_classification(jm, jcd)
    assert set(counts.values()) == {0}
    lc = torch.as_tensor(np.random.default_rng(3).standard_normal((5, 4, 4)))
    spd = lc @ lc.transpose(1, 2) + 0.1 * torch.eye(4)
    assert debug.assert_spd(spd) == pytest.approx(
        jdebug.assert_spd(spd.numpy()), rel=1e-12)
    with pytest.raises(AssertionError, match="symmetric"):
        debug.assert_spd(lc)
    with pytest.raises(AssertionError, match="PSD"):
        debug.assert_spd(-spd)


def test_debug_dumps_match(refs, tmp_path, monkeypatch):
    """The .dat writers of io/debug_plots.py (basis values, quadrature
    points, L2 projections) equal to the JAX package's files on the 4^2
    mesh to 1e-13; the plots are written where matplotlib is installed,
    and without it they raise ImportError."""
    import importlib.util
    import sys

    mesh = make_poly_mesh(Nx=4, Ny=4, device=CPU)
    jmesh = pt.make_poly_mesh(Nx=4, Ny=4)
    for name, fn, jfn, args in (
            ("basis", debug_plots.plot_basis_functions,
             jdebug_plots.plot_basis_functions, ()),
            ("quad", debug_plots.plot_quadrature_points,
             jdebug_plots.plot_quadrature_points, (3,)),
            ("mass", debug_plots.test_mass_matrices,
             jdebug_plots.test_mass_matrices, (2,))):
        files = [str(tmp_path / f"{name}_{i}.dat") for i in range(4)]
        fn(mesh, *args, *files[:2])
        jfn(jmesh, *args, *files[2:])
        for mine, theirs in ((files[0], files[2]), (files[1], files[3])):
            a, b = np.loadtxt(mine), np.loadtxt(theirs)
            assert a.shape == b.shape and a.size > 0
            np.testing.assert_allclose(a, b, rtol=1e-13, atol=1e-13)
    ls = default_problem().ls
    m2, cd = classify.cut_preprocess(make_poly_mesh(Nx=8, Ny=8, device=CPU),
                                     ls, 3)
    if importlib.util.find_spec("matplotlib") is not None:
        for path in (
                debug_plots.dump_mesh(m2, cd, str(tmp_path / "m.png")),
                debug_plots.plot_triangulation(m2, cd, classify.LOC_NEG,
                                               str(tmp_path / "t.png")),
                debug_plots.plot_field(m2.points, ls(m2.points),
                                       str(tmp_path / "f.png"))):
            assert (tmp_path / path.split("/")[-1]).stat().st_size > 0
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for call in (lambda: debug_plots.dump_mesh(m2, cd),
                 lambda: debug_plots.plot_triangulation(m2, cd,
                                                        classify.LOC_NEG),
                 lambda: debug_plots.plot_field(m2.points, ls(m2.points))):
        with pytest.raises(ImportError):
            call()


def test_l_shaped_cells_measure_and_dead_faces():
    """From 128^2 on, agglomerate merges three cells into L shapes (8
    points, non-convex). Their area is the shoelace area (3 h^2; the JAX
    package's sum of |fan triangles| from the first point gives 4 h^2 for
    some of them, so its total area exceeds 1), and faces that lie off
    the physical side for both cut cells they touch have zero rows:
    solve_fictdom's Jacobi takes 1 there and keeps those dofs at 0
    instead of NaN."""
    from proton_tpu_torch.core.geometry import cell_points
    from proton_tpu_torch.core.ops import HHODegreeInfo
    from proton_tpu_torch.methods import assembly

    p = default_problem()
    N = 128
    m, _ = agglomerate.agglomerate(make_poly_mesh(Nx=N, Ny=N, device=CPU),
                                   p.ls)
    meas = cell_geometry(m).meas
    assert abs(float(meas.sum()) - 1.0) < 1e-12
    ell = torch.nonzero(m.cell_npts == 8).flatten()
    assert len(ell) > 0
    np.testing.assert_allclose(meas[ell].numpy() * N * N, 3.0, rtol=1e-12)
    rel = (cell_points(m)[ell] - cell_points(m)[ell, :1]).numpy()
    fan = 0.5 * np.abs(rel[:, 1:-1, 0] * rel[:, 2:, 1] -
                       rel[:, 1:-1, 1] * rel[:, 2:, 0]).sum(1)
    assert (fan * N * N > 3.5).any()          # the JAX package's measure

    m3, cd = classify.cut_preprocess(m, p.ls, 4, displacement=False)
    geom = cell_geometry(m3)
    batch = make_cut_batch(m3, geom, cd, fictdom.cut_cell_ids(cd))
    hdi = HHODegreeInfo(2, 1)
    lc, _ = fictdom.assemble_fictdom_local(m3, geom, batch, p.ls, hdi)
    dm = assembly.build_dofmap(m3, hdi)
    dead = assembly.operator_diagonal(dm, lc) == 0
    assert int(dead.sum()) > 0
    res = fictdom.solve_fictdom(m3, cd, p.ls, 1, p.rhs_fun, p.sol_fun,
                                p.sol_grad,
                                cg_params=cg.CGParams(1e-12, 1e8, 20, True))
    assert bool(torch.isfinite(res.x).all())
    assert float(res.x[dead].abs().max()) == 0.0
