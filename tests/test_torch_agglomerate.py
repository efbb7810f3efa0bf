"""proton_tpu_torch's cell agglomeration and the cut-mesh diagnostics
against proton_tpu on the CPU, float64: the side measures, the face
neighbour table, the merge itself at 8^2 and 16^2 (every mesh array
equal), plain classification and the fictdom solve on the merged mesh,
the agglomeration-detection branch with make_neighbors_info,
output_mesh_info, the invariant checks of utils/debug.py and the debug
dumps. The JAX package's side (its merge per size, with its device
stages under jax.jit, and what it computes on the merged mesh) is read
from tests/jax_refs/test_torch_agglomerate.npz (REFS below;
tests/torch_jax_reference.py writes it, running the JAX package alone)."""

import contextlib
import dataclasses
import functools
import tempfile

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
from torch_jax_reference import Refs

CPU = torch.device("cpu")
PI = np.pi
JLS = jlevelset.circle_level_set(0.35, 0.5, 0.5)
MESH_FIELDS = ("cell_ptids", "cell_npts", "cell_faces", "face_ptids",
               "face_bnd")
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


def _jax_problem():
    def sol(p):
        return jnp.sin(PI * p[..., 0]) * jnp.sin(PI * p[..., 1])

    def grad(p):
        return jnp.stack([PI * jnp.cos(PI * p[..., 0]) * jnp.sin(PI * p[..., 1]),
                          PI * jnp.sin(PI * p[..., 0]) * jnp.cos(PI * p[..., 1])],
                         -1)

    return (lambda p: 2.0 * PI ** 2 * sol(p)), sol, grad


@contextlib.contextmanager
def _jitted_stages():
    """The device stages of the JAX package's merge and of its solve, and
    the bases, rules and mass matrices of its debug dumps, under
    jax.jit."""
    from proton_tpu.core import bases as jbases, ops as jops, \
        quadrature as jcore_quadrature

    jit = jax.jit
    with pytest.MonkeyPatch.context() as mp:
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
            mp.setattr(mod, name, jit(getattr(mod, name),
                                      static_argnums=static))
        yield


@functools.lru_cache(maxsize=None)
def _jax_merge(N):
    """The JAX package's agglomerate on the N^2 mesh: (mesh, merges)."""
    with _jitted_stages():
        return jagglomerate.agglomerate(pt.make_poly_mesh(Nx=N, Ny=N), JLS)


def _mesh_fields(jm):
    return dict({f.name: getattr(jm, f.name)
                 for f in dataclasses.fields(jm)}, max_pts=jm.max_pts)


for _N in (8, 16):
    REFS.add(f"merge[{_N}]", "mesh",
             f"agglomerate(make_poly_mesh({_N}, {_N}), circle 0.35) with its "
             f"device stages under jax.jit",
             lambda N: (_mesh_fields(_jax_merge(N)[0]), _jax_merge(N)[1]),
             N=_N)


def _jax_merged_solve():
    """Plain classification of the merged 8^2 mesh and solve_fictdom k=1
    on it."""
    with _jitted_stages():
        m3, cd = jclassify.cut_preprocess(_jax_merge(8)[0], JLS, levels=3,
                                          displacement=False)
        res = jfictdom.solve_fictdom(m3, cd, JLS, 1, *_jax_problem())
    return dict(cd={f: getattr(cd, f) for f in ("cell_loc", "face_loc",
                                                "node_loc", "agglo_set")},
                iterations=res.iterations, h1_error=res.h1_error)


REFS.add("merged_solve", "solve",
         "cut_preprocess(merge[8], ls, levels=3, displacement=False); "
         "solve_fictdom(mesh, cd, ls, 1, rhs, sol, grad)", _jax_merged_solve)


@pytest.fixture(scope="module")
def refs():
    """N -> (JAX agglomerated mesh, merges) for N = 8, 16, and the JAX
    package's plain classification and fictdom solve (k=1) on the 8^2
    merged mesh, as stored."""
    out = {N: tuple(REFS[f"merge[{N}]"]) for N in (8, 16)}
    out["solve"] = REFS["merged_solve"]
    return out


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


def _jax_side_measures():
    jm = _jax_merge(8)[0]
    with _jitted_stages():
        jneg, jpos, jloc, *_ = jagglomerate._side_measures(jm, JLS)
    return dict(neg=jneg, pos=jpos, loc=jloc,
                neighbors=jagglomerate._face_neighbor_table(jm))


REFS.add("side_measures", "mesh",
         "_side_measures(merge[8], ls) and _face_neighbor_table(merge[8])",
         _jax_side_measures)


def test_side_measures_and_neighbors_match(refs):
    """_side_measures and _face_neighbor_table on the merged 8^2 mesh
    (polygons of 4 and 6 points) equal to JAX's (areas 1e-14)."""
    jm = refs[8][0]
    m = convert.mesh(jm, CPU)
    ls = default_problem().ls
    neg, pos, loc, *_ = agglomerate._side_measures(m, ls)
    ref = REFS["side_measures"]
    jneg, jpos, jloc = ref.neg, ref.pos, ref.loc
    np.testing.assert_allclose(neg, jneg, rtol=0, atol=1e-14)
    np.testing.assert_allclose(pos, jpos, rtol=0, atol=1e-14)
    np.testing.assert_array_equal(loc, jloc)
    np.testing.assert_array_equal(agglomerate._face_neighbor_table(m),
                                  ref.neighbors)


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
    jres = refs["solve"]
    jcd = jres.cd
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


def _jax_agglomeration_detection():
    jm, jcd = jclassify.cut_preprocess(pt.make_poly_mesh(Nx=16, Ny=16), JLS,
                                       levels=4, agglomeration=True)
    return dict(agglo_set=jcd.agglo_set,
                neighbors=jclassify.make_neighbors_info(jm))


REFS.add("agglomeration_detection", "classification",
         "cut_preprocess(make_poly_mesh(16, 16), circle 0.35, levels=4, "
         "agglomeration=True); make_neighbors_info(mesh)",
         _jax_agglomeration_detection)


def test_agglomeration_detection_and_neighbors_match():
    """The -A branch of cut_preprocess at 16^2 (agglo sets on the input
    points) and make_neighbors_info equal to JAX's."""
    ref = REFS["agglomeration_detection"]
    mesh = make_poly_mesh(Nx=16, Ny=16, device=CPU)
    _, cd = classify.cut_preprocess(mesh, default_problem().ls, 4,
                                    agglomeration=True)
    np.testing.assert_array_equal(cd.agglo_set.numpy(),
                                  np.asarray(ref.agglo_set))
    assert set(cd.agglo_set.tolist()) == {classify.AGGLO_UNDEF,
                                          classify.AGGLO_OK,
                                          classify.AGGLO_KO_NEG,
                                          classify.AGGLO_KO_POS}
    nb = classify.make_neighbors_info(mesh)
    np.testing.assert_array_equal(nb.numpy(), np.asarray(ref.neighbors))
    assert nb.device == mesh.points.device
    # agglo sets are quad-only, as in the reference
    with pytest.raises(ValueError, match="quads"):
        classify.detect_cell_agglo_set(
            agglomerate.agglomerate(make_poly_mesh(Nx=8, Ny=8, device=CPU),
                                    default_problem().ls)[0],
            default_problem().ls, None, None, None)


SPD_SEED = 3


def _spd_input():
    """A random batch of 4 x 4 matrices and the SPD batch made of it."""
    lc = torch.as_tensor(np.random.default_rng(SPD_SEED).standard_normal(
        (5, 4, 4)))
    return lc, lc @ lc.transpose(1, 2) + 0.1 * torch.eye(4)


def _jax_mesh_info():
    """Plain classification of the merged 8^2 mesh (levels 3), its
    output_mesh_info files (the .npz arrays, the .vtk text), its
    check_classification counts, and assert_spd of a random SPD batch."""
    with _jitted_stages():
        jm, jcd = jclassify.cut_preprocess(_jax_merge(8)[0], JLS, levels=3,
                                           agglomeration=False,
                                           displacement=False)
    with tempfile.TemporaryDirectory() as tmp:
        jvtk.output_mesh_info(jm, jcd, JLS, f"{tmp}/j")
        with np.load(f"{tmp}/j.npz") as z:
            npz = {f: z[f] for f in z.files}
        with open(f"{tmp}/j.vtk") as f:
            vtk_text = f.read()
    return dict(mesh=_mesh_fields(jm), cd=jcd, npz=npz, vtk=vtk_text,
                counts=jdebug.check_classification(jm, jcd),
                min_eig=jdebug.assert_spd(_spd_input()[1].numpy()))


REFS.add("mesh_info", "io",
         "cut_preprocess(merge[8], ls, levels=3, displacement=False); "
         "io.vtk.output_mesh_info; utils.debug.check_classification; "
         "utils.debug.assert_spd(random SPD)", _jax_mesh_info, seed=SPD_SEED)


def test_output_mesh_info_and_checks_match(refs, tmp_path):
    """output_mesh_info's .npz arrays and .vtk text equal to the JAX
    package's on the same classified mesh; check_classification's counts
    (all zero) and assert_spd's smallest eigenvalue equal too."""
    ref = REFS["mesh_info"]
    m, cd = convert.mesh(ref.mesh, CPU), convert.cut_data(ref.cd, CPU)
    vtk.output_mesh_info(m, cd, default_problem().ls, str(tmp_path / "p"))
    a, b = np.load(tmp_path / "p.npz"), ref.npz
    assert sorted(a.files) == sorted(b._fields)
    for f in a.files:
        np.testing.assert_allclose(a[f], b[f], rtol=1e-15, atol=1e-15,
                                   err_msg=f)
    assert (tmp_path / "p.vtk").read_text() == ref.vtk
    counts = debug.check_classification(m, cd)
    assert counts == dict(ref.counts.items())
    assert set(counts.values()) == {0}
    lc, spd = _spd_input()
    assert debug.assert_spd(spd) == pytest.approx(ref.min_eig, rel=1e-12)
    with pytest.raises(AssertionError, match="symmetric"):
        debug.assert_spd(lc)
    with pytest.raises(AssertionError, match="PSD"):
        debug.assert_spd(-spd)


DUMPS = (("basis", "plot_basis_functions", ()),
         ("quad", "plot_quadrature_points", (3,)),
         ("mass", "test_mass_matrices", (2,)))


def _jax_debug_dumps():
    """The two .dat files of each of the JAX package's debug_plots writers
    on the 4^2 mesh, as loaded by np.loadtxt."""
    jmesh = pt.make_poly_mesh(Nx=4, Ny=4)
    out = {}
    with tempfile.TemporaryDirectory() as tmp, _jitted_stages():
        for name, fn, args in DUMPS:
            files = [f"{tmp}/{name}_{i}.dat" for i in range(2)]
            getattr(jdebug_plots, fn)(jmesh, *args, *files)
            out[name] = [np.loadtxt(f) for f in files]
    return out


REFS.add("debug_dumps", "io",
         "io.debug_plots.plot_basis_functions, plot_quadrature_points(3), "
         "test_mass_matrices(2) on make_poly_mesh(4, 4), their .dat files",
         _jax_debug_dumps)


def test_debug_dumps_match(refs, tmp_path, monkeypatch):
    """The .dat writers of io/debug_plots.py (basis values, quadrature
    points, L2 projections) equal to the JAX package's files on the 4^2
    mesh to 1e-13; the plots are written where matplotlib is installed,
    and without it they raise ImportError."""
    import importlib.util
    import sys

    mesh = make_poly_mesh(Nx=4, Ny=4, device=CPU)
    dumps = REFS["debug_dumps"]
    for name, fn, args in DUMPS:
        files = [str(tmp_path / f"{name}_{i}.dat") for i in range(2)]
        getattr(debug_plots, fn)(mesh, *args, *files)
        for mine, b in zip(files, dumps[name]):
            a = np.loadtxt(mine)
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
