"""The port's generic mesh, geometry, ops and HHO operators against
proton_tpu on the CPU, float64: the topology builder and the text-format
loader (exact), the geometry (1e-14), mass matrices, projections and the
local operators (1e-12 relative), on a quad mesh and on a polygonal
"brick" mesh of mixed 4-, 5- and 6-gons. The JAX operators run under
jax.jit, once per module."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import threadpoolctl
import torch

import proton_tpu as pt
from proton_tpu.core import geometry as jgeometry, mesh as jmesh, ops as jops
from proton_tpu.methods import hho as jhho
from proton_tpu_torch import convert
from proton_tpu_torch.core import geometry, mesh, ops
from proton_tpu_torch.methods import fused_assembly, hho
from proton_tpu_torch.tools.brick_mesh import write_brick_mesh

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """BLAS and torch on one thread: with a pool per core in every test
    worker the cores are oversubscribed many times over."""
    with threadpoolctl.threadpool_limits(1):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)
MESH_FIELDS = ("points", "cell_ptids", "cell_npts", "cell_faces",
               "face_ptids", "face_bnd")
HDIS = [(0, 0), (1, 1), (2, 1)]

# two triangles of the unit square (tests/test_mesh.py:test_poly_loader):
# the padding-free Pmax = 3 case
TRIANGLES = """4
0.0 0.0
1.0 0.0
1.0 1.0
0.0 1.0
2
3 1 0 1 2
3 1 0 2 3
4
1 0 1
1 1 2
1 2 3
1 0 3
"""


def _close(a, ref, tol=1e-12):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    ref = np.asarray(ref)
    assert a.shape == ref.shape
    assert np.max(np.abs(a - ref)) <= tol * np.max(np.abs(ref))


def _assert_same_mesh(tm, jm):
    assert tm.kind == jm.kind and tm.all_quads == jm.all_quads
    for f in MESH_FIELDS:
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(jm, f)), err_msg=f)


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """(JAX mesh, port mesh) pairs: the brick mesh (3 x 4 bricks, loaded
    by both packages from one file) and the 4 x 4 quad mesh with its
    interior points jittered."""
    path = tmp_path_factory.mktemp("mesh") / "brick.txt"
    write_brick_mesh(path, 3, 4)
    jb = pt.load_poly_mesh(str(path))
    jq = pt.make_quad_mesh(Nx=4, Ny=4)
    pts = np.asarray(jq.points).copy()
    inner = (pts > 0).all(1) & (pts < 1).all(1)
    pts[inner] += np.random.default_rng(0).uniform(-0.05, 0.05,
                                                   (inner.sum(), 2))
    jq = jq.with_points(jnp.asarray(pts))
    return {"brick": (jb, convert.mesh(jb, CPU)),
            "quad": (jq, convert.mesh(jq, CPU))}


GEOMETRY_FNS = ("cell_barycenters", "cell_measures", "cell_diameters",
                "face_points", "face_barycenters", "face_measures")


def _smooth(lib):
    return lambda p: lib.sin(3 * p[..., 0]) * lib.exp(p[..., 1])


@pytest.fixture(scope="module")
def jax_refs(meshes):
    """The JAX package's geometry, mass matrices, projections, SPD inverse
    and condition number, and hho_laplacian / naive / fancy stabilization
    for every degree pair, on each mesh: one jax.jit call per mesh, as
    numpy. Keys: (mesh, "geometry"), (mesh, "ops"), (mesh, degrees)."""
    def everything(m):
        g = jgeometry.cell_geometry(m)
        out = {"geometry": [getattr(jgeometry, fn)(m)
                            for fn in GEOMETRY_FNS]}
        mass = [jops.cell_mass_matrices(m, g, deg) for deg in (0, 1, 2)]
        out["ops"] = mass + [jops.spd_inverse(mass[2]),
                             jops.condition_number(mass[2])] + [
            jops.project_function(m, g, jops.HHODegreeInfo(*hd),
                                  _smooth(jnp), di=1) for hd in HDIS]
        for hd in HDIS:
            h = jops.HHODegreeInfo(*hd)
            oper, data = jhho.hho_laplacian(m, g, h)
            out[str(hd)] = [oper, data, jhho.naive_stabilization(m, g, h),
                            jhho.fancy_stabilization(m, g, h, oper)]
        return out

    keys = {"geometry": "geometry", "ops": "ops",
            **{str(hd): hd for hd in HDIS}}
    refs = {}
    for name, (jm, _) in meshes.items():
        for key, vals in jax.jit(everything)(jm).items():
            refs[(name, keys[key])] = [np.asarray(a) for a in vals]
    return refs


@pytest.mark.parametrize("nx,ny", [(1, 1), (4, 4), (5, 3), (33, 7)])
def test_build_topology_matches(nx, ny):
    """The NumPy builder on the generator's arrays equals the JAX
    package's builder and the closed-form structured topology."""
    p = jmesh.MeshInitParams(Nx=nx, Ny=ny, min_x=-0.2, max_x=1.3,
                             min_y=0.1, max_y=0.9)
    pts, cp, raw_bnd = jmesh._structured_arrays(p)
    npts = np.full(len(cp), 4, np.int64)
    jm = jmesh._build_topology(pts, cp, npts, raw_bnd, "poly")
    tm = mesh._build_topology(pts, cp, npts, raw_bnd, "poly", device=CPU)
    _assert_same_mesh(tm, jm)
    closed = mesh.make_poly_mesh(mesh.MeshInitParams(
        Nx=nx, Ny=ny, min_x=-0.2, max_x=1.3, min_y=0.1, max_y=0.9),
        device=CPU)
    for f in MESH_FIELDS:
        assert torch.equal(getattr(tm, f), getattr(closed, f)), f


def test_face_dedupe_and_padded_edges():
    """Duplicate faces keep the largest boundary code; padded edges of a
    triangle stored with Pmax = 4 repeat its last edge and face."""
    faces = np.array([[2, 3], [0, 1], [2, 3], [0, 1]])
    uniq, inv, bnd = mesh._dedupe_faces(faces, np.array([0, 1, 1, 0]))
    ref = jmesh._dedupe_faces(faces, np.array([0, 1, 1, 0]))
    for a, b in zip((uniq, inv, bnd), ref):
        np.testing.assert_array_equal(a, np.asarray(b).reshape(a.shape))
    assert bnd.tolist() == [1, 1]
    cp = np.array([[4, 7, 9, 9]])
    for a, b in zip(mesh._cell_edges(cp, np.array([3])),
                    jmesh._cell_edges(cp, np.array([3]))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["brick", "triangles"])
def test_load_poly_mesh_matches(tmp_path, name):
    """The same file through both loaders: equal arrays; the brick mesh
    holds 4-, 5- and 6-gons, its cells sorted by point ids."""
    path = tmp_path / f"{name}.txt"
    if name == "brick":
        write_brick_mesh(path, 3, 4)
    else:
        path.write_text(TRIANGLES)
    tm = mesh.load_poly_mesh(str(path), device="cpu")
    _assert_same_mesh(tm, pt.load_poly_mesh(str(path)))
    if name == "brick":
        assert sorted(set(tm.cell_npts.tolist())) == [4, 5, 6]
        rows = [tuple(r) for r in tm.cell_ptids.tolist()]
        assert rows == sorted(rows)
    assert tm.points.dtype == torch.float64


@pytest.mark.parametrize("name", ["brick", "quad"])
def test_geometry_functions_match(meshes, jax_refs, name):
    _, tm = meshes[name]
    for fn, ref in zip(GEOMETRY_FNS, jax_refs[(name, "geometry")]):
        _close(getattr(geometry, fn)(tm), ref, 1e-14)
    assert np.isclose(float(geometry.cell_measures(tm).sum()), 1.0)


@pytest.mark.parametrize("name", ["brick", "quad"])
def test_ops_match(meshes, jax_refs, name):
    """Cell mass matrices (degrees 0-2), the SPD inverse and condition
    number of the degree-2 ones, and the HHO projection of a smooth
    function for each degree pair, 1e-12."""
    _, tm = meshes[name]
    tg = geometry.cell_geometry(tm)
    mass = [ops.cell_mass_matrices(tm, tg, deg) for deg in (0, 1, 2)]
    out = mass + [ops.spd_inverse(mass[2]), ops.condition_number(mass[2])] + [
        ops.project_function(tm, tg, ops.HHODegreeInfo(*hd), _smooth(torch),
                             di=1) for hd in HDIS]
    for a, ref in zip(out, jax_refs[(name, "ops")]):
        _close(a, ref)


@pytest.mark.parametrize("hd", HDIS, ids=str)
@pytest.mark.parametrize("name", ["brick", "quad"])
def test_hho_operators_match(meshes, jax_refs, name, hd):
    """Reconstruction (oper, data), naive and fancy stabilization, 1e-12
    relative; padded face slots of the brick mesh carry nothing."""
    _, tm = meshes[name]
    hdi = ops.HHODegreeInfo(*hd)
    tg = geometry.cell_geometry(tm)
    oper, data = hho.hho_laplacian(tm, tg, hdi)
    out = (oper, data, hho.naive_stabilization(tm, tg, hdi),
           hho.fancy_stabilization(tm, tg, hdi, oper))
    for a, b in zip(out, jax_refs[(name, hd)]):
        _close(a, b)
    assert data.shape[1] == hho.local_dof_count(tm, hdi)
    if name == "brick":
        cbs = (hd[0] + 1) * (hd[0] + 2) // 2
        dead = torch.cat([torch.zeros((tm.num_cells, cbs), dtype=torch.bool),
                          ~tg.edge_valid.repeat_interleave(hd[1] + 1, 1)], 1)
        assert dead.any()
        for a in out[1:]:
            assert not a[dead].any() and not a.transpose(1, 2)[dead].any()


@pytest.mark.parametrize("cd,fd", [(1, 0), (2, 1), (3, 2)])
def test_naive_path_equals_fused_plain(cd, fd):
    """hho_laplacian's data + naive_stabilization on a jittered quad mesh
    is the function of kernel K1 (fitted_local_operator_plain), 1e-12."""
    tm = mesh.make_poly_mesh(Nx=6, Ny=5, device=CPU)
    pts = tm.points.numpy().copy()
    inner = (pts > 0).all(1) & (pts < 1).all(1)
    pts[inner] += np.random.default_rng(4).uniform(-0.03, 0.03,
                                                   (inner.sum(), 2))
    tm = tm.with_points(torch.as_tensor(pts))
    tg = geometry.cell_geometry(tm)
    hdi = ops.HHODegreeInfo(cd, fd)
    lc = hho.hho_laplacian(tm, tg, hdi)[1] + \
        hho.naive_stabilization(tm, tg, hdi)
    d = lc.shape[1]
    ref = fused_assembly.fitted_local_operator_plain(
        *fused_assembly.pack_inputs(tm, tg), cd, fd)
    _close(lc.permute(1, 2, 0).reshape(d * d, -1), ref)
