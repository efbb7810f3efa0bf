"""proton_tpu_torch.cut against proton_tpu.cut on the CPU, float64: band
classification, the cut-cell operators and loads, the side measure."""

import numpy as np
import pytest
import threadpoolctl
import torch

from proton_tpu.core.geometry import cell_geometry as jcell_geometry
from proton_tpu.core.ops import HHODegreeInfo as JHDI
from proton_tpu.cut import fictdom_structured as jfs, methods as jmethods
from proton_tpu_torch import convert
from proton_tpu_torch.core.ops import HHODegreeInfo
from proton_tpu_torch.cut import fictdom_structured as fs, methods
from proton_tpu_torch.cut.classify import LOC_NEG, LOC_POS
from proton_tpu_torch.cut.quadrature import side_measure

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


@pytest.mark.parametrize("N", [16, 32])
def test_classification_matches(N):
    """cell_loc, cut ids, distorted cells, face codes: equal to JAX;
    displaced points and the interface polylines within 1e-13."""
    jmesh, jcut, jids = jfs.classify_level(N, jfs.default_problem(), 4)
    mesh, cut, ids = fs.classify_level(N, fs.default_problem(), 4, device=CPU)
    np.testing.assert_array_equal(ids, jids)
    for f in ("cell_loc", "distorted", "face_loc", "node_loc",
              "face_node_inside", "agglo_set"):
        a, b = getattr(cut, f).numpy(), np.asarray(getattr(jcut, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert cut.distorted.any()
    np.testing.assert_allclose(mesh.points.numpy(), np.asarray(jmesh.points),
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(cut.interface[ids].numpy(),
                               np.asarray(jcut.interface)[ids], atol=1e-13)


@pytest.fixture(scope="module")
def batches16():
    """The JAX cut batch at N=16 and its conversion (identical inputs)."""
    jmesh, jcut, jids = jfs.classify_level(16, jfs.default_problem(), 4)
    jbatch = jmethods.make_cut_batch(jmesh, jcell_geometry(jmesh), jcut, jids)
    return jbatch, convert.cut_cell_batch(jbatch, CPU)


def _rel(a, ref):
    ref = np.asarray(ref)
    return float(np.max(np.abs(a.numpy() - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("k", [0, 1, 2])
def test_cut_operators_match(k, batches16):
    """cut_hho_laplacian, cut_stabilization and cut_rhs from identical cut
    batches at N=16: the operators that enter the solve within 1e-10
    relative. The reconstruction ``oper`` is an intermediate solve with
    the Nitsche stiffness, whose condition number on sliver cuts reaches
    ~1e7 at k=2, so it is held to cond * eps ~ 1e-8."""
    jbatch, batch = batches16
    jp, p = jfs.default_problem(), fs.default_problem()
    eta = fs.nitsche_eta(k)
    assert eta == jfs.nitsche_eta(k)
    joper, jdata = jmethods.cut_hho_laplacian(jbatch, jp.ls, JHDI(k + 1, k),
                                              LOC_NEG, eta=eta)
    oper, data = methods.cut_hho_laplacian(batch, p.ls, HHODegreeInfo(k + 1, k),
                                           LOC_NEG, eta=eta)
    assert _rel(data, jdata) < 1e-10
    assert _rel(oper, joper) < (1e-10 if k < 2 else 1e-8)
    jstab = jmethods.cut_stabilization(jbatch, JHDI(k + 1, k), LOC_NEG)
    stab = methods.cut_stabilization(batch, HHODegreeInfo(k + 1, k), LOC_NEG)
    assert _rel(stab, jstab) < 1e-10
    jrhs = jmethods.cut_rhs(jbatch, k + 1, jp.rhs_fun, jp.ls, jp.sol_fun,
                            LOC_NEG, eta=eta)
    rhs = methods.cut_rhs(batch, k + 1, p.rhs_fun, p.ls, p.sol_fun, LOC_NEG,
                          eta=eta)
    assert _rel(rhs, jrhs) < 1e-10


def test_port_batch_matches_jax_batch(batches16):
    """The port's own classification gives the same cut batch."""
    jbatch, _ = batches16
    problem = fs.default_problem()
    *_, batch, _ = fs.classify_cells(16, problem, 4, device=CPU)
    np.testing.assert_array_equal(batch.ids.numpy(), np.asarray(jbatch.ids))
    np.testing.assert_array_equal(batch.node_loc.numpy(),
                                  np.asarray(jbatch.node_loc))
    np.testing.assert_allclose(batch.interface.numpy(),
                               np.asarray(jbatch.interface), atol=1e-13)


def test_levelset_autodiff_gradient():
    """Without an analytic gradient, torch.func gives the same normal."""
    ls = fs.default_problem().ls
    auto = type(ls)(ls.fn)
    pts = torch.as_tensor(np.random.default_rng(0).uniform(0, 1, (4, 3, 2)))
    torch.testing.assert_close(auto.normal(pts), ls.normal(pts), rtol=1e-14,
                               atol=1e-14)


@pytest.mark.parametrize("N", [16, 32])
def test_negative_side_area(N):
    """Uncut NEG cells + NEG side of cut cells ~ pi r^2, O(h^2)."""
    mesh, cut, ids = fs.classify_level(N, fs.default_problem(), 4, device=CPU)
    from proton_tpu_torch.core.geometry import cell_geometry
    geom = cell_geometry(mesh)
    batch = methods.make_cut_batch(mesh, geom, cut, ids)
    area = float(geom.meas[cut.cell_loc == LOC_NEG].sum() +
                 side_measure(methods.side_polygon(batch, LOC_NEG)).sum())
    pos = float(geom.meas[cut.cell_loc == LOC_POS].sum() +
                side_measure(methods.side_polygon(batch, LOC_POS)).sum())
    assert abs(area - np.pi * 0.35 ** 2) < 0.5 / N ** 2
    assert abs(area + pos - 1.0) < 1e-12
