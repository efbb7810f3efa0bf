"""The port's row-major face-grid API (methods/structured.py) against
proton_tpu on the CPU, float64: every function on seeded random data at
8^2 (1e-12), and solve_condensed_structured on the fictdom operators of
the 16^2 mesh (local dofs 1e-10, iterations within 2)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import threadpoolctl
import torch

from proton_tpu.methods import condensation as jcondensation
from proton_tpu.methods import structured as jstructured
from proton_tpu.solvers import cg as jcg
from proton_tpu_torch.core.geometry import cell_geometry
from proton_tpu_torch.core.ops import HHODegreeInfo
from proton_tpu_torch.cut import fictdom_structured as fs
from proton_tpu_torch.cut import methods as cut_methods
from proton_tpu_torch.methods import assembly, condensation, structured
from proton_tpu_torch.solvers import cg

CPU = torch.device("cpu")
N8, FBS = 8, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """BLAS and torch on one thread (one pool per core in every test
    worker oversubscribes the cores)."""
    with threadpoolctl.threadpool_limits(1):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)


def _close(a, ref, tol=1e-12):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    ref = np.asarray(ref)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    assert np.max(np.abs(a - ref)) <= tol * np.max(np.abs(ref))


def _close_grids(x, jx, tol=1e-12):
    for a, b in zip(x, jx):
        _close(a, b, tol)


@pytest.fixture(scope="module")
def data():
    """Random SPD local Schur matrices [C, nfd, nfd] on the 8 x 8 grid and
    a random row-major grid vector, in both packages."""
    rng = np.random.default_rng(8)
    nfd, C = 4 * FBS, N8 * N8
    B = rng.standard_normal((C, nfd, nfd))
    S = B @ np.transpose(B, (0, 2, 1)) + nfd * np.eye(nfd)
    H = rng.standard_normal((N8 + 1, N8, FBS))
    V = rng.standard_normal((N8, N8 + 1, FBS))
    return dict(
        S=S, jsys=jstructured.make_structured_system(N8, N8, FBS),
        sys=structured.make_structured_system(N8, N8, FBS, device=CPU),
        jx=jstructured.GridVec(jnp.asarray(H), jnp.asarray(V)),
        x=structured.GridVec(torch.as_tensor(H), torch.as_tensor(V)))


def test_gather_scatter_mask_match(data):
    jsys, sys_, jx, x = data["jsys"], data["sys"], data["jx"], data["x"]
    _close(structured.grid_gather(sys_, x), jstructured.grid_gather(jsys, jx))
    rng = np.random.default_rng(1)
    for width in (FBS, FBS * FBS):
        c = rng.standard_normal((N8 * N8, 4 * width))
        _close_grids(structured.grid_scatter(sys_, torch.as_tensor(c)),
                     jstructured.grid_scatter(jsys, jnp.asarray(c)))
    _close_grids(structured._mask(sys_, x), jstructured._mask(jsys, jx))


def test_operator_diagonal_and_face_blocks_match(data):
    jsys, sys_, jx, x = data["jsys"], data["sys"], data["jx"], data["x"]
    S, jS = torch.as_tensor(data["S"]), jnp.asarray(data["S"])
    _close_grids(structured.make_structured_operator(sys_, S)(x),
                 jstructured.make_structured_operator(jsys, jS)(jx))
    _close_grids(structured.structured_diagonal(sys_, S),
                 jstructured.structured_diagonal(jsys, jS))
    for a, b in zip(structured.assembled_face_blocks(sys_, S),
                    jstructured.assembled_face_blocks(jsys, jS)):
        _close(a, b)
    _close_grids(structured.block_jacobi_preconditioner(sys_, S)(x),
                 jstructured.block_jacobi_preconditioner(jsys, jS)(jx))


def test_cut_patch_smoother_matches(data):
    """The patch smoother over a set of cells with shared faces and
    Dirichlet slots (a ring around the middle and two boundary cells)."""
    jsys, sys_, jx, x = data["jsys"], data["sys"], data["jx"], data["x"]
    ids = np.array([0, 7, 18, 19, 20, 26, 28, 34, 35, 36, 63])
    S, jS = torch.as_tensor(data["S"]), jnp.asarray(data["S"])
    _close_grids(structured.make_cut_patch_smoother(sys_, S, ids)(x),
                 jstructured.make_cut_patch_smoother(jsys, jS, ids)(jx))


def test_structured_rhs_matches(data):
    """structured_rhs on a condensed random system, with and without the
    Dirichlet fold."""
    rng = np.random.default_rng(3)
    cbs, C = 6, N8 * N8
    d = cbs + 4 * FBS
    B = rng.standard_normal((C, d, d))
    lc = B @ np.transpose(B, (0, 2, 1)) + d * np.eye(d)
    f = rng.standard_normal((C, cbs))
    g = rng.standard_normal((C, d))
    jc = jcondensation.condense(jnp.asarray(lc), jnp.asarray(f), cbs)
    c = condensation.condense(torch.as_tensor(lc), torch.as_tensor(f), cbs)
    for g_loc in (None, g):
        _close_grids(
            structured.structured_rhs(
                data["sys"], c, None if g_loc is None
                else torch.as_tensor(g_loc), cbs),
            jstructured.structured_rhs(
                data["jsys"], jc, None if g_loc is None
                else jnp.asarray(g_loc), cbs))


def _fictdom_operators(N: int, k: int):
    """lc [C, d, d], f [C, cbs] and g_loc [C, d] of the fictdom problem on
    the classified N^2 mesh, built by the port (the fitted operators from
    K1's plain version, the Nitsche cut class spliced in)."""
    hdi = HHODegreeInfo(k + 1, k)
    p = fs.default_problem()
    mesh, cutdata, cut_ids = fs.classify_level(N, p, 4, device=CPU)
    geom = cell_geometry(mesh)
    batch = cut_methods.make_cut_batch(mesh, geom, cutdata, cut_ids)
    eta = fs.nitsche_eta(k)
    lc, f = fs.assemble_level_cl(mesh, geom, cutdata.cell_loc, batch, hdi,
                                  p, eta)
    d = int(round(lc.shape[0] ** 0.5))
    dofmap = assembly.build_dofmap(mesh, hdi)
    fd = assembly.dirichlet_face_data(mesh, hdi, p.sol_fun)
    g_loc = assembly.local_dirichlet_data(dofmap, mesh, fd)
    return (lc.reshape(d, d, -1).permute(2, 0, 1).contiguous(),
            f.T.contiguous(), g_loc)


def test_solve_condensed_structured_matches():
    """Condense + grid Jacobi PCG + recovery on the 16^2 fictdom
    operators, against the JAX function on the same arrays: local dofs
    within 1e-10 of max|local|, iterations within 2, the solution in the
    row-major layout."""
    N, k = 16, 1
    lc, f, g_loc = _fictdom_operators(N, k)
    cbs = (k + 2) * (k + 3) // 2
    params = dict(convergence_threshold=1e-10, divergence_threshold=1e8,
                  max_iter=50000, apply_preconditioner=True)
    sys_ = structured.make_structured_system(N, N, k + 1, device=CPU)
    local, res = structured.solve_condensed_structured(
        sys_, lc, f, cbs, g_loc, cg.CGParams(**params))
    jsys = jstructured.make_structured_system(N, N, k + 1)
    jcgp = jcg.CGParams(**params)

    def jsolve(a, b, c):
        return jstructured.solve_condensed_structured(jsys, a, b, cbs, c,
                                                      jcgp)

    jlocal, jres = jax.jit(jsolve)(*(jnp.asarray(a.numpy())
                                     for a in (lc, f, g_loc)))
    assert res.exit_reason == int(jres.exit_reason) == cg.CONVERGED
    assert abs(res.iterations - int(jres.iterations)) <= 2
    _close(local, jlocal, 1e-10)
    assert isinstance(res.x, structured.GridVec)
    assert tuple(res.x.H.shape) == (N + 1, N, k + 1)
    # the row-major solve is the cells-last one behind two permutes
    local_cl, res_cl = structured.solve_condensed_structured_cl(
        sys_, lc.permute(1, 2, 0).reshape(-1, N * N), f.T, cbs,
        g_loc[:, cbs:].T, cg.CGParams(**params))
    assert res_cl.iterations == res.iterations
    _close(local_cl, local.numpy(), 1e-14)
