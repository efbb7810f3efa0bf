"""The port's condensed face-grid solve against proton_tpu on the CPU,
float64: condensation, the structured operator and block-Jacobi on random
data, CG, and the end-to-end fictdom gates."""

import numpy as np
import jax.numpy as jnp
import pytest
import threadpoolctl
import torch

from proton_tpu.cut import fictdom_structured as jfs
from proton_tpu.methods import cells_last as jcl, structured as jstructured
from proton_tpu.solvers import cg as jcg
from proton_tpu_torch import convert
from proton_tpu_torch.cut import fictdom_structured as fs
from proton_tpu_torch.methods import cells_last, structured
from proton_tpu_torch.solvers import cg

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


def _spd_cells(rng, n, C, shift):
    """[n*n, C] cells-last SPD matrices B B^T + shift I."""
    B = rng.standard_normal((C, n, n))
    A = B @ np.transpose(B, (0, 2, 1)) + shift * np.eye(n)
    return np.transpose(A, (1, 2, 0)).reshape(n * n, C)


def _close(a, ref, tol=1e-12):
    ref = np.asarray(ref)
    assert np.max(np.abs(np.asarray(a) - ref)) <= tol * np.max(np.abs(ref))


@pytest.mark.parametrize("cbs,fbs", [(3, 1), (6, 2), (10, 3)])
def test_condense_and_recover_match(cbs, fbs):
    rng = np.random.default_rng(cbs)
    C, d = 37, cbs + 4 * fbs
    lc = _spd_cells(rng, d, C, float(d))
    f = rng.standard_normal((cbs, C))
    jc = jcl.condense_cl(jnp.asarray(lc), jnp.asarray(f), cbs)
    c = cells_last.condense_cl(torch.as_tensor(lc), torch.as_tensor(f), cbs)
    for a, b in zip(c, jc):
        _close(a.numpy(), b)
    uF = rng.standard_normal((4 * fbs, C))
    _close(cells_last.recover_cells_cl(c, torch.as_tensor(uF)).numpy(),
           jcl.recover_cells_cl(jc, jnp.asarray(uF)))


def _system(Nx, Ny, fbs, seed):
    """Random SPD local Schur matrices on an Nx x Ny face grid, in both
    packages, plus a random grid vector."""
    rng = np.random.default_rng(seed)
    nfd = 4 * fbs
    S = _spd_cells(rng, nfd, Nx * Ny, 1.0)
    jsys = jstructured.make_structured_system(Nx, Ny, fbs)
    sys_ = structured.make_structured_system(Nx, Ny, fbs, device=CPU)
    x = jcl.GridVecCL(jnp.asarray(rng.standard_normal((fbs, Ny + 1, Nx))),
                      jnp.asarray(rng.standard_normal((fbs, Ny, Nx + 1))))
    return jsys, sys_, S, x


@pytest.mark.parametrize("fbs", [1, 2, 3])
def test_structured_operator_and_block_jacobi_match(fbs):
    """Operator apply, diagonal, block-Jacobi, rhs and recovery on random
    face grids (7 x 5 cells), 1e-12."""
    jsys, sys_, S, jx = _system(7, 5, fbs, fbs)
    x = convert.grid_vec_cl(jx, CPU)
    St = torch.as_tensor(S)
    jy = jcl.make_structured_operator_cl(jsys, jnp.asarray(S))(jx)
    y = cells_last.make_structured_operator_cl(sys_, St)(x)
    for a, b in zip(y, jy):
        _close(a.numpy(), b)
    for a, b in zip(cells_last.structured_diagonal_cl(sys_, St),
                    jcl.structured_diagonal_cl(jsys, jnp.asarray(S))):
        _close(a.numpy(), b)
    jz = jcl.block_jacobi_preconditioner_cl(jsys, jnp.asarray(S))(jx)
    z = cells_last.block_jacobi_preconditioner_cl(sys_, St)(x)
    for a, b in zip(z, jz):
        _close(a.numpy(), b)

    rng = np.random.default_rng(10 + fbs)
    cbs, C = 3, 35
    cond = jcl.CondensedCL(jnp.asarray(S),
                           jnp.asarray(rng.standard_normal((4 * fbs, C))),
                           jnp.asarray(rng.standard_normal((cbs * 4 * fbs, C))),
                           jnp.asarray(rng.standard_normal((cbs, C))))
    g = rng.standard_normal((4 * fbs, C))
    tcond = convert.condensed_cl(cond, CPU)
    for a, b in zip(cells_last.structured_rhs_cl(sys_, tcond,
                                                 torch.as_tensor(g)),
                    jcl.structured_rhs_cl(jsys, cond, jnp.asarray(g))):
        _close(a.numpy(), b)
    _close(cells_last.solve_recover_cl(sys_, tcond, x,
                                       torch.as_tensor(g)).numpy(),
           jcl.solve_recover_cl(jsys, cond, jx, jnp.asarray(g)))


@pytest.mark.parametrize("precond", ["block_jacobi", "jacobi", "none"])
def test_cg_matches(precond):
    """Same operator, same rhs: equal exit code and iteration count, x
    within 1e-10; and the max_iter exit."""
    jsys, sys_, S, jb = _system(9, 8, 2, 5)
    b = convert.grid_vec_cl(jb, CPU)
    St = torch.as_tensor(S)
    jA = jcl.make_structured_operator_cl(jsys, jnp.asarray(S))
    A = cells_last.make_structured_operator_cl(sys_, St)
    kw = dict(convergence_threshold=1e-11, divergence_threshold=1e8,
              max_iter=1000, apply_preconditioner=precond == "jacobi")
    jpre = pre = jdiag = diag = None
    if precond == "block_jacobi":
        jpre = jcl.block_jacobi_preconditioner_cl(jsys, jnp.asarray(S))
        pre = cells_last.block_jacobi_preconditioner_cl(sys_, St)
    if precond == "jacobi":
        jdiag = jcl.structured_diagonal_cl(jsys, jnp.asarray(S))
        diag = cells_last.structured_diagonal_cl(sys_, St)
    jr = jcg.conjugated_gradient(jA, jb, jdiag, jcg.CGParams(**kw),
                                 precond=jpre)
    r = cg.conjugated_gradient(A, b, diag, cg.CGParams(**kw), precond=pre)
    assert r.exit_reason == int(jr.exit_reason) == cg.CONVERGED
    assert r.iterations == int(jr.iterations)
    np.testing.assert_allclose(r.rel_residual, float(jr.rel_residual),
                               rtol=1e-6)
    for a, c in zip(r.x, jr.x):
        _close(a.numpy(), c, 1e-10)

    kw.update(max_iter=3)
    jr = jcg.conjugated_gradient(jA, jb, jdiag, jcg.CGParams(**kw),
                                 precond=jpre)
    r = cg.conjugated_gradient(A, b, diag, cg.CGParams(**kw), precond=pre)
    assert r.exit_reason == int(jr.exit_reason) == cg.MAX_ITER_REACHED
    assert r.iterations == int(jr.iterations) == 5


def test_cg_needs_diag_for_jacobi():
    with pytest.raises(ValueError):
        cg.conjugated_gradient(lambda x: x, torch.ones(3), None,
                               cg.CGParams(apply_preconditioner=True))


# JAX package, CPU, float64, solve_fictdom_structured(N, k,
# precond="block_jacobi", fitted="full", mixed=False, use_pallas=False),
# CG tol 1e-10, divergence 1e8, max_iter 50000: (iterations, H1 error).
GATES = {(16, 1): (45, 4.434838975637978e-3),
         (32, 1): (115, 1.1344765273981145e-3),
         (16, 2): (40, 1.8041374232178952e-4)}


def _cgp(tol=1e-10):
    return dict(convergence_threshold=tol, divergence_threshold=1e8,
                max_iter=50000, apply_preconditioner=True)


@pytest.mark.parametrize("N,k", [(16, 1), (16, 2)])
def test_end_to_end_gates(N, k):
    """At CG tol 1e-10: iterations within 2 of the JAX gate and H1 within
    rtol 1e-6. Against the JAX solve, both at tol 1e-12 so the algebraic
    error stays below the comparison: per-cell local dofs within 1e-8
    (see below for the cut cells' cell dofs at k=2), H1 within rtol
    1e-6."""
    r = fs.solve_fictdom_structured(N, k, precond="block_jacobi",
                                    fitted="full",
                                    cg_params=cg.CGParams(**_cgp()),
                                    device="cpu")
    iters, h1 = GATES[(N, k)]
    assert r.exit_reason == cg.CONVERGED and r.rel_residual < 1e-10
    assert abs(r.iterations - iters) <= 2
    assert np.isclose(r.h1_error, h1, rtol=1e-6)
    r = fs.solve_fictdom_structured(N, k, precond="block_jacobi",
                                    fitted="full",
                                    cg_params=cg.CGParams(**_cgp(1e-12)),
                                    device="cpu")
    jr = jfs.solve_fictdom_structured(N, k, precond="block_jacobi",
                                      fitted="full", mixed=False,
                                      use_pallas=False,
                                      cg_params=jcg.CGParams(**_cgp(1e-12)))
    assert r.exit_reason == int(jr.exit_reason) == cg.CONVERGED
    diff = np.abs(r.local.numpy() - np.asarray(jr.local))
    # The cell blocks of sliver cut cells reach cond ~6e7 at k=2 (~7e4 at
    # k=1), so their recovered cell dofs move by ~cond * eps with the
    # rounding of any Cholesky: held to 1e-7 there, 1e-8 everywhere else.
    cut_ids = fs.classify_level(N, fs.default_problem(), 4, device=CPU)[2]
    cbs = (k + 2) * (k + 3) // 2
    assert diff[cut_ids, :cbs].max() < (1e-8 if k < 2 else 1e-7)
    diff[cut_ids, :cbs] = 0.0
    assert diff.max() < 1e-8
    assert np.isclose(r.h1_error, float(jr.h1_error), rtol=1e-6)


def test_jacobi_solve_and_unported_options():
    """The Jacobi-preconditioned solve converges to the same H1 error;
    the option that is not ported raises NotImplementedError (mg_gamma > 1
    without mg_galerkin: W-cycles on the rediscretized hierarchy); the
    Galerkin hierarchy and the cut-aware transfers on the full system
    raise ValueError (the JAX package ignores both there), and the
    cut-aware transfers on the lean system converge to the same H1
    error."""
    r = fs.solve_fictdom_structured(16, 1, precond="jacobi", fitted="full",
                                    cg_params=cg.CGParams(**_cgp()),
                                    device="cpu")
    assert r.exit_reason == cg.CONVERGED
    assert np.isclose(r.h1_error, GATES[(16, 1)][1], rtol=1e-6)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fs.solve_fictdom_structured(8, 1, device="cpu", mg_gamma=2)
    with pytest.raises(ValueError, match="mg_galerkin"):
        fs.solve_fictdom_structured(8, 1, fitted="full", mg_galerkin=True,
                                    device="cpu")
    with pytest.raises(ValueError, match="mg_transfer"):
        fs.solve_fictdom_structured(8, 1, fitted="full", mg_transfer="cut",
                                    device="cpu")
    r = fs.solve_fictdom_structured(16, 1, mg_transfer="cut",
                                    cg_params=cg.CGParams(**_cgp()),
                                    device="cpu")
    assert r.exit_reason == cg.CONVERGED
    assert np.isclose(r.h1_error, GATES[(16, 1)][1], rtol=1e-6)


@pytest.fixture(scope="module")
def uniform_pair():
    """The JAX package's 16^2 k=1 solves with fitted="uniform" (its
    default), precond "mg" and "jacobi", CG tol 1e-10."""
    return {precond: jfs.solve_fictdom_structured(
        16, 1, precond=precond, fitted="uniform", mixed=False,
        use_pallas=False, cg_params=jcg.CGParams(**_cgp()))
        for precond in ("mg", "jacobi")}


@pytest.mark.parametrize("precond", ["mg", "jacobi"])
def test_fitted_uniform_matches_jax(uniform_pair, precond):
    """fitted="uniform" builds the lean system: its solve equals the lean
    one exactly, and the JAX package's fitted="uniform" solve (the unit
    cell broadcast over the mesh) to local dofs 1e-8, H1 rtol 1e-6 and
    iterations within 2. With precond="jacobi" the port's diagonal is the
    whole lean operator's, JAX's that of the broadcast S; fitted="lean"
    refuses Jacobi, as in the JAX package, so there the uniform solve is
    held to the full one."""
    kw = dict(precond=precond, cg_params=cg.CGParams(**_cgp()),
              device="cpu")
    r = fs.solve_fictdom_structured(16, 1, fitted="uniform", **kw)
    if precond == "mg":
        other = fs.solve_fictdom_structured(16, 1, fitted="lean", **kw)
        assert r.iterations == other.iterations
        assert torch.equal(r.local, other.local)
    else:
        other = fs.solve_fictdom_structured(16, 1, fitted="full", **kw)
        assert abs(r.iterations - other.iterations) <= 2
        _close(r.local.numpy(), other.local.numpy(), 1e-8)
    jr = uniform_pair[precond]
    assert r.exit_reason == int(jr.exit_reason) == cg.CONVERGED
    assert abs(r.iterations - int(jr.iterations)) <= 2
    assert np.isclose(r.h1_error, float(jr.h1_error), rtol=1e-6)
    _close(r.local.numpy(), np.asarray(jr.local), 1e-8)


def test_classify_level_full_equals_band():
    """classify_level(method="full"), cut_preprocess on every cell, gives
    the band pipeline's classification at 32^2: the same codes, moved
    points and cut ids, and the same interface points on the cut cells
    (the band pipeline leaves the other cells' rows at zero)."""
    p = fs.default_problem()
    band = fs.classify_level(32, p, 4, device=CPU)
    full = fs.classify_level(32, p, 4, device=CPU, method="full")
    assert torch.equal(band[0].points, full[0].points)
    for name in ("node_loc", "face_loc", "cell_loc", "distorted"):
        assert torch.equal(getattr(band[1], name), getattr(full[1], name))
    assert np.array_equal(band[2], full[2])
    cut = band[2]
    assert torch.equal(band[1].interface[cut], full[1].interface[cut])
    with pytest.raises(ValueError, match="method"):
        fs.classify_level(8, p, 4, device=CPU, method="bands")
