"""The port's condensed face-grid solve against proton_tpu on the CPU,
float64: condensation, the structured operator and block-Jacobi on random
data, CG, and the end-to-end fictdom gates.

The JAX package's side of every comparison that costs it more than about
2 s is read from tests/jax_refs/test_torch_solve.npz (REFS below;
tests/torch_jax_reference.py writes it, running the JAX package alone on
the same seeded inputs): its CG runs and operator applies on the random
systems, and its solves, each its _solve_jit over the levels its
solve_fictdom_structured builds."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import threadpoolctl
import torch

from proton_tpu.core.ops import HHODegreeInfo as JHHODegreeInfo
from proton_tpu.cut import fictdom_structured as jfs
from proton_tpu.methods import cells_last as jcl, structured as jstructured
from proton_tpu.solvers import cg as jcg
from proton_tpu_torch import convert
from proton_tpu_torch.cut import fictdom_structured as fs
from proton_tpu_torch.methods import cells_last, structured
from proton_tpu_torch.solvers import cg
from torch_jax_reference import Refs, jax_solve_ref

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
    """Random SPD local Schur matrices on an Nx x Ny face grid, the JAX
    package's structured system, plus a random grid vector (JAX)."""
    rng = np.random.default_rng(seed)
    nfd = 4 * fbs
    S = _spd_cells(rng, nfd, Nx * Ny, 1.0)
    jsys = jstructured.make_structured_system(Nx, Ny, fbs)
    x = jcl.GridVecCL(jnp.asarray(rng.standard_normal((fbs, Ny + 1, Nx))),
                      jnp.asarray(rng.standard_normal((fbs, Ny, Nx + 1))))
    return jsys, S, x


def _jax_structured(fbs):
    """The JAX package's operator apply, diagonal, block-Jacobi, rhs and
    recovery on the random 7 x 5 face grid of fbs."""
    jsys, S, jx = _system(7, 5, fbs, fbs)
    rng = np.random.default_rng(10 + fbs)
    cbs, C = 3, 35
    cond = jcl.CondensedCL(jnp.asarray(S),
                           jnp.asarray(rng.standard_normal((4 * fbs, C))),
                           jnp.asarray(rng.standard_normal((cbs * 4 * fbs, C))),
                           jnp.asarray(rng.standard_normal((cbs, C))))
    g = jnp.asarray(rng.standard_normal((4 * fbs, C)))
    return dict(
        y=jcl.make_structured_operator_cl(jsys, jnp.asarray(S))(jx),
        diag=jcl.structured_diagonal_cl(jsys, jnp.asarray(S)),
        z=jcl.block_jacobi_preconditioner_cl(jsys, jnp.asarray(S))(jx),
        rhs=jcl.structured_rhs_cl(jsys, cond, g),
        recover=jcl.solve_recover_cl(jsys, cond, jx, g))


for _fbs in (1, 2, 3):
    REFS.add(f"structured[{_fbs}]", "operator",
             f"make_structured_operator_cl, structured_diagonal_cl, "
             f"block_jacobi_preconditioner_cl, structured_rhs_cl, "
             f"solve_recover_cl on a random 7 x 5 grid, fbs={_fbs}",
             _jax_structured, seed=[_fbs, 10 + _fbs], fbs=_fbs)


@pytest.mark.parametrize("fbs", [1, 2, 3])
def test_structured_operator_and_block_jacobi_match(fbs):
    """Operator apply, diagonal, block-Jacobi, rhs and recovery on random
    face grids (7 x 5 cells), 1e-12."""
    _, S, jx = _system(7, 5, fbs, fbs)
    sys_ = structured.make_structured_system(7, 5, fbs, device=CPU)
    ref = REFS[f"structured[{fbs}]"]
    x = convert.grid_vec_cl(jx, CPU)
    St = torch.as_tensor(S)
    y = cells_last.make_structured_operator_cl(sys_, St)(x)
    for a, b in zip(y, ref.y):
        _close(a.numpy(), b)
    for a, b in zip(cells_last.structured_diagonal_cl(sys_, St), ref.diag):
        _close(a.numpy(), b)
    z = cells_last.block_jacobi_preconditioner_cl(sys_, St)(x)
    for a, b in zip(z, ref.z):
        _close(a.numpy(), b)

    rng = np.random.default_rng(10 + fbs)
    cbs, C = 3, 35
    tcond = cells_last.CondensedCL(
        St, torch.as_tensor(rng.standard_normal((4 * fbs, C))),
        torch.as_tensor(rng.standard_normal((cbs * 4 * fbs, C))),
        torch.as_tensor(rng.standard_normal((cbs, C))))
    g = rng.standard_normal((4 * fbs, C))
    for a, b in zip(cells_last.structured_rhs_cl(sys_, tcond,
                                                 torch.as_tensor(g)),
                    ref.rhs):
        _close(a.numpy(), b)
    _close(cells_last.solve_recover_cl(sys_, tcond, x,
                                       torch.as_tensor(g)).numpy(),
           ref.recover)


def _cg_kw(precond, max_iter=1000):
    return dict(convergence_threshold=1e-11, divergence_threshold=1e8,
                max_iter=max_iter, apply_preconditioner=precond == "jacobi")


def _jax_cg(precond):
    """The JAX package's CG on the random 9 x 8 system with ``precond``,
    to convergence and stopped at max_iter=3."""
    jsys, S, jb = _system(9, 8, 2, 5)
    jA = jcl.make_structured_operator_cl(jsys, jnp.asarray(S))
    jpre = jdiag = None
    if precond == "block_jacobi":
        jpre = jcl.block_jacobi_preconditioner_cl(jsys, jnp.asarray(S))
    if precond == "jacobi":
        jdiag = jcl.structured_diagonal_cl(jsys, jnp.asarray(S))
    out = {}
    for name, max_iter in (("converged", 1000), ("max_iter", 3)):
        r = jcg.conjugated_gradient(jA, jb, jdiag,
                                    jcg.CGParams(**_cg_kw(precond, max_iter)),
                                    precond=jpre)
        out[name] = dict(x=r.x, iterations=r.iterations,
                         exit_reason=r.exit_reason,
                         rel_residual=r.rel_residual)
    return out


for _p in ("block_jacobi", "jacobi", "none"):
    REFS.add(f"cg[{_p}]", "solve",
             f"conjugated_gradient on the random 9 x 8 system (fbs 2), "
             f"precond {_p}, tol 1e-11, max_iter 1000 and 3", _jax_cg,
             seed=5, precond=_p)


@pytest.mark.parametrize("precond", ["block_jacobi", "jacobi", "none"])
def test_cg_matches(precond):
    """Same operator, same rhs: equal exit code and iteration count, x
    within 1e-10; and the max_iter exit."""
    _, S, jb = _system(9, 8, 2, 5)
    sys_ = structured.make_structured_system(9, 8, 2, device=CPU)
    b = convert.grid_vec_cl(jb, CPU)
    St = torch.as_tensor(S)
    A = cells_last.make_structured_operator_cl(sys_, St)
    kw = _cg_kw(precond)
    pre = diag = None
    if precond == "block_jacobi":
        pre = cells_last.block_jacobi_preconditioner_cl(sys_, St)
    if precond == "jacobi":
        diag = cells_last.structured_diagonal_cl(sys_, St)
    jr = REFS[f"cg[{precond}]"].converged
    r = cg.conjugated_gradient(A, b, diag, cg.CGParams(**kw), precond=pre)
    assert r.exit_reason == int(jr.exit_reason) == cg.CONVERGED
    assert r.iterations == int(jr.iterations)
    np.testing.assert_allclose(r.rel_residual, float(jr.rel_residual),
                               rtol=1e-6)
    for a, c in zip(r.x, jr.x):
        _close(a.numpy(), c, 1e-10)

    kw.update(max_iter=3)
    jr = REFS[f"cg[{precond}]"].max_iter
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


@functools.lru_cache(maxsize=None)
def _jax_level(N, k, fitted):
    """The JAX package's fine level as its solve_fictdom_structured(N, k,
    fitted=..., mixed=False) builds it."""
    return jfs.build_level(N, JHHODegreeInfo(k + 1, k), jfs.default_problem(),
                           jfs.nitsche_eta(k), 4, False, False,
                           with_rhs=True, fitted=fitted)


def _jax_full_solve(N, k):
    return jax_solve_ref({N: _jax_level(N, k, "full")}, k,
                         jcg.CGParams(**_cgp(1e-12)), precond="block_jacobi")


for _N, _k in ((16, 1), (16, 2)):
    REFS.add(f"end_to_end[{_N}-{_k}]", "solve",
             f"solve_fictdom_structured({_N}, {_k}, precond='block_jacobi', "
             f"fitted='full', mixed=False, use_pallas=False), CG tol 1e-12: "
             f"_solve_jit over its build_level", _jax_full_solve, N=_N, k=_k)


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
    jlocal, _, jexit, _, jh1 = REFS[f"end_to_end[{N}-{k}]"]
    assert r.exit_reason == jexit == cg.CONVERGED
    diff = np.abs(r.local.numpy() - np.asarray(jlocal))
    # The cell blocks of sliver cut cells reach cond ~6e7 at k=2 (~7e4 at
    # k=1), so their recovered cell dofs move by ~cond * eps with the
    # rounding of any Cholesky: held to 1e-7 there, 1e-8 everywhere else.
    cut_ids = fs.classify_level(N, fs.default_problem(), 4, device=CPU)[2]
    cbs = (k + 2) * (k + 3) // 2
    assert diff[cut_ids, :cbs].max() < (1e-8 if k < 2 else 1e-7)
    diff[cut_ids, :cbs] = 0.0
    assert diff.max() < 1e-8
    assert np.isclose(r.h1_error, jh1, rtol=1e-6)


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


# mg_coarsest of the fitted="uniform" comparison under precond="mg": the
# fine level alone, its V-cycle the smoothers around the coarsest factor.
# What the test holds, the system fitted="uniform" builds, is the fine
# level's at any depth (the multigrid hierarchy against the JAX package's:
# tests/test_torch_multigrid.py, test_torch_lean.py); a second level costs
# the JAX side a coarse level build and a V-cycle four times the size.
UNIFORM_MG_COARSEST = 16


def _jax_uniform_solve(precond):
    """The JAX package's 16^2 k=1 solve with fitted="uniform" (its
    default) and ``precond``, CG tol 1e-10; under "mg" with
    mg_coarsest=UNIFORM_MG_COARSEST. Both solve the same level."""
    kw = dict(mg_coarsest=UNIFORM_MG_COARSEST) if precond == "mg" else {}
    return jax_solve_ref({16: _jax_level(16, 1, "uniform")}, 1,
                         jcg.CGParams(**_cgp()), precond=precond, **kw)


for _p in ("mg", "jacobi"):
    REFS.add(f"uniform[{_p}]", "solve",
             f"solve_fictdom_structured(16, 1, fitted='uniform', "
             f"precond={_p!r}" + (", mg_coarsest=16" if _p == "mg" else "")
             + ", mixed=False, use_pallas=False), CG tol 1e-10",
             _jax_uniform_solve, precond=_p)


@pytest.mark.parametrize("precond", ["mg", "jacobi"])
def test_fitted_uniform_matches_jax(precond):
    """fitted="uniform" builds the lean system: its solve equals the lean
    one exactly, and the JAX package's fitted="uniform" solve (the unit
    cell broadcast over the mesh) to local dofs 1e-8, H1 rtol 1e-6 and
    iterations within 2. With precond="jacobi" the port's diagonal is the
    whole lean operator's, JAX's that of the broadcast S; fitted="lean"
    refuses Jacobi, as in the JAX package, so there the uniform solve is
    held to the full one. Under precond="mg" both packages run
    mg_coarsest=UNIFORM_MG_COARSEST."""
    kw = dict(precond=precond, cg_params=cg.CGParams(**_cgp()),
              device="cpu")
    if precond == "mg":
        kw.update(mg_coarsest=UNIFORM_MG_COARSEST)
    r = fs.solve_fictdom_structured(16, 1, fitted="uniform", **kw)
    if precond == "mg":
        other = fs.solve_fictdom_structured(16, 1, fitted="lean", **kw)
        assert r.iterations == other.iterations
        assert torch.equal(r.local, other.local)
    else:
        other = fs.solve_fictdom_structured(16, 1, fitted="full", **kw)
        assert abs(r.iterations - other.iterations) <= 2
        _close(r.local.numpy(), other.local.numpy(), 1e-8)
    jlocal, jiters, jexit, _, jh1 = REFS[f"uniform[{precond}]"]
    assert r.exit_reason == jexit == cg.CONVERGED
    assert abs(r.iterations - jiters) <= 2
    assert np.isclose(r.h1_error, jh1, rtol=1e-6)
    _close(r.local.numpy(), np.asarray(jlocal), 1e-8)


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
