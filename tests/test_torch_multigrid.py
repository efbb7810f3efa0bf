"""The port's multigrid V-cycle against proton_tpu on the CPU, float64:
the Chebyshev smoother and its eigenvalue estimate, the damped smoothers,
and one V-cycle apply over the JAX package's own 16^2 and 8^2 levels, in
the lean and in the full form, and the solves with the damped smoothers.
The transfer matrices, prolongation and restriction and the coarsest
factor are in tests/test_torch_multigrid_transfers.py.

The JAX package's transfer-matrix builders are pure functions of (hdi, h)
that its multigrid setup calls again for every hierarchy; this module
hands it the port's (tests/torch_jax_reference.py), which
test_torch_multigrid_transfers.py holds to the JAX package's own to
1e-12. Each JAX V-cycle is built and applied under one jax.jit, and the
JAX solves run its _solve_jit over levels built once. The BLAS and torch
thread pools run single-threaded."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import threadpoolctl
import torch

from proton_tpu.core.ops import HHODegreeInfo as JHHODegreeInfo
from proton_tpu.cut import fictdom_structured as jfs
from proton_tpu.methods import cells_last as jcl, structured as jstructured
from proton_tpu.solvers import cg as jcg, multigrid as jmg
from proton_tpu_torch import convert
from proton_tpu_torch.core.ops import HHODegreeInfo
from proton_tpu_torch.cut import fictdom_structured as fs
from proton_tpu_torch.methods import cells_last, structured
from proton_tpu_torch.solvers import cg, multigrid
from torch_jax_reference import jax_solve, jax_transfer_builders

CPU = torch.device("cpu")
F64 = torch.float64


def _close(a, ref, tol=1e-12):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    ref = np.asarray(ref)
    assert a.shape == ref.shape
    assert np.max(np.abs(a - ref)) <= tol * np.max(np.abs(ref))


def _grid(rng, fbs, n):
    return jcl.GridVecCL(jnp.asarray(rng.standard_normal((fbs, n + 1, n))),
                         jnp.asarray(rng.standard_normal((fbs, n, n + 1))))


def _dot(a, b):
    return float(torch.sum(a.H * b.H) + torch.sum(a.V * b.V))


@pytest.fixture(autouse=True, scope="module")
def _port_transfers_one_thread():
    """Hand the JAX package the port's _transfer_face_projectors,
    _unit_recmap and _transfer_slot_matrices for this module
    (build_multigrid looks them up as module globals), and keep BLAS and
    torch on one thread: with a pool per core in every test worker, a
    dense eigh of a few hundred rows takes seconds instead of
    milliseconds."""
    with pytest.MonkeyPatch.context() as mp, \
            threadpoolctl.threadpool_limits(1):
        jax_transfer_builders(mp)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_levels():
    """The JAX package's own levels at 16^2 and 8^2, k=1, in the lean and
    the full form, as its solve_fictdom_structured builds them: the full
    16^2 one with its right-hand side (the V-cycle reads none; the full
    solve of test_damped_smoother_solves_match_jax does)."""
    hdi, problem = JHHODegreeInfo(2, 1), jfs.default_problem()
    eta = jfs.nitsche_eta(1)
    return {(fitted, n): jfs.build_level(
        n, hdi, problem, eta, 4, False, False,
        with_rhs=(fitted, n) == ("full", 16), fitted=fitted)
        for fitted in ("lean", "full") for n in (16, 8)}


def _mg_pair(jax_levels, fitted, smoother="chebyshev"):
    """(JAX V-cycle, port Multigrid) over the 16^2 and 8^2 levels, with
    solve_fictdom_structured's defaults (one sweep of ``smoother``, the
    patch smoother on the cut cells grown by one ring). The JAX side is
    one jitted function of a residual r: its build_multigrid, then (each
    smoother step of the fine level applied to r, the V-cycle applied to
    r); it records the hierarchy's number of levels and of fine smoother
    steps in its ``shape`` attribute."""
    jhdi, hdi = JHHODegreeInfo(2, 1), HHODegreeInfo(2, 1)
    levs = {n: jax_levels[(fitted, n)] for n in (16, 8)}
    lean = fitted == "lean"
    S = {n: (lev.cond.dS if lean else lev.cond.S) for n, lev in levs.items()}
    cuts = {n: jfs.expand_ring(lev.cut_ids, n, 1) for n, lev in levs.items()}
    uni = {n: (lev.S_u, lev.irr_ids) for n, lev in levs.items()} \
        if lean else None

    def jax_apply(S, r):
        jm = jmg.build_multigrid(16, 2, S, hdi=jhdi, coarsest=8, n_smooth=1,
                                 cut_ids_per_level=cuts, smoother=smoother,
                                 layout="cl", uniform_per_level=uni)
        apply.shape = (len(jm.levels), len(jm.levels[0].smoothers))
        return [step(r) for step in jm.levels[0].smoothers], \
            jm.precondition(r)

    jitted = jax.jit(jax_apply)

    def apply(r):
        return jitted(S, r)

    m = multigrid.build_multigrid(
        16, 2, hdi=hdi, coarsest=8, n_smooth=1, smoother=smoother,
        **convert.mg_levels(
            {n: (np.asarray(S[n]), levs[n].S_u, levs[n].irr_ids, cuts[n])
             for n in levs}, CPU))
    return apply, m


@pytest.mark.parametrize("fitted", ["lean", "full"])
def test_vcycle_matches_and_is_symmetric(jax_levels, fitted):
    """One V-cycle apply against the JAX package's
    build_multigrid(...).precondition on the same random residual, 1e-10
    relative, in the lean form and over full S levels; its symmetry
    <M r, s> = <r, M s> to 1e-10; and, on the way, the Chebyshev smoother
    of the fine level, 1e-11."""
    jm, m = _mg_pair(jax_levels, fitted)
    rng = np.random.default_rng(7)
    jr, js = _grid(rng, 2, 16), _grid(rng, 2, 16)
    r, s = convert.grid_vec_cl(jr, CPU), convert.grid_vec_cl(js, CPU)
    jsteps, jMr = jm(jr)
    assert (len(m.levels), len(m.levels[0].smoothers)) == jm.shape == (2, 2)
    for step, jz in zip(m.levels[0].smoothers, jsteps):
        for a, b in zip(step(r), jz):
            _close(a, b, 1e-11)
    Mr, Ms = m.precondition(r), m.precondition(s)
    for a, b in zip(Mr, jMr):
        _close(a, b, 1e-10)
    lhs, rhs = _dot(Mr, s), _dot(r, Ms)
    assert abs(lhs - rhs) <= 1e-10 * abs(lhs)


def test_lambda_max_and_chebyshev_match(jax_levels):
    """estimate_lambda_max (rtol 1e-10) and the Chebyshev smoother (1e-11)
    on the lean 16^2 operator with its corrected block-Jacobi."""
    lev = jax_levels[("lean", 16)]
    jsys = jstructured.make_structured_system(16, 16, 2)
    sys_ = structured.make_structured_system(16, 16, 2, device=CPU)
    jA = jcl.make_uniform_operator_cl(jsys, lev.S_u, lev.irr_ids,
                                      lev.cond.dS)
    hf, vf = jcl.uniform_face_block_deltas(jsys, lev.cond.dS, lev.irr_ids)
    jbase = jcl.make_uniform_block_jacobi_cl(
        jsys, *jcl.uniform_block_jacobi_blocks(jsys, lev.S_u),
        *jcl.uniform_bj_from_deltas(jsys, lev.S_u, hf, vf, jnp.float64))
    dS = convert.tensor(lev.cond.dS, CPU)
    A = cells_last.make_uniform_operator_cl(sys_, lev.S_u, lev.irr_ids, dS)
    hf, vf = cells_last.uniform_face_block_deltas(sys_, dS, lev.irr_ids)
    base = cells_last.make_uniform_block_jacobi_cl(
        sys_, *cells_last.uniform_block_jacobi_blocks(sys_, lev.S_u),
        *cells_last.uniform_bj_from_deltas(sys_, lev.S_u, hf, vf, F64))

    rng = np.random.default_rng(11)
    jx = _grid(rng, 2, 16)
    x = convert.grid_vec_cl(jx, CPU)
    jlam = float(jmg.estimate_lambda_max(jA, jbase, jx))
    lam = multigrid.estimate_lambda_max(A, base, x)
    assert isinstance(lam, float)
    np.testing.assert_allclose(lam, jlam, rtol=1e-10)
    for degree in (1, 4):
        jz = jmg.make_chebyshev_smoother(jA, jbase, jlam, degree=degree)(jx)
        z = multigrid.make_chebyshev_smoother(A, base, jlam,
                                              degree=degree)(x)
        for a, b in zip(z, jz):
            _close(a, b, 1e-11)
    # a lean level takes the deviation at its irregular columns, nothing
    # else: a wrong column count is refused, not guessed at
    with pytest.raises(ValueError, match="irregular"):
        multigrid.build_multigrid(
            16, 2, {16: dS[:, :-1]}, HHODegreeInfo(2, 1), coarsest=16,
            uniform_per_level={16: (convert.tensor(lev.S_u, CPU),
                                    np.asarray(lev.irr_ids))})


def test_unported_multigrid_options_raise():
    """The multigrid options of the JAX solve are ported: cheb_ops,
    mg_transfer and mg_deflate are keywords of the solve (each converges
    at 8^2 with a coarse level at 4^2), and an unknown value of each
    raises ValueError. W-cycles on the rediscretized hierarchy (mg_gamma
    > 1 without mg_galerkin) are not ported and raise
    NotImplementedError naming ROADMAP.md; an unknown keyword is a
    TypeError."""
    for kw in (dict(cheb_ops="mixed"), dict(cheb_ops="uniform"),
               dict(mg_transfer="cut"), dict(mg_transfer="smoothed"),
               dict(mg_deflate=4)):
        r = fs.solve_fictdom_structured(8, 1, device="cpu", mg_coarsest=4,
                                        compute_h1=False, **kw)
        assert r.exit_reason == 0, kw
    for kw in (dict(cheb_ops="fast"), dict(mg_transfer="injection"),
               dict(mg_deflate=-2)):
        with pytest.raises(ValueError):
            fs.solve_fictdom_structured(8, 1, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fs.solve_fictdom_structured(8, 1, device="cpu", mg_gamma=2)
    with pytest.raises(TypeError, match="mg_smother"):
        fs.solve_fictdom_structured(8, 1, device="cpu", mg_smother="x")
    r = fs.solve_fictdom_structured(8, 1, device="cpu", mixed=False,
                                    mg_smoother="chebyshev", cheb_ops="exact",
                                    mg_transfer="uniform", mg_deflate=0,
                                    mg_gamma=1, compute_h1=False)
    assert r.exit_reason == 0


@pytest.mark.parametrize("smoother", ["block_jacobi", "jacobi"])
def test_damped_smoother_vcycle_matches(jax_levels, smoother):
    """The V-cycle with the damped block-Jacobi or Jacobi smoother
    (omega 0.67) against the JAX package's on the same full levels,
    1e-10, and its symmetry to 1e-10. On lean levels: block-Jacobi in
    test_damped_smoother_solves_match_jax (an eager JAX V-cycle build over
    lean levels costs ~20 s here), Jacobi in
    test_lean_jacobi_smoother_repairs_jax."""
    jm, m = _mg_pair(jax_levels, "full", smoother)
    rng = np.random.default_rng(13)
    jr, js = _grid(rng, 2, 16), _grid(rng, 2, 16)
    r, s = convert.grid_vec_cl(jr, CPU), convert.grid_vec_cl(js, CPU)
    jsteps, jMr = jm(jr)
    assert len(m.levels[0].smoothers) == jm.shape[1]
    for step, jz in zip(m.levels[0].smoothers, jsteps):
        for a, b in zip(step(r), jz):
            _close(a, b, 1e-11)
    Mr, Ms = m.precondition(r), m.precondition(s)
    for a, b in zip(Mr, jMr):
        _close(a, b, 1e-10)
    lhs, rhs = _dot(Mr, s), _dot(r, Ms)
    assert abs(lhs - rhs) <= 1e-10 * abs(lhs)


def test_lean_jacobi_smoother_repairs_jax(jax_levels):
    """JAX's Jacobi smoother takes the diagonal of S_per_level[n], which
    on a lean level is the deviation dS of the irregular columns alone:
    its face scatter fails. The port takes the diagonal of the whole
    operator (uniform_diagonal_cl): equal to the diagonal of the spliced
    full S, and its V-cycle equals the JAX one over the spliced S, where
    JAX is right (1e-10)."""
    jhdi = JHHODegreeInfo(2, 1)
    levs = {n: jax_levels[("lean", n)] for n in (16, 8)}
    cuts = {n: jfs.expand_ring(lev.cut_ids, n, 1) for n, lev in levs.items()}
    jr = _grid(np.random.default_rng(17), 2, 16)
    with pytest.raises(TypeError, match="reshape"):
        jax.jit(lambda S, r: jmg.build_multigrid(
            16, 2, S, hdi=jhdi, coarsest=8, n_smooth=1,
            cut_ids_per_level=cuts, smoother="jacobi", layout="cl",
            uniform_per_level={n: (lev.S_u, lev.irr_ids)
                               for n, lev in levs.items()}).precondition(r)
        )({n: lev.cond.dS for n, lev in levs.items()}, jr)

    full = {n: np.repeat(np.asarray(lev.S_u).reshape(-1, 1), n * n, axis=1)
            for n, lev in levs.items()}
    for n, lev in levs.items():
        full[n][:, lev.irr_ids] += np.asarray(lev.cond.dS)
        sys_ = structured.make_structured_system(n, n, 2, device=CPU)
        dS = convert.tensor(lev.cond.dS, CPU)
        for a, b in zip(cells_last.uniform_diagonal_cl(sys_, lev.S_u,
                                                       lev.irr_ids, dS),
                        cells_last.structured_diagonal_cl(
                            sys_, torch.as_tensor(full[n]))):
            _close(a, b, 1e-14)

    jpre = jax.jit(lambda S, r: jmg.build_multigrid(
        16, 2, S, hdi=jhdi, coarsest=8, n_smooth=1, cut_ids_per_level=cuts,
        smoother="jacobi", layout="cl").precondition(r))
    m = multigrid.build_multigrid(
        16, 2, hdi=HHODegreeInfo(2, 1), coarsest=8, n_smooth=1,
        smoother="jacobi", **convert.mg_levels(
            {n: (np.asarray(lev.cond.dS), lev.S_u, lev.irr_ids, cuts[n])
             for n, lev in levs.items()}, CPU))
    for a, b in zip(m.precondition(convert.grid_vec_cl(jr, CPU)),
                    jpre({n: jnp.asarray(S) for n, S in full.items()}, jr)):
        _close(a, b, 1e-10)


def _cgp(tol):
    return dict(convergence_threshold=tol, divergence_threshold=1e8,
                max_iter=50000, apply_preconditioner=True)


def _jax_solve_levels(jax_levels, fitted):
    """The levels the JAX package's solve_fictdom_structured(16, 1,
    fitted=...) builds: the fine level with its right-hand side; the 8^2
    level build_level(fitted="full") for "full", else
    build_coarse_level's lean one (jax_levels' without drec, which only
    mg_transfer="cut" reads)."""
    if fitted == "full":
        return {n: jax_levels[("full", n)] for n in (16, 8)}
    return {16: jfs.build_level(16, JHHODegreeInfo(2, 1),
                                jfs.default_problem(), jfs.nitsche_eta(1),
                                4, False, False, with_rhs=True,
                                fitted=fitted),
            8: jax_levels[("lean", 8)]}


@pytest.mark.parametrize("fitted,smoother", [("uniform", "block_jacobi"),
                                             ("full", "jacobi")])
def test_damped_smoother_solves_match_jax(jax_levels, fitted, smoother):
    """solve_fictdom_structured(16, 1, mg_smoother=...) against the JAX
    solve with the same options where JAX computes it (its Jacobi
    smoother needs full levels; its _solve_jit over the levels it builds,
    _jax_solve_levels): iterations within 2, H1 rtol 1e-6, local dofs
    within 1e-8, at CG tol 1e-10."""
    r = fs.solve_fictdom_structured(16, 1, fitted=fitted,
                                    mg_smoother=smoother,
                                    cg_params=cg.CGParams(**_cgp(1e-10)),
                                    device="cpu")
    jlocal, jiters, jexit, _, jh1 = jax_solve(
        _jax_solve_levels(jax_levels, fitted), 1,
        jcg.CGParams(**_cgp(1e-10)), mg_smoother=smoother)
    assert r.exit_reason == jexit == 0
    assert abs(r.iterations - jiters) <= 2
    assert np.isclose(r.h1_error, jh1, rtol=1e-6)
    _close(r.local, jlocal, 1e-8)


def test_lean_jacobi_smoother_solve():
    """The repaired lean + Jacobi-smoother solve (JAX fails there) equals
    the full + Jacobi-smoother one (the same discrete system up to the
    full assembly's rounding): iterations within 2, H1 rtol 1e-6."""
    kw = dict(mg_smoother="jacobi", cg_params=cg.CGParams(**_cgp(1e-10)),
              device="cpu")
    lean = fs.solve_fictdom_structured(16, 1, fitted="lean", **kw)
    full = fs.solve_fictdom_structured(16, 1, fitted="full", **kw)
    assert lean.exit_reason == full.exit_reason == 0
    assert abs(lean.iterations - full.iterations) <= 2
    assert np.isclose(lean.h1_error, full.h1_error, rtol=1e-6)
