"""The port's multigrid V-cycle against proton_tpu on the CPU, float64:
the transfer matrices, prolongation and restriction (and their adjoint
identity), the Chebyshev smoother, the coarsest factor, and one V-cycle
apply over the JAX package's own 16^2 and 8^2 levels, in the lean and in
the full form.

The JAX package's transfer-matrix builders are pure functions of (hdi, h)
that its eager multigrid setup calls again for every hierarchy; this
module memoizes them (the same arrays, computed once), and runs the BLAS
and torch thread pools single-threaded."""

import functools

import numpy as np
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


def _systems(nf, nc, fbs):
    return (structured.make_structured_system(nf, nf, fbs, device=CPU),
            structured.make_structured_system(nc, nc, fbs, device=CPU))


@pytest.fixture(autouse=True, scope="module")
def _memoized_jax_transfers_one_thread():
    """Memoize the JAX package's _transfer_face_projectors, _unit_recmap
    and _transfer_slot_matrices for this module (build_multigrid looks
    them up as module globals), and keep BLAS and torch on one thread:
    with a pool per core in every test worker, a dense eigh of a few
    hundred rows takes seconds instead of milliseconds."""
    with pytest.MonkeyPatch.context() as mp, \
            threadpoolctl.threadpool_limits(1):
        for name in ("_transfer_face_projectors", "_unit_recmap",
                     "_transfer_slot_matrices"):
            mp.setattr(jmg, name,
                       functools.lru_cache(maxsize=None)(getattr(jmg, name)))
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)


def _jax_mats(k):
    """The JAX package's transfer matrices of the coarse cell of side
    1/8 (memoized by the fixture above)."""
    return jmg._transfer_slot_matrices(JHHODegreeInfo(k + 1, k), 0.125,
                                       jnp.float64)


@pytest.mark.parametrize("k", [1, 2])
def test_transfer_slot_matrices_match(k):
    """The 12 transfer matrices of the coarse cell of side 1/8, and the
    two halves they are made of, 1e-12."""
    jhdi, hdi = JHHODegreeInfo(k + 1, k), HHODegreeInfo(k + 1, k)
    for a, b in zip(multigrid._transfer_face_projectors(hdi, 0.125,
                                                        device=CPU),
                    jmg._transfer_face_projectors(jhdi, 0.125)):
        _close(a, b)
    _close(multigrid._unit_recmap(hdi, 0.125, device=CPU),
           jmg._unit_recmap(jhdi, 0.125))
    for a, b in zip(multigrid._transfer_slot_matrices(hdi, 0.125, F64,
                                                      device=CPU),
                    _jax_mats(k)):
        _close(a, b)


@pytest.mark.parametrize("k", [1, 2])
def test_prolongation_and_restriction_match(k):
    """Port against JAX on random grids, 16^2 <- 8^2, 1e-12. The port
    computes its own transfer matrices; the JAX side is handed the ones
    test_transfer_slot_matrices_match compares them with."""
    fbs = k + 1
    jhdi, hdi = JHHODegreeInfo(k + 1, k), HHODegreeInfo(k + 1, k)
    jf, jc = (jstructured.make_structured_system(n, n, fbs) for n in (16, 8))
    sf, sc = _systems(16, 8, fbs)
    rng = np.random.default_rng(k)
    jxc, jrf = _grid(rng, fbs, 8), _grid(rng, fbs, 16)
    jp = jmg.make_reconstruction_prolongation_cl(
        jf, jc, jhdi, 0.125, jnp.float64, mats=_jax_mats(k))(jxc)
    p = multigrid.make_reconstruction_prolongation_cl(sf, sc, hdi, 0.125)(
        convert.grid_vec_cl(jxc, CPU))
    jr = jmg.make_reconstruction_restriction_cl(
        jf, jc, jhdi, 0.125, jnp.float64, mats=_jax_mats(k))(jrf)
    r = multigrid.make_reconstruction_restriction_cl(sf, sc, hdi, 0.125)(
        convert.grid_vec_cl(jrf, CPU))
    for a, b in zip(p + r, jp + jr):
        _close(a, b)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_restriction_is_the_adjoint_of_prolongation(k):
    """<P u, v> = <u, R v> to 1e-12 relative, on a 12^2 <- 6^2 pair with
    nonzero values on the frozen faces too."""
    fbs = k + 1
    hdi = HHODegreeInfo(k + 1, k)
    sf, sc = _systems(12, 6, fbs)
    rng = np.random.default_rng(20 + k)
    u = convert.grid_vec_cl(_grid(rng, fbs, 6), CPU)
    v = convert.grid_vec_cl(_grid(rng, fbs, 12), CPU)
    P = multigrid.make_reconstruction_prolongation_cl(sf, sc, hdi, 1.0 / 6)
    R = multigrid.make_reconstruction_restriction_cl(sf, sc, hdi, 1.0 / 6)
    lhs, rhs = _dot(P(u), v), _dot(u, R(v))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def test_mg_sizes_expand_ring_and_coarse_factor_match():
    assert multigrid._mg_sizes(1024, 8) == jmg._mg_sizes(1024, 8) == \
        [1024, 512, 256, 128, 64, 32, 16, 8]
    assert multigrid._mg_sizes(24, 8) == jmg._mg_sizes(24, 8)
    ids = np.array([0, 7, 27, 63])
    for ring in (0, 1, 2):
        assert np.array_equal(fs.expand_ring(ids, 8, ring),
                              jfs.expand_ring(ids, 8, ring))
    # a singular symmetric matrix: the pseudo-inverse drops its kernel
    rng = np.random.default_rng(3)
    B = rng.standard_normal((12, 9))
    A = B @ B.T
    rhs = A @ rng.standard_normal(12)
    x = multigrid._coarse_solve(multigrid._coarse_factor(torch.as_tensor(A)),
                                torch.as_tensor(rhs))
    _close(x, jmg._coarse_solve(jmg._coarse_factor(jnp.asarray(A)),
                                jnp.asarray(rhs)), 1e-10)
    _close(x, np.linalg.pinv(A) @ rhs, 1e-10)


@pytest.fixture(scope="module")
def jax_levels():
    """The JAX package's own levels at 16^2 and 8^2, k=1, in the lean and
    the full form (no right-hand sides: the V-cycle needs none)."""
    hdi, problem = JHHODegreeInfo(2, 1), jfs.default_problem()
    eta = jfs.nitsche_eta(1)
    return {(fitted, n): jfs.build_level(n, hdi, problem, eta, 4, False,
                                         False, with_rhs=False,
                                         fitted=fitted)
            for fitted in ("lean", "full") for n in (16, 8)}


def _mg_pair(jax_levels, fitted, smoother="chebyshev"):
    """(JAX Multigrid, port Multigrid) over the 16^2 and 8^2 levels, with
    solve_fictdom_structured's defaults (one sweep of ``smoother``, the
    patch smoother on the cut cells grown by one ring)."""
    jhdi, hdi = JHHODegreeInfo(2, 1), HHODegreeInfo(2, 1)
    levs = {n: jax_levels[(fitted, n)] for n in (16, 8)}
    lean = fitted == "lean"
    S = {n: (lev.cond.dS if lean else lev.cond.S) for n, lev in levs.items()}
    cuts = {n: jfs.expand_ring(lev.cut_ids, n, 1) for n, lev in levs.items()}
    uni = {n: (lev.S_u, lev.irr_ids) for n, lev in levs.items()} \
        if lean else None
    jm = jmg.build_multigrid(16, 2, S, hdi=jhdi, coarsest=8, n_smooth=1,
                             cut_ids_per_level=cuts, smoother=smoother,
                             layout="cl", uniform_per_level=uni)
    m = multigrid.build_multigrid(
        16, 2, hdi=hdi, coarsest=8, n_smooth=1, smoother=smoother,
        **convert.mg_levels(
            {n: (np.asarray(S[n]), levs[n].S_u, levs[n].irr_ids, cuts[n])
             for n in levs}, CPU))
    return jm, m


@pytest.mark.parametrize("fitted", ["lean", "full"])
def test_vcycle_matches_and_is_symmetric(jax_levels, fitted):
    """One V-cycle apply against the JAX package's
    build_multigrid(...).precondition on the same random residual, 1e-10
    relative, in the lean form and over full S levels; its symmetry
    <M r, s> = <r, M s> to 1e-10; and, on the way, the Chebyshev smoother
    of the fine level, 1e-11."""
    jm, m = _mg_pair(jax_levels, fitted)
    assert len(m.levels) == len(jm.levels) == 2
    assert len(m.levels[0].smoothers) == len(jm.levels[0].smoothers) == 2
    rng = np.random.default_rng(7)
    jr, js = _grid(rng, 2, 16), _grid(rng, 2, 16)
    r, s = convert.grid_vec_cl(jr, CPU), convert.grid_vec_cl(js, CPU)
    for step, jstep in zip(m.levels[0].smoothers, jm.levels[0].smoothers):
        for a, b in zip(step(r), jstep(jr)):
            _close(a, b, 1e-11)
    Mr, Ms = m.precondition(r), m.precondition(s)
    for a, b in zip(Mr, jm.precondition(jr)):
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
    for step, jstep in zip(m.levels[0].smoothers, jm.levels[0].smoothers):
        for a, b in zip(step(r), jstep(jr)):
            _close(a, b, 1e-11)
    Mr, Ms = m.precondition(r), m.precondition(s)
    for a, b in zip(Mr, jm.precondition(jr)):
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
    with pytest.raises(TypeError, match="reshape"):
        jmg.build_multigrid(
            16, 2, {n: lev.cond.dS for n, lev in levs.items()}, hdi=jhdi,
            coarsest=8, n_smooth=1, cut_ids_per_level=cuts,
            smoother="jacobi", layout="cl",
            uniform_per_level={n: (lev.S_u, lev.irr_ids)
                               for n, lev in levs.items()})

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

    jm = jmg.build_multigrid(16, 2, {n: jnp.asarray(S) for n, S in
                                     full.items()}, hdi=jhdi, coarsest=8,
                             n_smooth=1, cut_ids_per_level=cuts,
                             smoother="jacobi", layout="cl")
    m = multigrid.build_multigrid(
        16, 2, hdi=HHODegreeInfo(2, 1), coarsest=8, n_smooth=1,
        smoother="jacobi", **convert.mg_levels(
            {n: (np.asarray(lev.cond.dS), lev.S_u, lev.irr_ids, cuts[n])
             for n, lev in levs.items()}, CPU))
    jr = _grid(np.random.default_rng(17), 2, 16)
    for a, b in zip(m.precondition(convert.grid_vec_cl(jr, CPU)),
                    jm.precondition(jr)):
        _close(a, b, 1e-10)


def _cgp(tol):
    return dict(convergence_threshold=tol, divergence_threshold=1e8,
                max_iter=50000, apply_preconditioner=True)


@pytest.mark.parametrize("fitted,smoother", [("uniform", "block_jacobi"),
                                             ("full", "jacobi")])
def test_damped_smoother_solves_match_jax(fitted, smoother):
    """solve_fictdom_structured(16, 1, mg_smoother=...) against the JAX
    solve with the same options where JAX computes it (its Jacobi
    smoother needs full levels): iterations within 2, H1 rtol 1e-6,
    local dofs within 1e-8, at CG tol 1e-10."""
    r = fs.solve_fictdom_structured(16, 1, fitted=fitted,
                                    mg_smoother=smoother,
                                    cg_params=cg.CGParams(**_cgp(1e-10)),
                                    device="cpu")
    jr = jfs.solve_fictdom_structured(16, 1, mixed=False, use_pallas=False,
                                      fitted=fitted, mg_smoother=smoother,
                                      cg_params=jcg.CGParams(**_cgp(1e-10)))
    assert r.exit_reason == int(jr.exit_reason) == 0
    assert abs(r.iterations - int(jr.iterations)) <= 2
    assert np.isclose(r.h1_error, float(jr.h1_error), rtol=1e-6)
    _close(r.local, jr.local, 1e-8)


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
