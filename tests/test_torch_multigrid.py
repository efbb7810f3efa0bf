"""The port's multigrid V-cycle against proton_tpu on the CPU, float64:
the Chebyshev smoother and its eigenvalue estimate, the damped smoothers,
and one V-cycle apply over the JAX package's own 16^2 and 8^2 levels, in
the lean and in the full form, and the solves with the damped smoothers.
The transfer matrices, prolongation and restriction and the coarsest
factor are in tests/test_torch_multigrid_transfers.py.

The JAX package's levels, V-cycles, smoothers and solves are read from
tests/jax_refs/test_torch_multigrid.npz (REFS below;
tests/torch_jax_reference.py writes it, running the JAX package alone on
the same seeded inputs: each V-cycle built and applied under one jax.jit
over the stored levels, each solve its _solve_jit over its levels). The
BLAS and torch thread pools run single-threaded."""

import functools
import re

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
from torch_jax_reference import Refs, jax_solve_ref

CPU = torch.device("cpu")
F64 = torch.float64
REFS = Refs(__name__)


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
def _one_thread():
    """Keep BLAS and torch on one thread: with a pool per core in every
    test worker, a dense eigh of a few hundred rows takes seconds instead
    of milliseconds."""
    with threadpoolctl.threadpool_limits(1):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax_level_data():
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


def _jax_levels():
    """What the V-cycles read of _jax_level_data, {fitted: {n: ...}}."""
    out = {"lean": {}, "full": {}}
    for (fitted, n), lev in _jax_level_data().items():
        out[fitted][n] = dict(cut_ids=lev.cut_ids, irr_ids=lev.irr_ids,
                              S_u=lev.S_u, cond=dict(
                                  dS=lev.cond.dS if fitted == "lean" else None,
                                  S=lev.cond.S if fitted == "full" else None))
    return out


REFS.add("levels", "level",
         "build_level(n, HHODegreeInfo(2, 1), default_problem(), "
         "nitsche_eta(1), 4, False, False, with_rhs=(n == 16 and full), "
         "fitted=...) for fitted in ('lean', 'full'), n in (16, 8)",
         _jax_levels)


def _by_key(stored):
    return {(fitted, n): stored[fitted][n] for fitted in ("lean", "full")
            for n in (16, 8)}


@pytest.fixture(scope="module")
def jax_levels():
    """The stored levels, {(fitted, n): level}."""
    return _by_key(REFS["levels"])


def _level_inputs(jax_levels, fitted):
    levs = {n: jax_levels[(fitted, n)] for n in (16, 8)}
    lean = fitted == "lean"
    S = {n: (lev.cond.dS if lean else lev.cond.S) for n, lev in levs.items()}
    cuts = {n: jfs.expand_ring(lev.cut_ids, n, 1) for n, lev in levs.items()}
    uni = {n: (lev.S_u, lev.irr_ids) for n, lev in levs.items()} \
        if lean else None
    return levs, S, cuts, uni


def _jax_mg(jax_levels, fitted, smoother, residual_seed):
    """The JAX V-cycle over the stored 16^2 and 8^2 levels, with
    solve_fictdom_structured's defaults (one sweep of ``smoother``, the
    patch smoother on the cut cells grown by one ring), as one jitted
    function of the test's random residual r: its build_multigrid, then
    (each smoother step of the fine level applied to r, the V-cycle
    applied to r), and the hierarchy's number of levels and of fine
    smoother steps."""
    jhdi = JHHODegreeInfo(2, 1)
    _, S, cuts, uni = _level_inputs(_by_key(jax_levels), fitted)
    shape = []

    def jax_apply(S, r):
        jm = jmg.build_multigrid(16, 2, S, hdi=jhdi, coarsest=8, n_smooth=1,
                                 cut_ids_per_level=cuts, smoother=smoother,
                                 layout="cl", uniform_per_level=uni)
        shape[:] = (len(jm.levels), len(jm.levels[0].smoothers))
        return [step(r) for step in jm.levels[0].smoothers], \
            jm.precondition(r)

    jr = _grid(np.random.default_rng(residual_seed), 2, 16)
    steps, Mr = jax.jit(jax_apply)(S, jr)
    return dict(steps=steps, Mr=Mr, shape=shape)


def _port_mg(jax_levels, fitted, smoother="chebyshev"):
    """The port's Multigrid over the stored 16^2 and 8^2 levels, with the
    keywords of _jax_mg."""
    levs, S, cuts, _ = _level_inputs(jax_levels, fitted)
    return multigrid.build_multigrid(
        16, 2, hdi=HHODegreeInfo(2, 1), coarsest=8, n_smooth=1,
        smoother=smoother,
        **convert.mg_levels(
            {n: (np.asarray(S[n]), levs[n].S_u, levs[n].irr_ids, cuts[n])
             for n in levs}, CPU))


for _fitted in ("lean", "full"):
    REFS.add(f"vcycle[{_fitted}]", "vcycle",
             f"build_multigrid(16, 2, coarsest=8, n_smooth=1, "
             f"smoother='chebyshev', layout='cl') over the stored "
             f"{_fitted} levels: the fine smoother steps and precondition "
             f"of a random residual, under jax.jit", _jax_mg,
             needs=("levels",), seed=7, fitted=_fitted,
             smoother="chebyshev", residual_seed=7)


@pytest.mark.parametrize("fitted", ["lean", "full"])
def test_vcycle_matches_and_is_symmetric(jax_levels, fitted):
    """One V-cycle apply against the JAX package's
    build_multigrid(...).precondition on the same random residual, 1e-10
    relative, in the lean form and over full S levels; its symmetry
    <M r, s> = <r, M s> to 1e-10; and, on the way, the Chebyshev smoother
    of the fine level, 1e-11."""
    m = _port_mg(jax_levels, fitted)
    rng = np.random.default_rng(7)
    jr, js = _grid(rng, 2, 16), _grid(rng, 2, 16)
    r, s = convert.grid_vec_cl(jr, CPU), convert.grid_vec_cl(js, CPU)
    jsteps, jMr, shape = REFS[f"vcycle[{fitted}]"]
    assert (len(m.levels), len(m.levels[0].smoothers)) == tuple(shape) == \
        (2, 2)
    for step, jz in zip(m.levels[0].smoothers, jsteps):
        for a, b in zip(step(r), jz):
            _close(a, b, 1e-11)
    Mr, Ms = m.precondition(r), m.precondition(s)
    for a, b in zip(Mr, jMr):
        _close(a, b, 1e-10)
    lhs, rhs = _dot(Mr, s), _dot(r, Ms)
    assert abs(lhs - rhs) <= 1e-10 * abs(lhs)


def _jax_lambda_chebyshev(jax_levels):
    """The JAX package's estimate_lambda_max and Chebyshev smoother
    (degrees 1 and 4) on the stored lean 16^2 operator with its corrected
    block-Jacobi, from the test's random grid."""
    lev = jax_levels["lean"][16]
    jsys = jstructured.make_structured_system(16, 16, 2)
    jA = jcl.make_uniform_operator_cl(jsys, lev.S_u, lev.irr_ids,
                                      lev.cond.dS)
    hf, vf = jcl.uniform_face_block_deltas(jsys, lev.cond.dS, lev.irr_ids)
    jbase = jcl.make_uniform_block_jacobi_cl(
        jsys, *jcl.uniform_block_jacobi_blocks(jsys, lev.S_u),
        *jcl.uniform_bj_from_deltas(jsys, lev.S_u, hf, vf, jnp.float64))
    jx = _grid(np.random.default_rng(11), 2, 16)
    jlam = float(jmg.estimate_lambda_max(jA, jbase, jx))
    return dict(lam=jlam, cheb={
        degree: jmg.make_chebyshev_smoother(jA, jbase, jlam,
                                            degree=degree)(jx)
        for degree in (1, 4)})


REFS.add("lambda_chebyshev", "smoother",
         "estimate_lambda_max(A, base, x) and make_chebyshev_smoother(A, "
         "base, lam, degree=1 and 4)(x) on the stored lean 16^2 level",
         _jax_lambda_chebyshev, needs=("levels",), seed=11)


def test_lambda_max_and_chebyshev_match(jax_levels):
    """estimate_lambda_max (rtol 1e-10) and the Chebyshev smoother (1e-11)
    on the lean 16^2 operator with its corrected block-Jacobi."""
    lev = jax_levels[("lean", 16)]
    sys_ = structured.make_structured_system(16, 16, 2, device=CPU)
    dS = convert.tensor(lev.cond.dS, CPU)
    A = cells_last.make_uniform_operator_cl(sys_, lev.S_u, lev.irr_ids, dS)
    hf, vf = cells_last.uniform_face_block_deltas(sys_, dS, lev.irr_ids)
    base = cells_last.make_uniform_block_jacobi_cl(
        sys_, *cells_last.uniform_block_jacobi_blocks(sys_, lev.S_u),
        *cells_last.uniform_bj_from_deltas(sys_, lev.S_u, hf, vf, F64))

    rng = np.random.default_rng(11)
    jx = _grid(rng, 2, 16)
    x = convert.grid_vec_cl(jx, CPU)
    ref = REFS["lambda_chebyshev"]
    jlam = ref.lam
    lam = multigrid.estimate_lambda_max(A, base, x)
    assert isinstance(lam, float)
    np.testing.assert_allclose(lam, jlam, rtol=1e-10)
    for degree in (1, 4):
        jz = ref.cheb[degree]
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


for _smoother in ("block_jacobi", "jacobi"):
    REFS.add(f"damped_vcycle[{_smoother}]", "vcycle",
             f"build_multigrid(16, 2, coarsest=8, n_smooth=1, "
             f"smoother={_smoother!r}, layout='cl') over the stored full "
             f"levels: the fine smoother steps and precondition of a random "
             f"residual, under jax.jit", _jax_mg, needs=("levels",),
             seed=13, fitted="full", smoother=_smoother, residual_seed=13)


@pytest.mark.parametrize("smoother", ["block_jacobi", "jacobi"])
def test_damped_smoother_vcycle_matches(jax_levels, smoother):
    """The V-cycle with the damped block-Jacobi or Jacobi smoother
    (omega 0.67) against the JAX package's on the same full levels,
    1e-10, and its symmetry to 1e-10. On lean levels: block-Jacobi in
    test_damped_smoother_solves_match_jax (an eager JAX V-cycle build over
    lean levels costs ~20 s here), Jacobi in
    test_lean_jacobi_smoother_repairs_jax."""
    m = _port_mg(jax_levels, "full", smoother)
    rng = np.random.default_rng(13)
    jr, js = _grid(rng, 2, 16), _grid(rng, 2, 16)
    r, s = convert.grid_vec_cl(jr, CPU), convert.grid_vec_cl(js, CPU)
    jsteps, jMr, shape = REFS[f"damped_vcycle[{smoother}]"]
    assert len(m.levels[0].smoothers) == shape[1]
    for step, jz in zip(m.levels[0].smoothers, jsteps):
        for a, b in zip(step(r), jz):
            _close(a, b, 1e-11)
    Mr, Ms = m.precondition(r), m.precondition(s)
    for a, b in zip(Mr, jMr):
        _close(a, b, 1e-10)
    lhs, rhs = _dot(Mr, s), _dot(r, Ms)
    assert abs(lhs - rhs) <= 1e-10 * abs(lhs)


def _jax_lean_jacobi(jax_levels):
    """The JAX package's Jacobi-smoother V-cycle over the stored lean
    levels (it fails: the error's type and message), and over the same
    levels with S spliced to full (the V-cycle applied to the test's
    random residual), each under jax.jit."""
    jhdi = JHHODegreeInfo(2, 1)
    levs = {n: jax_levels["lean"][n] for n in (16, 8)}
    cuts = {n: jfs.expand_ring(lev.cut_ids, n, 1) for n, lev in levs.items()}
    jr = _grid(np.random.default_rng(17), 2, 16)
    try:
        jax.jit(lambda S, r: jmg.build_multigrid(
            16, 2, S, hdi=jhdi, coarsest=8, n_smooth=1,
            cut_ids_per_level=cuts, smoother="jacobi", layout="cl",
            uniform_per_level={n: (lev.S_u, lev.irr_ids)
                               for n, lev in levs.items()}).precondition(r)
        )({n: lev.cond.dS for n, lev in levs.items()}, jr)
        error = ("", "")
    except Exception as e:  # noqa: BLE001 (the failure is the reference)
        error = (type(e).__name__, str(e))
    jpre = jax.jit(lambda S, r: jmg.build_multigrid(
        16, 2, S, hdi=jhdi, coarsest=8, n_smooth=1, cut_ids_per_level=cuts,
        smoother="jacobi", layout="cl").precondition(r))
    return dict(error_type=error[0], error=error[1],
                spliced=jpre({n: jnp.asarray(S) for n, S in
                              _spliced(levs).items()}, jr))


def _spliced(levs):
    """The full S of each lean level: S_u on every cell, plus dS on the
    irregular ones."""
    full = {n: np.repeat(np.asarray(lev.S_u).reshape(-1, 1), n * n, axis=1)
            for n, lev in levs.items()}
    for n, lev in levs.items():
        full[n][:, lev.irr_ids] += np.asarray(lev.cond.dS)
    return full


REFS.add("lean_jacobi", "vcycle",
         "build_multigrid(16, 2, coarsest=8, n_smooth=1, smoother='jacobi', "
         "layout='cl') over the stored lean levels (its error) and over "
         "their spliced full S (precondition of a random residual), under "
         "jax.jit", _jax_lean_jacobi, needs=("levels",), seed=17)


def test_lean_jacobi_smoother_repairs_jax(jax_levels):
    """JAX's Jacobi smoother takes the diagonal of S_per_level[n], which
    on a lean level is the deviation dS of the irregular columns alone:
    its face scatter fails. The port takes the diagonal of the whole
    operator (uniform_diagonal_cl): equal to the diagonal of the spliced
    full S, and its V-cycle equals the JAX one over the spliced S, where
    JAX is right (1e-10)."""
    levs = {n: jax_levels[("lean", n)] for n in (16, 8)}
    cuts = {n: jfs.expand_ring(lev.cut_ids, n, 1) for n, lev in levs.items()}
    jr = _grid(np.random.default_rng(17), 2, 16)
    ref = REFS["lean_jacobi"]
    assert ref.error_type == "TypeError" and re.search("reshape", ref.error)

    full = _spliced(levs)
    for n, lev in levs.items():
        sys_ = structured.make_structured_system(n, n, 2, device=CPU)
        dS = convert.tensor(lev.cond.dS, CPU)
        for a, b in zip(cells_last.uniform_diagonal_cl(sys_, lev.S_u,
                                                       lev.irr_ids, dS),
                        cells_last.structured_diagonal_cl(
                            sys_, torch.as_tensor(full[n]))):
            _close(a, b, 1e-14)

    m = multigrid.build_multigrid(
        16, 2, hdi=HHODegreeInfo(2, 1), coarsest=8, n_smooth=1,
        smoother="jacobi", **convert.mg_levels(
            {n: (np.asarray(lev.cond.dS), lev.S_u, lev.irr_ids, cuts[n])
             for n, lev in levs.items()}, CPU))
    for a, b in zip(m.precondition(convert.grid_vec_cl(jr, CPU)),
                    ref.spliced):
        _close(a, b, 1e-10)


def _cgp(tol):
    return dict(convergence_threshold=tol, divergence_threshold=1e8,
                max_iter=50000, apply_preconditioner=True)


def _jax_solve_levels(fitted):
    """The levels the JAX package's solve_fictdom_structured(16, 1,
    fitted=...) builds: the fine level with its right-hand side; the 8^2
    level build_level(fitted="full") for "full", else
    build_coarse_level's lean one (_jax_level_data's, without drec, which
    only mg_transfer="cut" reads)."""
    jax_levels = _jax_level_data()
    if fitted == "full":
        return {n: jax_levels[("full", n)] for n in (16, 8)}
    return {16: jfs.build_level(16, JHHODegreeInfo(2, 1),
                                jfs.default_problem(), jfs.nitsche_eta(1),
                                4, False, False, with_rhs=True,
                                fitted=fitted),
            8: jax_levels[("lean", 8)]}


def _jax_damped_solve(fitted, smoother):
    return jax_solve_ref(_jax_solve_levels(fitted), 1,
                         jcg.CGParams(**_cgp(1e-10)), mg_smoother=smoother)


for _fitted, _smoother in (("uniform", "block_jacobi"), ("full", "jacobi")):
    REFS.add(f"damped_solve[{_fitted}-{_smoother}]", "solve",
             f"solve_fictdom_structured(16, 1, fitted={_fitted!r}, "
             f"mg_smoother={_smoother!r}, mixed=False, use_pallas=False), "
             f"CG tol 1e-10: _solve_jit over _jax_solve_levels",
             _jax_damped_solve, fitted=_fitted, smoother=_smoother)


@pytest.mark.parametrize("fitted,smoother", [("uniform", "block_jacobi"),
                                             ("full", "jacobi")])
def test_damped_smoother_solves_match_jax(fitted, smoother):
    """solve_fictdom_structured(16, 1, mg_smoother=...) against the JAX
    solve with the same options where JAX computes it (its Jacobi
    smoother needs full levels; its _solve_jit over the levels it builds,
    _jax_solve_levels): iterations within 2, H1 rtol 1e-6, local dofs
    within 1e-8, at CG tol 1e-10."""
    r = fs.solve_fictdom_structured(16, 1, fitted=fitted,
                                    mg_smoother=smoother,
                                    cg_params=cg.CGParams(**_cgp(1e-10)),
                                    device="cpu")
    jlocal, jiters, jexit, _, jh1 = \
        REFS[f"damped_solve[{fitted}-{smoother}]"]
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
