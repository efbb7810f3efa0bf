"""The port's precision modes against proton_tpu on the CPU: CG's warm
start (x0, nr0), residual replacement, progress line, segments and
float32 run; the float32 classification; the mixed-precision level (the
float32 system with the float64 cut class spliced in) and its pieces;
the float32 V-cycle; and the solves of every mode at 16^2.

Every comparison with the JAX package runs it live on the same inputs,
each JAX reference computed once: the level builds, the cut class, CG
(warm-started, segmented, float32), the float32 V-cycle and one
end-to-end mixed solve (k=2, where the mixed system's H1 error differs
from the float64 one by 3e-3). The other end-to-end solves are held, in
addition, to the JAX package's numbers in PRECISION_GATES, from
scripts/precision_jax_gates.py: each case there also has a live check
of its pieces here (a JAX solve costs 60-90 s of compilation on one CPU
core, more than this file may take for each)."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import threadpoolctl
import torch

from proton_tpu.core.ops import HHODegreeInfo as JHHODegreeInfo
from proton_tpu.cut import fictdom_structured as jfs
from proton_tpu.methods import cells_last as jcl, condensation as jcond
from proton_tpu.methods import structured as jstructured
from proton_tpu.solvers import cg as jcg, multigrid as jmg
from proton_tpu_torch import convert
from proton_tpu_torch.core.ops import HHODegreeInfo
from proton_tpu_torch.cut import fictdom_structured as fs
from proton_tpu_torch.methods import cells_last, condensation, structured
from proton_tpu_torch.solvers import cg

CPU = torch.device("cpu")
N = 16

# The JAX package, CPU, x64, solve_fictdom_structured(16, k, ...,
# use_pallas=False), divergence 1e8, max_iter 50000: (iterations, exit
# code, H1 error), from scripts/precision_jax_gates.py, which names each
# case's degree, tolerance and keywords. The live check of each case's
# pieces: mixed_k1, the level and its cut class (test_mixed_level_matches_
# jax, test_cut64_matches_jax); mixed_k2, the JAX solve itself
# (jax_mixed_k2); mixed_cg32_k1, float32 CG (test_cg_float32_matches_jax);
# mixed_full_k2, the fully assembled level (test_mixed_full_level_matches_
# jax); mg_f32_k2, the float32 V-cycle (test_vcycle_f32_matches_jax);
# segment4_k1, the segment loop (test_segmented_cg_matches_jax).
PRECISION_GATES = {
    "mixed_k1": (9, 0, 0.004434721544384956),
    "mixed_k2": (9, 0, 0.00018096464918926358),
    "mixed_full_k2": (9, 0, 0.00018917652778327465),
    "mixed_cg32_k1": (7, 0, 0.004434734582901001),
    "mg_f32_k2": (12, 0, 0.00018041372739208727),
    "segment4_k1": (10, 0, 0.004434838993335277),
}

# (degree, CG tolerance, keywords) of each case, as in the script.
CASES = {
    "mixed_k1": (1, 1e-9, dict(mixed=True, fitted="lean")),
    "mixed_k2": (2, 1e-9, dict(mixed=True, fitted="lean")),
    "mixed_full_k2": (2, 1e-9, dict(mixed=True, fitted="full")),
    "mixed_cg32_k1": (1, 1e-7, dict(mixed=True, fitted="lean",
                                    cg_f64=False)),
    "mg_f32_k2": (2, 1e-11, dict(mixed=False, fitted="lean", mg_f32=True)),
    "segment4_k1": (1, 1e-10, dict(mixed=False, fitted="lean",
                                   cg_segment=4)),
}

# H1 rtol of the mixed solves against the JAX package's. At k=1 the mixed
# and the float64 H1 differ by 2.2e-5-2.6e-5 (4.434839e-3 in float64), so
# 1e-5 tells them apart (measured 5.0e-6 and 2.9e-6: XLA and torch round
# float32 in different orders); at k=2 by 3e-3, and 1e-3 does (measured
# 1.9e-4 against the stored number, 7.4e-4 against a live JAX run whose
# own float32 rounding moves with its thread count).
MIXED_H1_RTOL = {1: 1e-5, 2: 1e-3}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """BLAS and torch on one thread (see tests/test_torch_solve.py)."""
    with threadpoolctl.threadpool_limits(1):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)


def _cgp(tol):
    return dict(convergence_threshold=tol, divergence_threshold=1e8,
                max_iter=50000, apply_preconditioner=True)


def _close(a, ref, tol):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    ref = np.asarray(ref)
    assert a.shape == ref.shape
    err = np.max(np.abs(a.astype(np.float64) - ref.astype(np.float64)))
    assert err <= tol * np.max(np.abs(ref)), err / np.max(np.abs(ref))


def _spd_system(seed, Nx=9, Ny=8, fbs=2, dtype=np.float64):
    """A random SPD cells-last system on an Nx x Ny face grid in both
    packages, in ``dtype``: (JAX operator, port operator, JAX
    block-Jacobi, port block-Jacobi, a random JAX grid vector and its
    port copy, a second pair)."""
    rng = np.random.default_rng(seed)
    nfd, C = 4 * fbs, Nx * Ny
    B = rng.standard_normal((C, nfd, nfd))
    S = np.transpose(B @ np.transpose(B, (0, 2, 1)) + 0.05 * np.eye(nfd),
                     (1, 2, 0)).reshape(nfd * nfd, C).astype(dtype)
    jsys = jstructured.make_structured_system(Nx, Ny, fbs)
    tsys = structured.make_structured_system(Nx, Ny, fbs, device=CPU)

    def grids():
        j = jcl.GridVecCL(*(jnp.asarray(rng.standard_normal(shape), dtype)
                            for shape in ((fbs, Ny + 1, Nx),
                                          (fbs, Ny, Nx + 1))))
        return j, convert.grid_vec_cl(j, CPU)

    return (jcl.make_structured_operator_cl(jsys, jnp.asarray(S)),
            cells_last.make_structured_operator_cl(tsys, torch.as_tensor(S)),
            jcl.block_jacobi_preconditioner_cl(jsys, jnp.asarray(S)),
            cells_last.block_jacobi_preconditioner_cl(tsys,
                                                      torch.as_tensor(S)),
            grids(), grids())


def _cg_pair(system, params, **warm):
    """The JAX and the port's CG on one system from the same start."""
    jA, A, jpre, pre, (jb, b), _ = system
    jwarm = {k: (v[0] if isinstance(v, tuple) else v)
             for k, v in warm.items()}
    twarm = {k: (v[1] if isinstance(v, tuple) else v)
             for k, v in warm.items()}
    jr = jcg.conjugated_gradient(jA, jb, None, jcg.CGParams(**params),
                                 precond=jpre, **jwarm)
    r = cg.conjugated_gradient(A, b, None, cg.CGParams(**params),
                               precond=pre, **twarm)
    return jr, r


def _same_cg(jr, r, x_tol=1e-10):
    """Equal exit codes and counts; residuals within rtol 1e-6 or 1e-15
    absolute (a recomputed true residual b - A x carries rounding of that
    size); x within x_tol."""
    assert r.exit_reason == int(jr.exit_reason)
    assert r.iterations == int(jr.iterations)
    np.testing.assert_allclose(r.rel_residual, float(jr.rel_residual),
                               rtol=1e-6, atol=1e-15)
    for a, c in zip(r.x, jr.x):
        _close(a, c, x_tol)


@pytest.mark.parametrize("nr0", [None, 3.0])
def test_cg_warm_start_matches_jax(nr0):
    """conjugated_gradient(x0=, nr0=) against the JAX package's on a
    random SPD system with block-Jacobi: from a random x0 (the first
    residual is b - A x0), with the start's own norm (nr0=None) or a
    caller's nr0 in the exit tests: _same_cg, x within 1e-10. Then two
    segments of 5: the second warm-started from the first's x with the
    first residual's norm, as the segmented solve chains them."""
    system = _spd_system(3)
    params = dict(convergence_threshold=1e-9, divergence_threshold=1e8,
                  max_iter=1000, apply_preconditioner=True)
    x0 = system[5]
    warm = dict(x0=x0) if nr0 is None else dict(x0=x0, nr0=nr0)
    jr, r = _cg_pair(system, params, **warm)
    assert r.exit_reason == cg.CONVERGED
    _same_cg(jr, r)

    seg = dict(params, max_iter=5)
    jr1, r1 = _cg_pair(system, seg)
    assert r1.exit_reason == cg.MAX_ITER_REACHED and r1.iterations == 7
    jnr0 = float(np.sqrt(sum(float(jnp.vdot(a, a)) for a in system[4][0])))
    jr2, r2 = _cg_pair(system, seg, x0=(jr1.x, r1.x), nr0=jnr0)
    _same_cg(jr2, r2, 1e-9)


def test_cg_recompute_every_matches_jax():
    """CGParams.recompute_every=3 (the recurred residual replaced by
    b - A x every 3 iterations) against the JAX package's: _same_cg, x
    within 1e-10; and it converges to the plain run's x."""
    system = _spd_system(4)
    params = dict(convergence_threshold=1e-10, divergence_threshold=1e8,
                  max_iter=1000, apply_preconditioner=True,
                  recompute_every=3)
    jr, r = _cg_pair(system, params)
    assert r.exit_reason == cg.CONVERGED
    _same_cg(jr, r)
    plain = _cg_pair(system, dict(params, recompute_every=0))[1]
    for a, b in zip(r.x, plain.x):
        _close(a, b, 1e-8)


def test_cg_verbose_prints_every_100_iterations(capsys):
    """CGParams.verbose prints the reference's progress line at
    iterations 0, 100, ... with the relative residual the exit test
    read (1.0 at iteration 0 from x0 = 0)."""
    _, A, _, _, (_, b), _ = _spd_system(5)
    r = cg.conjugated_gradient(A, b, None, cg.CGParams(
        convergence_threshold=0.0, max_iter=150, verbose=True,
        record_history=True))
    lines = capsys.readouterr().out.splitlines()
    assert r.iterations == 152
    assert lines[0] == " -> Iteration 0, rr = 1.0"
    assert len(lines) == 2 and lines[1].startswith(" -> Iteration 100, rr = ")
    assert float(lines[1].split("= ")[1]) == float(r.history[100])


def test_classify_f32_matches_jax():
    """classify_level(classify_f32=True) against the JAX package's at
    16^2: equal cut ids and cell, node and face codes, displaced flags;
    float32 points within 1e-6; the same arrays as the float32 dtype's
    classification. mixed=True returns the float32 copy of the float64
    classification (the codes of the default run); mixed with a float32
    dtype raises ValueError."""
    p = fs.default_problem()
    mesh, cd, cut = fs.classify_level(N, p, 4, device=CPU,
                                      classify_f32=True)
    jmesh, jcd, jcut = jfs.classify_level(N, jfs.default_problem(), 4, False,
                                          classify_f32=True)
    assert mesh.points.dtype == torch.float32 == cd.interface.dtype
    assert np.array_equal(cut, np.asarray(jcut))
    for name in ("cell_loc", "node_loc", "face_loc", "distorted"):
        assert np.array_equal(getattr(cd, name).numpy(),
                              np.asarray(getattr(jcd, name))), name
    _close(mesh.points, jmesh.points, 1e-6)
    f32 = fs.classify_level(N, p, 4, device=CPU, dtype=torch.float32)
    assert torch.equal(mesh.points, f32[0].points)
    assert torch.equal(cd.cell_loc, f32[1].cell_loc)
    ref = fs.classify_level(N, p, 4, device=CPU)
    mixed = fs.classify_level(N, p, 4, device=CPU, mixed=True)
    assert mixed[0].points.dtype == torch.float32
    assert torch.equal(mixed[0].points, ref[0].points.float())
    assert torch.equal(mixed[1].cell_loc, ref[1].cell_loc)
    with pytest.raises(ValueError, match="float64"):
        fs.classify_level(N, p, 4, device=CPU, dtype=torch.float32,
                          mixed=True)


def test_from_row_major_and_set_cells_match_jax():
    """cells_last.from_row_major (the back-substitution operators of a
    row-major condensed batch) and set_cells (its splice, cast to the
    system's dtype) against the JAX package's on random SPD cells, 1e-12;
    the float32 splice equals JAX's rounding of the same columns."""
    rng = np.random.default_rng(7)
    C, cbs, nfd = 11, 6, 8
    d = cbs + nfd
    B = rng.standard_normal((C, d, d))
    lc = B @ np.transpose(B, (0, 2, 1)) + d * np.eye(d)
    f = rng.standard_normal((C, cbs))
    sub = cells_last.from_row_major(condensation.condense(
        torch.as_tensor(lc), torch.as_tensor(f), cbs, robust=True))
    jsub = jcl.from_row_major(jcond.condense(jnp.asarray(lc), jnp.asarray(f),
                                             cbs, robust=True))
    for a, b in zip(sub, jsub):
        _close(a, b, 1e-12)
    Cb = 40
    big = cells_last.CondensedCL(*(torch.as_tensor(
        rng.standard_normal((a.shape[0], Cb)), dtype=torch.float32)
        for a in sub))
    jbig = jcl.CondensedCL(*(jnp.asarray(a.numpy()) for a in big))
    ids = np.sort(rng.choice(Cb, C, replace=False))
    out = cells_last.set_cells(big, torch.as_tensor(ids), sub)
    jout = jcl.set_cells(jbig, jnp.asarray(ids),
                         jcl.CondensedCL(*(a.astype(jnp.float32)
                                           for a in jsub)))
    assert out is big
    for a, b in zip(out, jout):
        assert a.dtype == torch.float32
        _close(a, b, 1e-6)


@pytest.fixture(scope="module")
def mixed_levels():
    """{k: (the port's, the JAX package's lean mixed 16^2 level)}, with
    right-hand sides (JAX: build_level(mixed=True, fitted="lean"))."""
    out = {}
    for k in (1, 2):
        out[k] = (
            fs.build_level(N, HHODegreeInfo(k + 1, k), fs.default_problem(),
                           fs.nitsche_eta(k), 4, device=CPU, fitted="lean",
                           mixed=True),
            jfs.build_level(N, JHHODegreeInfo(k + 1, k),
                            jfs.default_problem(), jfs.nitsche_eta(k), 4,
                            True, use_pallas=False, with_rhs=True,
                            fitted="lean"))
    return out


@pytest.mark.parametrize("k", [1, 2])
def test_mixed_level_matches_jax(mixed_levels, k):
    """The lean mixed level against the JAX package's on the same mesh:
    equal irregular and cut ids, float32 members. The cut columns of dS
    and bF are float64 values rounded to float32 in both packages: within
    1e-6 of the largest entry (measured 1e-16). The displaced columns of
    dS (K1's float32 operator minus the unit cell's, where both packages
    round differently) within 2e-5 (measured 3.0e-6 at k=1, 7.6e-6 at
    k=2); fT within 2e-6 (4.4e-7), bF 1e-6 (2e-8). X_i and y_i within
    5e-6 (measured 7.9e-7): the back-substitution of the worst sliver cut
    block in float64 moves with the rounding of either factorization by
    that much (cut64_condensed, next test)."""
    lev, jlev = mixed_levels[k]
    irr = lev.irr_ids
    assert np.array_equal(irr, np.asarray(jlev.irr_ids))
    assert np.array_equal(lev.cut_ids, np.asarray(jlev.cut_ids))
    assert all(a.dtype == torch.float32 for a in lev.cond)
    cut = np.isin(irr, lev.cut_ids)
    dS, jdS = lev.cond.dS.numpy(), np.asarray(jlev.cond.dS)
    scale = np.abs(jdS).max()
    assert np.abs(dS[:, cut] - jdS[:, cut]).max() <= 1e-6 * scale
    assert np.abs(dS[:, ~cut] - jdS[:, ~cut]).max() <= 2e-5 * scale
    _close(lev.cond.fT, jlev.cond.fT, 2e-6)
    _close(lev.cond.bF, jlev.cond.bF, 1e-6)
    _close(lev.cond.X_i, jlev.cond.X_i, 5e-6)
    _close(lev.cond.y_i, jlev.cond.y_i, 5e-6)


def test_mixed_full_level_matches_jax():
    """The fully assembled mixed 16^2 k=2 level (K1 in float32 on every
    cell, the float64 cut class spliced in) against the JAX package's
    (build_level(mixed=True, fitted="full")): float32 members, the cut
    columns of S equal to JAX's to 1e-6 of the largest entry (measured
    0), every column of S within 2e-5 (measured 5.3e-6: K1's plain
    float32 version and JAX's float32 assembly round each cell
    differently), bF within 1e-6 (2.4e-8), X and y within 5e-6
    (7.9e-7)."""
    k = 2
    lev = fs.build_level(N, HHODegreeInfo(k + 1, k), fs.default_problem(),
                         fs.nitsche_eta(k), 4, device=CPU, fitted="full",
                         mixed=True)
    jlev = jfs.build_level(N, JHHODegreeInfo(k + 1, k), jfs.default_problem(),
                           jfs.nitsche_eta(k), 4, True, use_pallas=False,
                           with_rhs=True, fitted="full")
    assert all(a.dtype == torch.float32 for a in lev.cond)
    assert np.array_equal(lev.cut_ids, np.asarray(jlev.cut_ids))
    S, jS = lev.cond.S.numpy(), np.asarray(jlev.cond.S)
    cut = lev.cut_ids
    assert np.abs(S[:, cut] - jS[:, cut]).max() <= 1e-6 * np.abs(jS).max()
    _close(S, jS, 2e-5)
    _close(lev.cond.bF, jlev.cond.bF, 1e-6)
    _close(lev.cond.X, jlev.cond.X, 5e-6)
    _close(lev.cond.y, jlev.cond.y, 5e-6)


@pytest.mark.parametrize("k", [1, 2])
def test_cut64_matches_jax(mixed_levels, k):
    """cut64_condensed(keep_f64=True) on the port's float32 cut batch
    against JAX _cut64_impl on its own: S and bF within 1e-9 of the
    largest entry (measured 1.6e-12 at k=1, 7.6e-10 at k=2), X and y
    within 5e-6 (measured 7.9e-7: the sliver blocks' condition number
    times eps); the rounded copy is the float32 cast of the float64
    one."""
    lev, jlev = mixed_levels[k]
    hdi, eta = HHODegreeInfo(k + 1, k), fs.nitsche_eta(k)
    sub = fs.cut64_condensed(lev.batch, hdi, fs.default_problem(), eta,
                             True, keep_f64=True)
    jsub = jfs._cut64_impl(jlev.batch, hdi=JHHODegreeInfo(k + 1, k),
                           problem=jfs.default_problem(), eta=eta,
                           with_rhs=True, keep_f64=True)
    for name, a, b, tol in zip(sub._fields, sub, jsub,
                               (1e-9, 2e-9, 5e-6, 5e-6)):
        assert a.dtype == torch.float64, name
        _close(a, b, tol)
    low = fs.cut64_condensed(lev.batch, hdi, fs.default_problem(), eta, True)
    for a, b in zip(low, sub):
        assert torch.equal(a, b.float())


def _solve(name, **over):
    k, tol, kw = CASES[name]
    kw = dict(kw, **over)
    return fs.solve_fictdom_structured(
        N, k, cg_params=cg.CGParams(**_cgp(tol)), device=CPU, **kw)


@pytest.fixture(scope="module")
def jax_mixed_k2():
    """The JAX package's mixed_k2 solve, live: (iterations, exit code, H1
    error, local dofs)."""
    k, tol, kw = CASES["mixed_k2"]
    r = jfs.solve_fictdom_structured(N, k, use_pallas=False,
                                     cg_params=jcg.CGParams(**_cgp(tol)),
                                     **kw)
    return (int(r.iterations), int(r.exit_reason), float(r.h1_error),
            np.asarray(r.local))


def _held_to(r, gate, k):
    """A mixed solve against a JAX (iterations, exit code, H1): CG exit 0,
    iterations within 3, H1 within MIXED_H1_RTOL[k]."""
    iters, exit_code, h1 = gate[:3]
    assert r.exit_reason == exit_code == cg.CONVERGED
    assert abs(r.iterations - iters) <= 3
    assert np.isclose(r.h1_error, h1, rtol=MIXED_H1_RTOL[k]), \
        abs(r.h1_error / h1 - 1)


@pytest.mark.parametrize("name", ["mixed_k1", "mixed_k2", "mixed_cg32_k1"])
def test_mixed_solve_matches_jax(name, request):
    """mixed=True (with float64 CG by default, and with cg_f64=False)
    against the JAX package's solve at 16^2: below the tolerance, float32
    local dofs, and _held_to the stored numbers; at k=2 also to the live
    JAX solve (jax_mixed_k2), whose local dofs it meets within 1e-3 of
    max|local| (measured 2.8e-4; the mixed and the float64 solve differ
    by 1.2e-4-2.1e-4, so the H1 check is the one that tells them apart).
    MIXED_H1_RTOL says why each tolerance separates the mixed solve from
    the float64 one."""
    r = _solve(name)
    k = CASES[name][0]
    assert r.rel_residual < CASES[name][1]
    assert r.local.dtype == torch.float32
    _held_to(r, PRECISION_GATES[name], k)
    if name == "mixed_k2":
        live = request.getfixturevalue("jax_mixed_k2")
        _held_to(r, live, k)
        _close(r.local, live[3], 1e-3)


def test_mg_f32_matches_jax():
    """mg_f32=True (the float32 V-cycle around the float64 system and
    CG) at 16^2 k=2, tol 1e-11: iterations within 2 and H1 within rtol
    1e-6 of the JAX package's; the local dofs are float64 and within
    1e-8 of the all-float64 solve's (max|local| ~1)."""
    r = _solve("mg_f32_k2")
    iters, exit_code, h1 = PRECISION_GATES["mg_f32_k2"]
    assert r.exit_reason == exit_code == cg.CONVERGED
    assert r.local.dtype == torch.float64
    assert abs(r.iterations - iters) <= 2
    assert np.isclose(r.h1_error, h1, rtol=1e-6)
    ref = _solve("mg_f32_k2", mg_f32=False)
    assert float((r.local - ref.local).abs().max()) < 1e-8


@pytest.fixture(scope="module")
def _memoized_jax_transfers():
    """The JAX package's transfer-matrix builders memoized, as in
    tests/test_torch_multigrid.py (build_multigrid calls them again for
    every level)."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("_transfer_face_projectors", "_unit_recmap",
                     "_transfer_slot_matrices"):
            mp.setattr(jmg, name,
                       functools.lru_cache(maxsize=None)(getattr(jmg, name)))
        yield


def _flat(x):
    return np.concatenate([np.asarray(a, np.float64).ravel() for a in x])


def test_vcycle_f32_matches_jax(_memoized_jax_transfers):
    """The float32 V-cycle of mg_f32 (level_multigrid(dtype=float32) over
    float64 levels) against the JAX package's float32 build_multigrid, as
    _solve_jit builds it, on the port's lean 16^2 and 8^2 k=2 levels and
    one random residual. Both land within 3e-4 of the largest entry of
    each other (measured 6.1e-5), and the port's no farther from the
    float64 V-cycle than twice JAX's (measured 4.0e-5 against 5.0e-5:
    each float32 V-cycle's own rounding)."""
    k, fbs = 2, 3
    hdi, problem, eta = HHODegreeInfo(k + 1, k), fs.default_problem(), \
        fs.nitsche_eta(k)
    levels = {N: fs.build_level(N, hdi, problem, eta, 4, device=CPU,
                                fitted="lean", with_rhs=False)}
    levels.update(fs.build_coarse_levels(N, hdi, problem, eta, 4,
                                         device=CPU, fitted="lean",
                                         mg_coarsest=8))
    rng = np.random.default_rng(7)
    jr = jcl.GridVecCL(
        jnp.asarray(rng.standard_normal((fbs, N + 1, N)), jnp.float32),
        jnp.asarray(rng.standard_normal((fbs, N, N + 1)), jnp.float32))
    r = convert.grid_vec_cl(jr, CPU)
    m32 = fs.level_multigrid(levels, hdi, dtype=torch.float32)
    m64 = fs.level_multigrid(levels, hdi)
    z32 = m32.precondition(r)
    assert all(a.dtype == torch.float32 for a in z32)
    z64 = _flat(m64.precondition(cg._map(lambda a: a.double(), r)))
    jm = jmg.build_multigrid(
        N, fbs, {n: jnp.asarray(fs._level_S(lev).numpy(), jnp.float32)
                 for n, lev in levels.items()},
        hdi=JHHODegreeInfo(k + 1, k), coarsest=8, n_smooth=1,
        cut_ids_per_level={n: fs.expand_ring(lev.cut_ids, n, 1)
                           for n, lev in levels.items()},
        smoother="chebyshev", layout="cl",
        uniform_per_level={n: (lev.S_u.numpy(), lev.irr_ids)
                           for n, lev in levels.items()})
    jz = _flat(jm.precondition(jr))
    scale = np.abs(z64).max()
    port, jax_ = np.abs(_flat(z32) - z64).max(), np.abs(jz - z64).max()
    assert np.abs(_flat(z32) - jz).max() <= 3e-4 * scale
    assert port <= 2 * jax_, (port / scale, jax_ / scale)


def _jax_segments(system, params, segment):
    """JAX solve_segments' host loop (proton_tpu/cut/fictdom_structured.py,
    its per-segment branch) over the JAX package's CG on ``system``:
    warm-started segments, the first residual's norm in every exit test,
    summed counts."""
    jA, _, jpre, _, (jb, _), _ = system
    seg = jcg.CGParams(**dict(params, max_iter=segment))
    nr0 = jnp.sqrt(sum(jnp.vdot(a, a) for a in jb))
    x, total = None, 0
    while True:
        res = jcg.conjugated_gradient(jA, jb, None, seg, precond=jpre,
                                      x0=x, nr0=nr0)
        x, total = res.x, total + int(res.iterations)
        if int(res.exit_reason) in (jcg.CONVERGED, jcg.DIVERGED) or \
                total >= params["max_iter"]:
            return res, total


def test_segmented_cg_matches_jax():
    """segmented_cg (segments of 5) against JAX solve_segments' loop on
    the random SPD system of the CG tests: converged, equal summed count
    and exit code (58), residual rtol 1e-6, x within 1e-12 (measured
    2e-16)."""
    system = _spd_system(3)
    params = dict(convergence_threshold=1e-9, divergence_threshold=1e8,
                  max_iter=1000, apply_preconditioner=True)
    jres, jtotal = _jax_segments(system, params, 5)
    _, A, _, pre, (_, b), _ = system
    res = fs.segmented_cg(A, b, None, cg.CGParams(**params), 5, precond=pre)
    assert res.exit_reason == int(jres.exit_reason) == cg.CONVERGED
    assert res.iterations == jtotal
    np.testing.assert_allclose(res.rel_residual, float(jres.rel_residual),
                               rtol=1e-6)
    for a, c in zip(res.x, jres.x):
        _close(a, c, 1e-12)


def test_cg_float32_matches_jax():
    """Float32 CG (the mixed system's cg_f64=False) against the JAX
    package's on a float32 random SPD system with block-Jacobi: converged
    at tol 1e-5, iterations within 2 (measured equal, 26), float32 x
    within 1e-5 of the largest entry (measured 2.6e-7: XLA and torch
    round float32 in different orders)."""
    params = dict(convergence_threshold=1e-5, divergence_threshold=1e8,
                  max_iter=1000, apply_preconditioner=True)
    jr, r = _cg_pair(_spd_system(3, dtype=np.float32), params)
    assert r.exit_reason == int(jr.exit_reason) == cg.CONVERGED
    assert abs(r.iterations - int(jr.iterations)) <= 2
    for a, c in zip(r.x, jr.x):
        assert a.dtype == torch.float32 and c.dtype == jnp.float32
        _close(a, c, 1e-5)


def test_segmented_solve_matches_jax_and_plain():
    """cg_segment=4 at 16^2 k=1, tol 1e-10: converged, H1 within rtol
    1e-9 of the JAX package's segmented solve and of the port's
    unsegmented one (tests/test_fictdom_structured.py:196-208), the
    count within 2 of JAX's."""
    r = _solve("segment4_k1")
    iters, exit_code, h1 = PRECISION_GATES["segment4_k1"]
    assert r.exit_reason == exit_code == cg.CONVERGED
    assert r.rel_residual < 1e-10
    assert abs(r.iterations - iters) <= 2
    assert np.isclose(r.h1_error, h1, rtol=1e-9)
    plain = _solve("segment4_k1", cg_segment=0)
    assert np.isclose(r.h1_error, plain.h1_error, rtol=1e-9)


def test_lean_mixed_matches_dense_mixed():
    """test_lean_mixed_matches_dense_mixed's gates at 16^2 k=2, tol 1e-9:
    the port's fitted="uniform" mixed system is its lean one, equal bit
    for bit (JAX's two differ by 5e-6, within that test's rtol 1e-4), and
    within 2e-2 of the port's float64 H1 (the lean mixed solve is held to
    JAX's in test_mixed_solve_matches_jax). The fully assembled mixed
    system (K1 in float32 on every cell) carries the float32 assembly's
    noise, the H1 gap to float64 itself (measured 4.2%, JAX's own 4.9%):
    converged, float32, H1 below the JAX test_fictdom_mixed_precision
    bound, 5e-3, and within rtol 2e-2 of the JAX package's fitted="full"
    mixed H1 (measured 6e-3: the float32 rounding of each cell differs,
    test_mixed_full_level_matches_jax)."""
    lean = _solve("mixed_k2")
    uniform = _solve("mixed_k2", fitted="uniform")
    assert torch.equal(lean.local, uniform.local)
    ref = _solve("mixed_k2", mixed=False)
    assert np.isclose(lean.h1_error, ref.h1_error, rtol=2e-2)
    full = _solve("mixed_full_k2")
    assert full.exit_reason == cg.CONVERGED and full.h1_error < 5e-3
    assert full.local.dtype == torch.float32
    assert np.isclose(full.h1_error, PRECISION_GATES["mixed_full_k2"][2],
                      rtol=2e-2)


def test_default_k2_solve_is_mixed_false():
    """The port's default at k=2 is float64 (mixed=None means False at
    every degree, where the JAX package turns it on at k >= 2): the
    default solve equals mixed=False bit for bit. cg_segment < 0 raises
    ValueError."""
    kw = dict(cg_params=cg.CGParams(**_cgp(1e-9)), device=CPU)
    r = fs.solve_fictdom_structured(N, 2, **kw)
    r0 = fs.solve_fictdom_structured(N, 2, mixed=False, **kw)
    assert r.local.dtype == torch.float64
    assert r.iterations == r0.iterations and torch.equal(r.local, r0.local)
    with pytest.raises(ValueError, match="cg_segment"):
        fs.solve_fictdom_structured(8, 1, cg_segment=-1, device=CPU)
