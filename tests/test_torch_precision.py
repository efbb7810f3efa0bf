"""The port's precision modes against proton_tpu on the CPU: the
mixed-precision level (the float32 system with the float64 cut class
spliced in) and its cut class, and the solves of every mode at 16^2. The
pieces of the modes (CG's warm start, segments and float32 run, the
float32 classification, the row-major splice, the fully assembled mixed
level, the float32 V-cycle) are in tests/test_torch_precision_pieces.py.

The JAX package's side of each comparison is read from
tests/jax_refs/test_torch_precision.npz (REFS below;
tests/torch_jax_reference.py writes it, running the JAX package alone on
the same inputs): the level builds, the cut class and one end-to-end
mixed solve (k=2, where the mixed system's H1 error differs from the
float64 one by 3e-3: the JAX package's _solve_jit over its mixed levels,
the fine one that of the level tests). The other end-to-end solves are
held, in addition, to the JAX package's numbers in PRECISION_GATES, from
scripts/precision_jax_gates.py: each case there also has a check of its
pieces here or in test_torch_precision_pieces.py."""

import functools

import numpy as np
import pytest
import threadpoolctl
import torch

from proton_tpu.core.ops import HHODegreeInfo as JHHODegreeInfo
from proton_tpu.cut import fictdom_structured as jfs
from proton_tpu.solvers import cg as jcg
from proton_tpu_torch.core.ops import HHODegreeInfo
from proton_tpu_torch.cut import fictdom_structured as fs
from proton_tpu_torch.solvers import cg
from torch_jax_reference import Refs, jax_solve_ref

CPU = torch.device("cpu")
N = 16
REFS = Refs(__name__)

# The JAX package, CPU, x64, solve_fictdom_structured(16, k, ...,
# use_pallas=False), divergence 1e8, max_iter 50000: (iterations, exit
# code, H1 error), from scripts/precision_jax_gates.py, which names each
# case's degree, tolerance and keywords. The live check of each case's
# pieces: mixed_k1, the level and its cut class (test_mixed_level_matches_
# jax, test_cut64_matches_jax); mixed_k2, the JAX solve itself
# (jax_mixed_k2); in tests/test_torch_precision_pieces.py: mixed_cg32_k1,
# float32 CG (test_cg_float32_matches_jax); mixed_full_k2, the fully
# assembled level (test_mixed_full_level_matches_jax); mg_f32_k2, the
# float32 V-cycle (test_vcycle_f32_matches_jax); segment4_k1, the segment
# loop (test_segmented_cg_matches_jax).
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


@functools.lru_cache(maxsize=None)
def _jax_mixed_level(k):
    """The JAX package's lean mixed 16^2 level, with its right-hand side
    (build_level(mixed=True, fitted="lean"))."""
    return jfs.build_level(N, JHHODegreeInfo(k + 1, k), jfs.default_problem(),
                           jfs.nitsche_eta(k), 4, True, use_pallas=False,
                           with_rhs=True, fitted="lean")


def _jax_mixed_level_fields(k):
    lev = _jax_mixed_level(k)
    return dict(irr_ids=lev.irr_ids, cut_ids=lev.cut_ids,
                cond={f: getattr(lev.cond, f)
                      for f in ("dS", "fT", "bF", "X_i", "y_i")})


def _jax_cut64(k):
    """JAX _cut64_impl(keep_f64=True) on its mixed level's cut batch."""
    return tuple(jfs._cut64_impl(
        _jax_mixed_level(k).batch, hdi=JHHODegreeInfo(k + 1, k),
        problem=jfs.default_problem(), eta=jfs.nitsche_eta(k),
        with_rhs=True, keep_f64=True))


for _k in (1, 2):
    REFS.add(f"mixed_level[{_k}]", "level",
             f"build_level(16, HHODegreeInfo({_k + 1}, {_k}), "
             f"default_problem(), nitsche_eta({_k}), 4, True, "
             f"use_pallas=False, with_rhs=True, fitted='lean')",
             _jax_mixed_level_fields, k=_k)
    REFS.add(f"cut64[{_k}]", "cut class",
             f"_cut64_impl(level.batch, HHODegreeInfo({_k + 1}, {_k}), "
             f"default_problem(), nitsche_eta({_k}), with_rhs=True, "
             f"keep_f64=True) on mixed_level[{_k}]'s batch", _jax_cut64,
             k=_k)


@pytest.fixture(scope="module")
def mixed_levels():
    """{k: (the port's, the JAX package's stored lean mixed 16^2 level)},
    with right-hand sides (JAX: build_level(mixed=True, fitted="lean"))."""
    return {k: (fs.build_level(N, HHODegreeInfo(k + 1, k),
                               fs.default_problem(), fs.nitsche_eta(k), 4,
                               device=CPU, fitted="lean", mixed=True),
                REFS[f"mixed_level[{k}]"])
            for k in (1, 2)}


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


@pytest.mark.parametrize("k", [1, 2])
def test_cut64_matches_jax(mixed_levels, k):
    """cut64_condensed(keep_f64=True) on the port's float32 cut batch
    against JAX _cut64_impl on its own: S and bF within 1e-9 of the
    largest entry (measured 1.6e-12 at k=1, 7.6e-10 at k=2), X and y
    within 5e-6 (measured 7.9e-7: the sliver blocks' condition number
    times eps); the rounded copy is the float32 cast of the float64
    one."""
    lev, _ = mixed_levels[k]
    hdi, eta = HHODegreeInfo(k + 1, k), fs.nitsche_eta(k)
    sub = fs.cut64_condensed(lev.batch, hdi, fs.default_problem(), eta,
                             True, keep_f64=True)
    jsub = REFS[f"cut64[{k}]"]
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


# The multigrid levels of the live mixed k=2 comparison: the fine level
# alone (mg_coarsest=N), its V-cycle the smoothers around the coarsest
# factor. The mixed system, which the comparison tells from the float64
# one, is the fine level's at any depth; the two-level solve is held to
# the stored PRECISION_GATES number. A second level costs the JAX side a
# coarse level build and a V-cycle four times the size (72 s against
# 11 s of compiling on one CPU core).
LIVE_MG_COARSEST = N


def _jax_mixed_k2():
    """The JAX package's mixed_k2 solve with mg_coarsest=LIVE_MG_COARSEST
    over the mixed level of _jax_mixed_level (the one its
    solve_fictdom_structured builds)."""
    k, tol, kw = CASES["mixed_k2"]
    assert kw == dict(mixed=True, fitted="lean")
    return jax_solve_ref({N: _jax_mixed_level(k)}, k,
                         jcg.CGParams(**_cgp(tol)),
                         keep=("local", "iterations", "exit_reason", "h1"),
                         mg_coarsest=LIVE_MG_COARSEST)


REFS.add("mixed_k2", "solve",
         "solve_fictdom_structured(16, 2, mixed=True, fitted='lean', "
         "mg_coarsest=16, use_pallas=False), CG tol 1e-9: _solve_jit over "
         "mixed_level[2]", _jax_mixed_k2)


@pytest.fixture(scope="module")
def jax_mixed_k2():
    """The JAX package's stored mixed_k2 solve with
    mg_coarsest=LIVE_MG_COARSEST: (iterations, exit code, H1 error, local
    dofs)."""
    local, iters, exit_code, h1 = REFS["mixed_k2"]
    return iters, exit_code, h1, np.asarray(local)


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
    local dofs, and _held_to the stored numbers; at k=2 the same solve
    with mg_coarsest=LIVE_MG_COARSEST also to the live JAX solve
    (jax_mixed_k2), whose local dofs it meets within 1e-3 of max|local|
    (measured 1.2e-4 on one level, 2.8e-4 on two; the mixed and the
    float64 solve differ by 1.2e-4-2.1e-4, so the H1 check is the one
    that tells them apart: on one level 3.7e-4 from JAX's mixed H1, and
    the float64 solve 3.4e-3), in as many iterations (3). MIXED_H1_RTOL
    says why each tolerance separates the mixed solve from the float64
    one."""
    r = _solve(name)
    k = CASES[name][0]
    assert r.rel_residual < CASES[name][1]
    assert r.local.dtype == torch.float32
    _held_to(r, PRECISION_GATES[name], k)
    if name == "mixed_k2":
        live = request.getfixturevalue("jax_mixed_k2")
        r = _solve(name, mg_coarsest=LIVE_MG_COARSEST)
        assert r.rel_residual < CASES[name][1]
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
