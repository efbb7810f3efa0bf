"""The pieces of the port's precision modes against proton_tpu on the
CPU: CG's warm start (x0, nr0), residual replacement, progress line,
segments and float32 run on random SPD systems; the float32
classification; the row-major condensed batch and its float32 splice; the
fully assembled mixed level; and the float32 V-cycle. The end-to-end
solves of every mode, and the lean mixed level they build, are in
tests/test_torch_precision.py.

The JAX package's side of each comparison is read from
tests/jax_refs/test_torch_precision_pieces.npz (REFS below;
tests/torch_jax_reference.py writes it, running the JAX package on the
same inputs): CG eager (its loop is one lax.while_loop), the level build
as the JAX package runs it, the float32 V-cycle under jax.jit (on the
port's levels: the store keeps the digest of those inputs)."""

import numpy as np
import jax
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
from torch_jax_reference import Refs

CPU = torch.device("cpu")
N = 16
REFS = Refs(__name__)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """BLAS and torch on one thread (see tests/test_torch_solve.py)."""
    with threadpoolctl.threadpool_limits(1):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)


def _close(a, ref, tol):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    ref = np.asarray(ref)
    assert a.shape == ref.shape
    err = np.max(np.abs(a.astype(np.float64) - ref.astype(np.float64)))
    assert err <= tol * np.max(np.abs(ref)), err / np.max(np.abs(ref))


def _spd_system(seed, Nx=9, Ny=8, fbs=2, dtype=np.float64, jax_side=False):
    """A random SPD cells-last system on an Nx x Ny face grid, in
    ``dtype``: (JAX operator, port operator, JAX block-Jacobi, port
    block-Jacobi, a random JAX grid vector and its port copy, a second
    pair). The JAX operators are None unless ``jax_side``; the port's are
    None if it is."""
    rng = np.random.default_rng(seed)
    nfd, C = 4 * fbs, Nx * Ny
    B = rng.standard_normal((C, nfd, nfd))
    S = np.transpose(B @ np.transpose(B, (0, 2, 1)) + 0.05 * np.eye(nfd),
                     (1, 2, 0)).reshape(nfd * nfd, C).astype(dtype)

    def grids():
        j = jcl.GridVecCL(*(jnp.asarray(rng.standard_normal(shape), dtype)
                            for shape in ((fbs, Ny + 1, Nx),
                                          (fbs, Ny, Nx + 1))))
        return j, convert.grid_vec_cl(j, CPU)

    if jax_side:
        jsys = jstructured.make_structured_system(Nx, Ny, fbs)
        return (jcl.make_structured_operator_cl(jsys, jnp.asarray(S)), None,
                jcl.block_jacobi_preconditioner_cl(jsys, jnp.asarray(S)),
                None, grids(), grids())
    tsys = structured.make_structured_system(Nx, Ny, fbs, device=CPU)
    return (None,
            cells_last.make_structured_operator_cl(tsys, torch.as_tensor(S)),
            None,
            cells_last.block_jacobi_preconditioner_cl(tsys,
                                                      torch.as_tensor(S)),
            grids(), grids())


def _jax_cg(system, params, **warm):
    """The JAX package's CG on ``system`` (built with jax_side) from the
    start ``warm`` (x0 as a (JAX, port) pair or a JAX grid, nr0)."""
    jA, _, jpre, _, (jb, _), _ = system
    jwarm = {k: (v[0] if isinstance(v, tuple) else v)
             for k, v in warm.items()}
    r = jcg.conjugated_gradient(jA, jb, None, jcg.CGParams(**params),
                                precond=jpre, **jwarm)
    return dict(x=r.x, iterations=r.iterations, exit_reason=r.exit_reason,
                rel_residual=r.rel_residual)


def _port_cg(system, params, **warm):
    """The port's CG on ``system`` from the start ``warm``."""
    _, A, _, pre, (_, b), _ = system
    twarm = {k: (v[1] if isinstance(v, tuple) else v)
             for k, v in warm.items()}
    return cg.conjugated_gradient(A, b, None, cg.CGParams(**params),
                                  precond=pre, **twarm)


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


WARM_PARAMS = dict(convergence_threshold=1e-9, divergence_threshold=1e8,
                   max_iter=1000, apply_preconditioner=True)


def _jax_warm_start(nr0):
    """The JAX package's CG runs of test_cg_warm_start_matches_jax: from
    the system's second random grid (with nr0), then two segments of 5,
    the second from the first's x with the first residual's norm."""
    system = _spd_system(3, jax_side=True)
    x0 = system[5]
    warm = dict(x0=x0) if nr0 is None else dict(x0=x0, nr0=nr0)
    seg = dict(WARM_PARAMS, max_iter=5)
    first = _jax_cg(system, seg)
    jnr0 = float(np.sqrt(sum(float(jnp.vdot(a, a)) for a in system[4][0])))
    return dict(warm=_jax_cg(system, WARM_PARAMS, **warm), first=first,
                second=_jax_cg(system, seg, x0=(first["x"], None),
                               nr0=jnr0))


for _nr0 in (None, 3.0):
    REFS.add(f"cg_warm_start[{_nr0}]", "solve",
             f"conjugated_gradient(x0=, nr0={_nr0}) on the random SPD system "
             f"of seed 3 with block-Jacobi, tol 1e-9; then two segments of "
             f"5", _jax_warm_start, seed=3, nr0=_nr0)


@pytest.mark.parametrize("nr0", [None, 3.0])
def test_cg_warm_start_matches_jax(nr0):
    """conjugated_gradient(x0=, nr0=) against the JAX package's on a
    random SPD system with block-Jacobi: from a random x0 (the first
    residual is b - A x0), with the start's own norm (nr0=None) or a
    caller's nr0 in the exit tests: _same_cg, x within 1e-10. Then two
    segments of 5: the second warm-started from the first's x with the
    first residual's norm, as the segmented solve chains them."""
    system = _spd_system(3)
    params = WARM_PARAMS
    x0 = system[5]
    warm = dict(x0=x0) if nr0 is None else dict(x0=x0, nr0=nr0)
    ref = REFS[f"cg_warm_start[{nr0}]"]
    jr, r = ref.warm, _port_cg(system, params, **warm)
    assert r.exit_reason == cg.CONVERGED
    _same_cg(jr, r)

    seg = dict(params, max_iter=5)
    r1 = _port_cg(system, seg)
    assert r1.exit_reason == cg.MAX_ITER_REACHED and r1.iterations == 7
    jnr0 = float(np.sqrt(sum(float(jnp.vdot(a, a)) for a in system[4][0])))
    r2 = _port_cg(system, seg, x0=(None, r1.x), nr0=jnr0)
    _same_cg(ref.second, r2, 1e-9)


def _jax_recompute_every():
    system = _spd_system(4, jax_side=True)
    params = dict(convergence_threshold=1e-10, divergence_threshold=1e8,
                  max_iter=1000, apply_preconditioner=True,
                  recompute_every=3)
    return _jax_cg(system, params)


REFS.add("cg_recompute_every", "solve",
         "conjugated_gradient(recompute_every=3) on the random SPD system "
         "of seed 4 with block-Jacobi, tol 1e-10", _jax_recompute_every,
         seed=4)


def test_cg_recompute_every_matches_jax():
    """CGParams.recompute_every=3 (the recurred residual replaced by
    b - A x every 3 iterations) against the JAX package's: _same_cg, x
    within 1e-10; and it converges to the plain run's x."""
    system = _spd_system(4)
    params = dict(convergence_threshold=1e-10, divergence_threshold=1e8,
                  max_iter=1000, apply_preconditioner=True,
                  recompute_every=3)
    jr, r = REFS["cg_recompute_every"], _port_cg(system, params)
    assert r.exit_reason == cg.CONVERGED
    _same_cg(jr, r)
    plain = _port_cg(system, dict(params, recompute_every=0))
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


def _jax_classify_f32():
    jmesh, jcd, jcut = jfs.classify_level(N, jfs.default_problem(), 4, False,
                                          classify_f32=True)
    return dict(points=jmesh.points, cut=jcut,
                cd={name: getattr(jcd, name) for name in
                    ("cell_loc", "node_loc", "face_loc", "distorted")})


REFS.add("classify_f32", "classification",
         "classify_level(16, default_problem(), 4, False, classify_f32=True)",
         _jax_classify_f32)


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
    ref = REFS["classify_f32"]
    jmesh, jcd, jcut = ref, ref.cd, ref.cut
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


def _row_major_inputs():
    """The random SPD cells, their right-hand sides, and the generator
    that draws the splice's target batch and ids after them."""
    rng = np.random.default_rng(7)
    C, cbs, nfd = 11, 6, 8
    d = cbs + nfd
    B = rng.standard_normal((C, d, d))
    lc = B @ np.transpose(B, (0, 2, 1)) + d * np.eye(d)
    f = rng.standard_normal((C, cbs))
    return rng, lc, f, cbs


def _splice_inputs(rng, rows, C, Cb=40):
    """The float32 target batch (one random [rows[i], Cb] array per field)
    and the sorted ids of the splice."""
    big = [rng.standard_normal((n, Cb)).astype(np.float32) for n in rows]
    return big, np.sort(rng.choice(Cb, C, replace=False))


def _jax_row_major():
    """JAX from_row_major(condense(...)) of the random cells, and its
    set_cells of that batch, cast to float32, into the random target."""
    rng, lc, f, cbs = _row_major_inputs()
    jsub = jcl.from_row_major(jcond.condense(jnp.asarray(lc), jnp.asarray(f),
                                             cbs, robust=True))
    big, ids = _splice_inputs(rng, [a.shape[0] for a in jsub], len(lc))
    jout = jcl.set_cells(jcl.CondensedCL(*(jnp.asarray(a) for a in big)),
                         jnp.asarray(ids),
                         jcl.CondensedCL(*(a.astype(jnp.float32)
                                           for a in jsub)))
    return dict(sub=tuple(jsub), out=tuple(jout))


REFS.add("row_major", "operator",
         "from_row_major(condense(lc, f, 6, robust=True)) on 11 random SPD "
         "cells of size 14, and set_cells of it (float32) into a random "
         "[., 40] batch", _jax_row_major, seed=7)


def test_from_row_major_and_set_cells_match_jax():
    """cells_last.from_row_major (the back-substitution operators of a
    row-major condensed batch) and set_cells (its splice, cast to the
    system's dtype) against the JAX package's on random SPD cells, 1e-12;
    the float32 splice equals JAX's rounding of the same columns."""
    rng, lc, f, cbs = _row_major_inputs()
    C = len(lc)
    sub = cells_last.from_row_major(condensation.condense(
        torch.as_tensor(lc), torch.as_tensor(f), cbs, robust=True))
    ref = REFS["row_major"]
    for a, b in zip(sub, ref.sub):
        _close(a, b, 1e-12)
    big, ids = _splice_inputs(rng, [a.shape[0] for a in sub], C)
    big = cells_last.CondensedCL(*(torch.as_tensor(a) for a in big))
    out = cells_last.set_cells(big, torch.as_tensor(ids), sub)
    assert out is big
    for a, b in zip(out, ref.out):
        assert a.dtype == torch.float32
        _close(a, b, 1e-6)


def _jax_mixed_full_level():
    k = 2
    jlev = jfs.build_level(N, JHHODegreeInfo(k + 1, k), jfs.default_problem(),
                           jfs.nitsche_eta(k), 4, True, use_pallas=False,
                           with_rhs=True, fitted="full")
    return dict(cut_ids=jlev.cut_ids,
                cond={f: getattr(jlev.cond, f) for f in ("S", "bF", "X", "y")})


REFS.add("mixed_full_level", "level",
         "build_level(16, HHODegreeInfo(3, 2), default_problem(), "
         "nitsche_eta(2), 4, True, use_pallas=False, with_rhs=True, "
         "fitted='full')", _jax_mixed_full_level)


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
    jlev = REFS["mixed_full_level"]
    assert all(a.dtype == torch.float32 for a in lev.cond)
    assert np.array_equal(lev.cut_ids, np.asarray(jlev.cut_ids))
    S, jS = lev.cond.S.numpy(), np.asarray(jlev.cond.S)
    cut = lev.cut_ids
    assert np.abs(S[:, cut] - jS[:, cut]).max() <= 1e-6 * np.abs(jS).max()
    _close(S, jS, 2e-5)
    _close(lev.cond.bF, jlev.cond.bF, 1e-6)
    _close(lev.cond.X, jlev.cond.X, 5e-6)
    _close(lev.cond.y, jlev.cond.y, 5e-6)


def _flat(x):
    return np.concatenate([np.asarray(a, np.float64).ravel() for a in x])


def _vcycle_f32_inputs():
    """The port's lean 16^2 and 8^2 k=2 levels (float64) and the random
    float32 residual (JAX) of test_vcycle_f32_matches_jax."""
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
    return levels, jr


def _vcycle_f32_jax_args(levels):
    """What the JAX V-cycle reads of the port's levels: per size, S as
    float32, S_u, irr_ids and the patch cells."""
    sizes = sorted(levels)
    return sizes, dict(
        S=[np.asarray(fs._level_S(levels[n]).numpy(), np.float32)
           for n in sizes],
        S_u=[levels[n].S_u.numpy() for n in sizes],
        irr=[np.asarray(levels[n].irr_ids) for n in sizes],
        cuts=[fs.expand_ring(levels[n].cut_ids, n, 1) for n in sizes])


def _jax_vcycle_f32():
    """The JAX package's float32 build_multigrid, as _solve_jit builds
    it (under jax.jit), over the port's lean 16^2 and 8^2 k=2 levels,
    applied to the random residual; with the digest of those inputs."""
    k, fbs = 2, 3
    levels, jr = _vcycle_f32_inputs()
    sizes, args = _vcycle_f32_jax_args(levels)

    def jax_vcycle(S_list, r):
        return jmg.build_multigrid(
            N, fbs, dict(zip(sizes, S_list)), hdi=JHHODegreeInfo(k + 1, k),
            coarsest=8, n_smooth=1,
            cut_ids_per_level=dict(zip(sizes, args["cuts"])),
            smoother="chebyshev", layout="cl",
            uniform_per_level={n: (S_u, irr) for n, S_u, irr in
                               zip(sizes, args["S_u"], args["irr"])}
        ).precondition(r)

    jz = jax.jit(jax_vcycle)([jnp.asarray(S) for S in args["S"]], jr)
    return dict(inputs=_flat_inputs(args, jr), jz=_flat(jz))


def _flat_inputs(args, jr):
    return [a for v in args.values() for a in v] + list(jr)


REFS.add("vcycle_f32", "vcycle",
         "build_multigrid(16, 3, {16: S, 8: S} as float32, HHODegreeInfo(3, "
         "2), coarsest=8, n_smooth=1, smoother='chebyshev', layout='cl', "
         "uniform_per_level=...).precondition(r) under jax.jit, over the "
         "port's lean 16^2 / 8^2 k=2 levels (inputs digest stored)",
         _jax_vcycle_f32, seed=7)


def test_vcycle_f32_matches_jax():
    """The float32 V-cycle of mg_f32 (level_multigrid(dtype=float32) over
    float64 levels) against the JAX package's float32 build_multigrid, as
    _solve_jit builds it (under jax.jit), on the port's lean 16^2 and 8^2
    k=2 levels and one random residual. Both land within 3e-4 of the largest entry of
    each other (measured 6.1e-5), and the port's no farther from the
    float64 V-cycle than twice JAX's (measured 4.0e-5 against 5.0e-5:
    each float32 V-cycle's own rounding)."""
    k = 2
    hdi = HHODegreeInfo(k + 1, k)
    levels, jr = _vcycle_f32_inputs()
    r = convert.grid_vec_cl(jr, CPU)
    m32 = fs.level_multigrid(levels, hdi, dtype=torch.float32)
    m64 = fs.level_multigrid(levels, hdi)
    z32 = m32.precondition(r)
    assert all(a.dtype == torch.float32 for a in z32)
    z64 = _flat(m64.precondition(cg._map(lambda a: a.double(), r)))
    _, args = _vcycle_f32_jax_args(levels)
    jz = REFS.get("vcycle_f32", inputs=_flat_inputs(args, jr)).jz
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


SEGMENT_PARAMS = dict(convergence_threshold=1e-9, divergence_threshold=1e8,
                      max_iter=1000, apply_preconditioner=True)


def _jax_segmented():
    res, total = _jax_segments(_spd_system(3, jax_side=True),
                               SEGMENT_PARAMS, 5)
    return dict(x=res.x, exit_reason=res.exit_reason,
                rel_residual=res.rel_residual, total=total)


REFS.add("segmented_cg", "solve",
         "solve_segments' host loop: conjugated_gradient in segments of 5, "
         "warm-started, on the random SPD system of seed 3 with "
         "block-Jacobi, tol 1e-9", _jax_segmented, seed=3)


def test_segmented_cg_matches_jax():
    """segmented_cg (segments of 5) against JAX solve_segments' loop on
    the random SPD system of the CG tests: converged, equal summed count
    and exit code (58), residual rtol 1e-6, x within 1e-12 (measured
    2e-16)."""
    system = _spd_system(3)
    params = SEGMENT_PARAMS
    jres = REFS["segmented_cg"]
    jtotal = jres.total
    _, A, _, pre, (_, b), _ = system
    res = fs.segmented_cg(A, b, None, cg.CGParams(**params), 5, precond=pre)
    assert res.exit_reason == int(jres.exit_reason) == cg.CONVERGED
    assert res.iterations == jtotal
    np.testing.assert_allclose(res.rel_residual, float(jres.rel_residual),
                               rtol=1e-6)
    for a, c in zip(res.x, jres.x):
        _close(a, c, 1e-12)


FLOAT32_PARAMS = dict(convergence_threshold=1e-5, divergence_threshold=1e8,
                      max_iter=1000, apply_preconditioner=True)
REFS.add("cg_float32", "solve",
         "conjugated_gradient on the float32 random SPD system of seed 3 "
         "with block-Jacobi, tol 1e-5",
         lambda: _jax_cg(_spd_system(3, dtype=np.float32, jax_side=True),
                         FLOAT32_PARAMS), seed=3)


def test_cg_float32_matches_jax():
    """Float32 CG (the mixed system's cg_f64=False) against the JAX
    package's on a float32 random SPD system with block-Jacobi: converged
    at tol 1e-5, iterations within 2 (measured equal, 26), float32 x
    within 1e-5 of the largest entry (measured 2.6e-7: XLA and torch
    round float32 in different orders)."""
    params = FLOAT32_PARAMS
    jr = REFS["cg_float32"]
    r = _port_cg(_spd_system(3, dtype=np.float32), params)
    assert r.exit_reason == int(jr.exit_reason) == cg.CONVERGED
    assert abs(r.iterations - int(jr.iterations)) <= 2
    for a, c in zip(r.x, jr.x):
        assert a.dtype == torch.float32 and c.dtype == jnp.float32
        _close(a, c, 1e-5)
