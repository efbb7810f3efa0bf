"""The multigrid options the JAX package keeps off by default, ported in
proton_tpu_torch, against proton_tpu on the CPU, float64: the cut-aware
transfer correction (prolongation, restriction, their adjointness), the
reconstruction-map deviations of a coarse level, the interface-band
deflation, one V-cycle apply for each option (cheb_ops 'mixed' and
'uniform', mg_transfer 'smoothed' and 'cut', mg_deflate=4) over the JAX
package's own 16^2 and 8^2 lean levels, and the end-to-end 16^2 solves;
then the family app in float32 (PROTON_TPU_X64=0) against the JAX app
run in a subprocess (this process keeps JAX's x64 on), and the
ValueErrors where the JAX package ignores an option (the bench's knobs:
tests/test_torch_bench.py).

The JAX package's transfer builders (_transfer_slot_matrices,
_transfer_face_projectors, _unit_recmap) are handed the port's, computed
once per (degree, h): tests/test_torch_multigrid.py holds them to the JAX
package's to 1e-12, and the JAX package's own take seconds of eager
compilation per call. Every JAX V-cycle and solve runs under jax.jit,
the solves through its _solve_jit over levels built once. BLAS and torch
run on one thread."""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import threadpoolctl
import torch

from proton_tpu.cut import fictdom_structured as jfs
from proton_tpu.core.geometry import cell_geometry as jcell_geometry
from proton_tpu.core.ops import HHODegreeInfo as JHHODegreeInfo
from proton_tpu.methods import assembly as jassembly
from proton_tpu.methods import cells_last as jcl, structured as jstructured
from proton_tpu.solvers import cg as jcg, multigrid as jmg
from proton_tpu_torch import convert
from proton_tpu_torch.apps import fictdom_family
from proton_tpu_torch.core.ops import HHODegreeInfo
from proton_tpu_torch.cut import batched
from proton_tpu_torch.cut import fictdom_structured as fs
from proton_tpu_torch.methods import cells_last, structured
from proton_tpu_torch.solvers import cg, multigrid

CPU = torch.device("cpu")
F64 = torch.float64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The family app's arguments for the float32 comparison.
FAMILY_ARGS = ["-N", "32", "-k", "1", "-B", "2"]

# The V-cycle options, as solve_fictdom_structured keywords.
OPTIONS = {"cheb_mixed": dict(cheb_ops="mixed"),
           "cheb_uniform": dict(cheb_ops="uniform"),
           "smoothed": dict(mg_transfer="smoothed"),
           "cut": dict(mg_transfer="cut"), "deflate": dict(mg_deflate=4)}


@functools.lru_cache(maxsize=None)
def _port_arrays(name, cell_degree, face_degree, h):
    """The port's transfer builder ``name`` at (degree, h) as numpy."""
    hdi = HHODegreeInfo(cell_degree, face_degree)
    fn = getattr(multigrid, name)
    out = fn(hdi, h, F64, device=CPU) if name == "_transfer_slot_matrices" \
        else fn(hdi, h, device=CPU)
    return tuple(a.numpy() for a in out) if isinstance(out, tuple) \
        else out.numpy()


def _for_jax(name):
    """The JAX package's builder ``name`` answered by the port's arrays
    (fresh JAX arrays each call, so that none is cached inside a trace)."""
    def fn(hdi, h, dtype=None):
        out = _port_arrays(name, hdi.cell_degree, hdi.face_degree, float(h))
        if isinstance(out, tuple):
            return tuple(jnp.asarray(a, dtype) for a in out)
        return jnp.asarray(out, dtype)
    return fn


def _jax_family(x64: str):
    """The JAX app with FAMILY_ARGS in a subprocess (x64 as given)."""
    env = dict(os.environ, PROTON_TPU_X64=x64, JAX_PLATFORMS="cpu",
               PROTON_TPU_PLATFORM="cpu",
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    return subprocess.Popen(
        [sys.executable, "-m", "proton_tpu.apps.fictdom_family",
         *FAMILY_ARGS], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


@pytest.fixture(autouse=True, scope="module")
def jax_family_f32():
    """Starts the JAX family app in float32 in a subprocess at once (it
    runs beside this module's tests; test_family_float32_matches_jax_app
    reads it), hands the JAX package the port's transfer builders, and
    keeps BLAS and torch on one thread."""
    proc = _jax_family("0")
    try:
        with pytest.MonkeyPatch.context() as mp, \
                threadpoolctl.threadpool_limits(1):
            for name in ("_transfer_slot_matrices",
                         "_transfer_face_projectors", "_unit_recmap"):
                mp.setattr(jmg, name, _for_jax(name))
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            yield proc
            torch.set_num_threads(threads)
    finally:
        proc.kill()


def _close(a, ref, tol):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    ref = np.asarray(ref)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    assert np.max(np.abs(a - ref)) <= tol * np.max(np.abs(ref))


def _dot(a, b):
    return float(torch.sum(a.H * b.H) + torch.sum(a.V * b.V))


def _grid(rng, fbs, n):
    return jcl.GridVecCL(jnp.asarray(rng.standard_normal((fbs, n + 1, n))),
                         jnp.asarray(rng.standard_normal((fbs, n, n + 1))))


# ---------------------------------------------------------------------------
# The corrected transfers, on seeded random data
# ---------------------------------------------------------------------------

# Irregular coarse cells of the 8^2 grid: 9 and 10 share a vertical face,
# 9 and 17 (and 36 and 44) a horizontal one, so their corrections land on
# the same fine slots.
IDS = np.array([9, 10, 17, 27, 36, 37, 44], dtype=np.int64)


def _transfer_pair(k, drec, corr_on=True):
    """(port prolongation, restriction, JAX prolongation, restriction),
    16^2 <- 8^2, with the correction (IDS, drec)."""
    jhdi, hdi = JHHODegreeInfo(k + 1, k), HHODegreeInfo(k + 1, k)
    fbs = k + 1
    jf, jc = (jstructured.make_structured_system(n, n, fbs) for n in (16, 8))
    sf, sc = (structured.make_structured_system(n, n, fbs, device=CPU)
              for n in (16, 8))
    PH, PV = multigrid._transfer_face_projectors(hdi, 0.125, device=CPU)
    corr = (IDS, torch.as_tensor(drec), PH, PV) if corr_on else None
    jcorr = (IDS, jnp.asarray(drec), jnp.asarray(PH.numpy()),
             jnp.asarray(PV.numpy())) if corr_on else None
    mats = tuple(jnp.asarray(m) for m in _port_arrays(
        "_transfer_slot_matrices", k + 1, k, 0.125))
    return (multigrid.make_reconstruction_prolongation_cl(
                sf, sc, hdi, 0.125, corr=corr),
            multigrid.make_reconstruction_restriction_cl(
                sf, sc, hdi, 0.125, corr=corr),
            jmg.make_reconstruction_prolongation_cl(
                jf, jc, jhdi, 0.125, jnp.float64, mats=mats, corr=jcorr),
            jmg.make_reconstruction_restriction_cl(
                jf, jc, jhdi, 0.125, jnp.float64, mats=mats, corr=jcorr))


def _drec(k, seed):
    rbs = (k + 2) * (k + 3) // 2
    return 0.3 * np.random.default_rng(seed).standard_normal(
        (rbs * 4 * (k + 1), len(IDS)))


@pytest.mark.parametrize("k", [1, 2])
def test_corrected_transfers_match(k):
    """The cut-aware prolongation and restriction against the JAX
    package's on the same random drec and ids, 16^2 <- 8^2, 1e-12
    relative. Cells that share a face add to the same fine slots: JAX's
    .at[].add sums them, and so must the port."""
    p, r, jp, jr = _transfer_pair(k, _drec(k, k))
    rng = np.random.default_rng(10 + k)
    jxc, jrf = _grid(rng, k + 1, 8), _grid(rng, k + 1, 16)
    out = p(convert.grid_vec_cl(jxc, CPU)) + r(convert.grid_vec_cl(jrf, CPU))
    for a, b in zip(out, jax.jit(jp)(jxc) + jax.jit(jr)(jrf)):
        _close(a, b, 1e-12)


@pytest.mark.parametrize("k", [1, 2])
def test_corrected_transfers_are_adjoint(k):
    """<P x, y> = <x, R y> with a random correction, to 1e-10: the
    restriction stays the exact adjoint, or the V-cycle is no longer a
    symmetric CG preconditioner."""
    p, r, _, _ = _transfer_pair(k, _drec(k, 20 + k))
    rng = np.random.default_rng(30 + k)
    xc = convert.grid_vec_cl(_grid(rng, k + 1, 8), CPU)
    yf = convert.grid_vec_cl(_grid(rng, k + 1, 16), CPU)
    lhs, rhs = _dot(p(xc), yf), _dot(xc, r(yf))
    assert abs(lhs - rhs) < 1e-10 * max(1.0, abs(lhs))


@pytest.mark.parametrize("k", [1, 2])
def test_zero_deviation_is_the_uniform_transfer(k):
    """A correction with drec = 0 reproduces the uniform transfers, to
    1e-14."""
    zero = np.zeros_like(_drec(k, 0))
    p0, r0, _, _ = _transfer_pair(k, zero, corr_on=False)
    p1, r1, _, _ = _transfer_pair(k, zero)
    rng = np.random.default_rng(40 + k)
    xc = convert.grid_vec_cl(_grid(rng, k + 1, 8), CPU)
    yf = convert.grid_vec_cl(_grid(rng, k + 1, 16), CPU)
    for a, b in zip(p0(xc) + r0(yf), p1(xc) + r1(yf)):
        assert float((a - b).abs().max()) <= 1e-14


# ---------------------------------------------------------------------------
# The JAX package's own levels, built once
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_levels():
    """The JAX package's lean 16^2 level (with its right-hand side) and
    its 8^2 coarse level (build_coarse_level: on the CPU it carries drec),
    k=1."""
    hdi, problem = JHHODegreeInfo(2, 1), jfs.default_problem()
    eta = jfs.nitsche_eta(1)
    return {16: jfs.build_level(16, hdi, problem, eta, 4, False, False,
                                with_rhs=True, fitted="lean"),
            8: jfs.build_coarse_level(8, hdi, problem, eta, 4, False)}


@pytest.mark.parametrize("k", [1, 2])
def test_level_recdev_matches(jax_levels, k):
    """drec of the 8^2 coarse level of the default circle, the port's
    build_coarse_levels(drec=True) against the JAX package's
    _level_recdev, 1e-10 relative, column-aligned with the same irregular
    ids. The JAX function rounds its result to float32 whatever x64 says
    (its _cut_recdev takes the storage dtype from the cut batch's first
    leaf, the integer ids); its float64 value is read by handing it the
    batch with float ids (no operator reads them), and its stored value
    is held to the port's at float32 rounding. The classification does
    not depend on the degree, so the JAX side's k=2 deviations are taken
    on its k=1 level's cut batch."""
    hdi, problem = HHODegreeInfo(k + 1, k), fs.default_problem()
    eta = fs.nitsche_eta(k)
    lev = fs.build_coarse_levels(16, hdi, problem, eta, 4, device=CPU,
                                 mg_coarsest=8, drec=True)[8]
    jlev = jax_levels[8]
    np.testing.assert_array_equal(lev.irr_ids, np.asarray(jlev.irr_ids))
    jhdi, jproblem = JHHODegreeInfo(k + 1, k), jfs.default_problem()

    def jax_drec(batch):
        return jfs._level_recdev(batch, jlev.cut_ids, jlev.irr_ids, jhdi,
                                 jproblem, jfs.nitsche_eta(k), 8)

    rbs, nfd = (k + 2) * (k + 3) // 2, 4 * (k + 1)
    assert lev.drec.dtype == F64
    assert tuple(lev.drec.shape) == (rbs * nfd, len(lev.irr_ids))
    _close(lev.drec, jax_drec(jlev.batch._replace(
        ids=jlev.batch.ids.astype(jnp.float64))), 1e-10)
    stored = jlev.drec if k == 1 else jax_drec(jlev.batch)
    assert stored.dtype == jnp.float32
    _close(lev.drec, stored, 1e-6)
    # displaced-only columns stay zero
    cut = np.isin(lev.irr_ids, lev.cut_ids)
    assert not cut.all() and float(lev.drec[:, ~cut].abs().max()) == 0.0


def _band(jax_levels, n=16):
    return jfs.expand_ring(jax_levels[n].cut_ids, n, 1)


def test_band_face_features_match(jax_levels):
    """The deflation basis on the 16^2 band: face ids equal, features to
    1e-14."""
    band = _band(jax_levels)
    for (a, b, W), (ja, jb, jW) in zip(
            multigrid.band_face_features(16, band, 4),
            jmg.band_face_features(16, band, 4)):
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(b, jb)
        assert np.max(np.abs(W - jW)) <= 1e-14


def _fine_operators(jax_levels):
    """The 16^2 lean operator in both packages, from the JAX level."""
    lev = jax_levels[16]
    jsys = jstructured.make_structured_system(16, 16, 2)
    jop = jcl.make_uniform_operator_cl(jsys, jnp.asarray(lev.S_u),
                                       lev.irr_ids, lev.cond.dS)
    sys = structured.make_structured_system(16, 16, 2, device=CPU)
    op = cells_last.make_uniform_operator_cl(
        sys, convert.tensor(lev.S_u, CPU), lev.irr_ids,
        convert.tensor(lev.cond.dS, CPU))
    return jsys, jop, sys, op


def test_band_deflation_matches(jax_levels):
    """make_band_deflation on the 16^2 fine operator, K=4: the Cholesky
    factor of B^T A B and one apply against the JAX package's, 1e-10."""
    band = _band(jax_levels)
    jsys, jop, sys, op = _fine_operators(jax_levels)
    (_, _, L), apply = multigrid.make_band_deflation(sys, op, band, 4, F64)

    def jax_side(rH, rV):
        (_, _, jL), japply = jmg.make_band_deflation(jsys, jop, band, 4,
                                                     jnp.float64)
        return jL, japply(jcl.GridVecCL(rH, rV))

    jr = _grid(np.random.default_rng(5), 2, 16)
    jL, jz = jax.jit(jax_side)(jr.H, jr.V)
    _close(L, jL, 1e-10)
    for a, b in zip(apply(convert.grid_vec_cl(jr, CPU)), jz):
        _close(a, b, 1e-10)


# ---------------------------------------------------------------------------
# One V-cycle apply per option, over the JAX package's levels
# ---------------------------------------------------------------------------


def _level_data(jax_levels):
    sizes = (16, 8)
    cuts = {n: jfs.expand_ring(jax_levels[n].cut_ids, n, 1) for n in sizes}
    uni = {n: (np.asarray(jax_levels[n].S_u, np.float64),
               np.asarray(jax_levels[n].irr_ids)) for n in sizes}
    return cuts, uni


def _port_preconditioner(jax_levels, option):
    """The port's V-cycle over the JAX levels with ``option``, plus the
    deflation as mg_preconditioner adds it."""
    cuts, uni = _level_data(jax_levels)
    rec_dev = {8: convert.tensor(jax_levels[8].drec, CPU)} \
        if option.get("mg_transfer") == "cut" else None
    m = multigrid.build_multigrid(
        16, 2, hdi=HHODegreeInfo(2, 1), coarsest=8, n_smooth=1,
        cheb_ops=option.get("cheb_ops", "exact"), rec_dev_per_level=rec_dev,
        smooth_transfers=option.get("mg_transfer") == "smoothed",
        **convert.mg_levels(
            {n: (np.asarray(jax_levels[n].cond.dS), *uni[n], cuts[n])
             for n in uni}, CPU))
    if not option.get("mg_deflate"):
        return m.precondition
    fine = m.levels[0]
    _, deflate = multigrid.make_band_deflation(
        fine.sys, fine.apply_S, cuts[16], option["mg_deflate"], F64)

    def pre(r):
        z, d = m.precondition(r), deflate(r)
        return cells_last.GridVecCL(z.H + d.H, z.V + d.V)

    return pre


def _jax_preconditioner(jax_levels, option):
    """The JAX package's build_multigrid(layout="cl") over its levels
    with ``option``, and its deflation added as _solve_jit adds it, as
    one jitted function of the residual."""
    cuts, uni = _level_data(jax_levels)
    jsys = jstructured.make_structured_system(16, 16, 2)
    K = option.get("mg_deflate", 0)

    def pre(S16, S8, drec8, rH, rV):
        mg = jmg.build_multigrid(
            16, 2, {16: S16, 8: S8}, hdi=JHHODegreeInfo(2, 1), coarsest=8,
            n_smooth=1, cut_ids_per_level=cuts, smoother="chebyshev",
            layout="cl", uniform_per_level=uni,
            cheb_ops=option.get("cheb_ops", "exact"),
            rec_dev_per_level=({8: drec8} if option.get("mg_transfer") ==
                               "cut" else None),
            smooth_transfers=option.get("mg_transfer") == "smoothed")
        r = jcl.GridVecCL(rH, rV)
        z = mg.precondition(r)
        if K:
            op = jcl.make_uniform_operator_cl(
                jsys, uni[16][0].astype(S16.dtype), uni[16][1], S16)
            _, defl = jmg.make_band_deflation(jsys, op, cuts[16], K,
                                              S16.dtype)
            z = jax.tree.map(lambda a, b: a + b, z, defl(r))
        return z

    return functools.partial(jax.jit(pre), jax_levels[16].cond.dS,
                             jax_levels[8].cond.dS, jax_levels[8].drec)


@pytest.mark.parametrize("name", list(OPTIONS))
def test_vcycle_option_matches_and_is_symmetric(jax_levels, name):
    """One V-cycle apply with each option against the JAX package's on the
    same lean 16^2 / 8^2 levels and random residual, 1e-10 relative, and
    its symmetry <M r, s> = <r, M s> to 1e-10."""
    pre = _port_preconditioner(jax_levels, OPTIONS[name])
    jpre = _jax_preconditioner(jax_levels, OPTIONS[name])
    rng = np.random.default_rng(7)
    jr, js = _grid(rng, 2, 16), _grid(rng, 2, 16)
    r, s = convert.grid_vec_cl(jr, CPU), convert.grid_vec_cl(js, CPU)
    Mr, Ms = pre(r), pre(s)
    for a, b in zip(Mr, jpre(jr.H, jr.V)):
        _close(a, b, 1e-10)
    lhs, rhs = _dot(Mr, s), _dot(r, Ms)
    assert abs(lhs - rhs) <= 1e-10 * abs(lhs)


# ---------------------------------------------------------------------------
# End-to-end 16^2 solves
# ---------------------------------------------------------------------------

# name -> (options, iteration slack, H1 rtol)
SOLVES = {"smoothed": (dict(mg_transfer="smoothed"), 2, 1e-6),
          "cut": (dict(mg_transfer="cut"), 2, 1e-6),
          "deflate": (dict(mg_deflate=4), 2, 1e-6),
          "cheb_mixed_mg_f32": (dict(cheb_ops="mixed", mg_f32=True), 3,
                                1e-4)}


def _cg_params(pkg):
    return pkg.CGParams(convergence_threshold=1e-10, divergence_threshold=1e8,
                        max_iter=50000, apply_preconditioner=True)


def _jax_solve(jax_levels, option):
    """The JAX package's solve of its levels with ``option``: _solve_jit
    with the keywords solve_fictdom_structured gives it, then its chunked
    H1 error. Returns (iterations, exit code, H1)."""
    hdi, problem = JHHODegreeInfo(2, 1), jfs.default_problem()
    fine = jax_levels[16]
    sizes = (8, 16)
    mg_f32 = option.get("mg_f32", False)
    local, _, iters, exit_reason, _, _ = jfs._solve_jit(
        fine.mesh, jassembly.build_dofmap_structured(16, hdi), fine.cond,
        tuple(jax_levels[n].cond.dS for n in sizes),
        cg_params=_cg_params(jcg),
        drec_list=((jax_levels[8].drec, None)
                   if option.get("mg_transfer") == "cut" else None),
        gal_list=None, sizes=sizes, hdi=hdi, problem=problem, precond="mg",
        cut_levels=tuple((n, tuple(int(i) for i in jfs.expand_ring(
            jax_levels[n].cut_ids, n, 1))) for n in sizes),
        mg_coarsest=8, n_smooth=1, mg_f32=mg_f32, mg_smoother="chebyshev",
        cheb_degree=4, patch_colors=1,
        cheb_ops=option.get("cheb_ops", "exact"), patch_sweeps=1,
        smooth_transfers=option.get("mg_transfer") == "smoothed",
        deflate_K=option.get("mg_deflate", 0), mg_gamma=1,
        uniform_levels=jfs.uniform_static(jax_levels), cg_f64=not mg_f32)
    h1 = jfs.fictdom_h1_error_chunked(
        fine.mesh, jax.jit(jcell_geometry)(fine.mesh), fine.batch,
        fine.cell_loc, hdi, local, problem.sol_grad)
    return int(iters), int(exit_reason), float(h1)


@pytest.mark.parametrize("name", list(SOLVES))
def test_solve_matches_jax(jax_levels, name):
    """solve_fictdom_structured(16, 1, ...) with each option against the
    JAX package's solve at tol 1e-10: both converge, iterations within 2
    and H1 within rtol 1e-6; the float32 V-cycle with the mixed Chebyshev
    pair within 3 and 1e-4 (float32 rounds in another order)."""
    option, slack, rtol = SOLVES[name]
    r = fs.solve_fictdom_structured(16, 1, cg_params=_cg_params(cg),
                                    device="cpu", **option)
    iters, exit_reason, h1 = _jax_solve(jax_levels, option)
    assert r.exit_reason == cg.CONVERGED and exit_reason == 0
    assert abs(r.iterations - iters) <= slack, (r.iterations, iters)
    assert np.isclose(r.h1_error, h1, rtol=rtol), (r.h1_error, h1)
    if option.get("mg_transfer") == "cut":
        assert r.timings["drec_setup_s"] > 0.0
    if option.get("mg_deflate"):
        assert r.timings["deflate_setup_s"] > 0.0


# ---------------------------------------------------------------------------
# The family app's precision switch
# ---------------------------------------------------------------------------


def _app_line(capsys, monkeypatch, x64):
    """The app's JSON line with PROTON_TPU_X64=x64, and the dtypes of the
    local dofs of its geometries' solves (a spy on the condensed solve
    the family calls)."""
    solve, dtypes = batched.structured.solve_condensed_structured_cl, []

    def spy(*args, **kwargs):
        local, res = solve(*args, **kwargs)
        dtypes.append(local.dtype)
        return local, res

    monkeypatch.setattr(batched.structured, "solve_condensed_structured_cl",
                        spy)
    monkeypatch.setenv("PROTON_TPU_X64", x64)
    assert fictdom_family.main([*FAMILY_ARGS, "--device", "cpu"]) == 0
    monkeypatch.undo()
    return (json.loads(capsys.readouterr().out.strip().splitlines()[-1]),
            dtypes)


def test_family_float32_matches_jax_app(jax_family_f32, capsys,
                                        monkeypatch):
    """The port's family app with PROTON_TPU_X64=0 at -N 32 -k 1 -B 2
    runs float32 (the local dofs of every geometry's solve), as the JAX app
    with the same environment (run in a subprocess): all converged,
    iterations within 5%. Their H1 errors
    are float32 noise (both lie 6e-4 to 2e-3 above the float64 ones, the
    port's 1.8e-3 / 2.1e-3 and JAX's 2.5e-3 / 2.2e-3 against 6.5e-4 /
    1.5e-3), so each geometry's float32 H1 must lie no further from the
    float64 H1 than twice the JAX app's does; with the switch unset the
    app runs float64."""
    out, err = jax_family_f32.communicate(timeout=300)
    assert jax_family_f32.returncode == 0, err[-2000:]
    jax_line = json.loads(out.strip().splitlines()[-1])
    f32, dtypes32 = _app_line(capsys, monkeypatch, "0")
    f64, dtypes64 = _app_line(capsys, monkeypatch, "1")
    assert dtypes32 == [torch.float32] * 2 and dtypes64 == [torch.float64] * 2
    assert f32["all_converged"] and jax_line["all_converged"]
    assert f32["overflow"] == 0 and jax_line["overflow"] == 0
    for a, b in zip(f32["iterations"], jax_line["iterations"]):
        assert abs(a - b) <= 0.05 * b
    for h32, hj, h64 in zip(f32["h1_errors"], jax_line["h1_errors"],
                            f64["h1_errors"]):
        assert abs(h32 - h64) <= 2 * abs(hj - h64), (h32, hj, h64)
    # the float32 run is the float32 library solve
    angles = np.linspace(0.0, 2.0 * np.pi, 2, endpoint=False)
    res = batched.solve_fictdom_family(
        32, 1, np.linspace(0.25, 0.42, 2),
        0.5 + 0.02 * np.stack([np.cos(angles), np.sin(angles)], axis=1),
        device="cpu", dtype=torch.float32)
    assert res.iterations.tolist() == f32["iterations"]


# ---------------------------------------------------------------------------
# Where the JAX package ignores an option, the port raises
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(mg_transfer="cut", fitted="full"),
    dict(cheb_ops="mixed", fitted="full"),
    dict(cheb_ops="uniform", mg_smoother="jacobi", fitted="uniform"),
    dict(cheb_ops="mixed", mg_smoother="block_jacobi"),
    dict(mg_transfer="smoothed", precond="block_jacobi"),
    dict(mg_deflate=2, precond="block_jacobi"),
    dict(mg_transfer="injection"), dict(cheb_ops="exactish"),
    dict(mg_deflate=-1)], ids=lambda kw: "-".join(f"{k}={v}"
                                                   for k, v in kw.items()))
def test_mg_option_departures_raise(kw):
    """Each option where it cannot act, and each unknown value, raises
    ValueError before any work (the JAX package runs without the option,
    or fails later)."""
    with pytest.raises(ValueError):
        fs.solve_fictdom_structured(8, 1, device="cpu", **kw)


def test_deflation_without_cut_cells_is_a_no_op():
    """mg_deflate on a mesh without cut cells (a circle of radius 2 holds
    the whole square) deflates nothing: the same iterations and local
    dofs as without it, as in the JAX package."""
    problem = fs.default_problem(2.0)
    a = fs.solve_fictdom_structured(16, 1, problem, device="cpu")
    b = fs.solve_fictdom_structured(16, 1, problem, device="cpu",
                                    mg_deflate=4)
    assert a.iterations == b.iterations
    assert torch.equal(a.local, b.local)
    assert "deflate_setup_s" not in b.timings
