"""The port's lean/uniform system against proton_tpu on the CPU, float64:
the constant-stencil operator and its block-Jacobi, the lean level build,
the rhs fold, the recovery and the patch setups on the JAX package's own
16^2 level, and the end-to-end gates of the default solve
(precond="mg", fitted="lean")."""

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
from proton_tpu.solvers import multigrid as jmg
from proton_tpu_torch import convert
from proton_tpu_torch.core.ops import HHODegreeInfo
from proton_tpu_torch.cut import fictdom_structured as fs
from proton_tpu_torch.methods import cells_last, fused_assembly, structured
from proton_tpu_torch.solvers import cg

CPU = torch.device("cpu")
F64 = torch.float64
N, K, FBS, CBS = 16, 1, 2, 6


def _close(a, ref, tol=1e-12):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    ref = np.asarray(ref)
    assert a.shape == ref.shape
    assert np.max(np.abs(a - ref)) <= tol * np.max(np.abs(ref))


def _grid(rng, fbs, n):
    return jcl.GridVecCL(jnp.asarray(rng.standard_normal((fbs, n + 1, n))),
                         jnp.asarray(rng.standard_normal((fbs, n, n + 1))))


def _cgp(tol=1e-10):
    return dict(convergence_threshold=tol, divergence_threshold=1e8,
                max_iter=50000, apply_preconditioner=True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """BLAS and torch on one thread: with a pool per core in every test
    worker the cores are oversubscribed many times over."""
    with threadpoolctl.threadpool_limits(1):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_level():
    """The JAX package's lean 16^2 k=1 level, with its right-hand side."""
    return jfs.build_level(N, JHHODegreeInfo(K + 1, K), jfs.default_problem(),
                           jfs.nitsche_eta(K), 4, False, False,
                           with_rhs=True, fitted="lean")


@pytest.fixture(scope="module")
def port_levels():
    """The port's lean and full 16^2 k=1 levels."""
    hdi, problem = HHODegreeInfo(K + 1, K), fs.default_problem()
    return {fitted: fs.build_level(N, hdi, problem, fs.nitsche_eta(K), 4,
                                   device=CPU, fitted=fitted)
            for fitted in ("lean", "full")}


@pytest.fixture(scope="module")
def systems():
    return (jstructured.make_structured_system(N, N, FBS),
            structured.make_structured_system(N, N, FBS, device=CPU))


def test_build_level_lean_matches(jax_level, port_levels):
    """S_u, irr_ids, cut_ids and every array of the lean condensed system
    against the JAX level: 1e-12 relative on every column but the cut
    cells'. The cell block of the worst sliver cut cell has condition
    number 7.4e4 here, so the rounding of any Cholesky moves that cell's
    condensed columns by cond * eps = 1.6e-11 relative: the cut columns
    are held to 1e-11 (dS, bF) and to 1e-10 (the back-substitution
    operators X_i, y_i, which divide by the block once more)."""
    lev = port_levels["lean"]
    irr = lev.irr_ids
    assert np.array_equal(irr, np.asarray(jax_level.irr_ids))
    assert np.array_equal(lev.cut_ids, np.asarray(jax_level.cut_ids))
    assert np.all(np.diff(irr) > 0) and len(irr) < N * N
    _close(lev.S_u, jax_level.S_u)
    assert isinstance(lev.cond, cells_last.UniformCondCL)
    _close(lev.cond.fT, jax_level.cond.fT)
    cut_tol = dict(dS=1e-11, bF=1e-11, X_i=1e-10, y_i=1e-10)
    for name, tol in cut_tol.items():
        a = getattr(lev.cond, name).numpy()
        ref = np.asarray(getattr(jax_level.cond, name))
        cols = irr if name == "bF" else np.arange(len(irr))
        cut = np.isin(cols, lev.cut_ids) if name == "bF" else \
            np.isin(irr, lev.cut_ids)
        is_cut = np.zeros(a.shape[1], dtype=bool)
        is_cut[cols[cut]] = True
        assert is_cut.sum() == len(lev.cut_ids)
        _close(a[:, ~is_cut], ref[:, ~is_cut])
        _close(a[:, is_cut], ref[:, is_cut], tol)


def test_unit_cell_is_one_set_of_tensors_and_helper_split_is_exact():
    """_unit_cell_host hands out the same tensors on every call, equal to
    the JAX package's unit cell; and the plain helper that also returns
    the reconstruction operator gives the public plain function's lc bit
    for bit."""
    hdi = HHODegreeInfo(K + 1, K)
    unit = fs._unit_cell_host(hdi, 1.0 / N, CPU)
    again = fs._unit_cell_host(hdi, 1.0 / N, CPU)
    assert all(a is b for a, b in zip(unit, again))
    for a, b in zip(unit, jfs._unit_cell_host(JHHODegreeInfo(K + 1, K),
                                              1.0 / N)):
        assert a.dtype == F64
        _close(a, b)
    from proton_tpu_torch.core.geometry import cell_geometry
    from proton_tpu_torch.core.mesh import make_quad_mesh
    mesh = make_quad_mesh(Nx=3, Ny=2, device=CPU)
    inputs = fused_assembly.pack_inputs(mesh, cell_geometry(mesh))
    oper, lc = fused_assembly.reconstruction_and_operator_plain(*inputs, 2, 1)
    d = CBS + 4 * FBS
    assert tuple(oper.shape) == (6, 5, d)
    assert torch.equal(lc.permute(1, 2, 0).reshape(d * d, 6),
                       fused_assembly.fitted_local_operator_plain(*inputs, 2,
                                                                  1))


def test_uniform_operator_and_block_jacobi_match(jax_level, port_levels,
                                                 systems):
    """Port against JAX on the level's (S_u, irr, dS) and a random grid
    vector, 1e-12; the pure uniform operator too; and the port's lean
    operator and block-Jacobi against its own full-S ones on the
    fitted="full" level, 1e-12."""
    jsys, sys_ = systems
    S_u, irr, jdS = jax_level.S_u, jax_level.irr_ids, jax_level.cond.dS
    dS = convert.tensor(jdS, CPU)
    rng = np.random.default_rng(0)
    jx = _grid(rng, FBS, N)
    x = convert.grid_vec_cl(jx, CPU)

    y = cells_last.make_uniform_operator_cl(sys_, S_u, irr, dS)(x)
    for a, b in zip(y, jcl.make_uniform_operator_cl(jsys, S_u, irr, jdS)(jx)):
        _close(a, b)
    for a, b in zip(cells_last.make_uniform_operator_cl(sys_, S_u)(x),
                    jcl.make_uniform_operator_cl(jsys, S_u)(jx)):
        _close(a, b)

    jhf, jvf = jcl.uniform_face_block_deltas(jsys, jdS, irr)
    hf, vf = cells_last.uniform_face_block_deltas(sys_, dS, irr)
    for f, jf in ((hf, jhf), (vf, jvf)):
        assert np.array_equal(f[0], jf[0]) and np.array_equal(f[1], jf[1])
        _close(f[2], jf[2])
    # faces shared by two irregular cells got both contributions
    assert len(hf[0]) + len(vf[0]) < 4 * len(irr)
    jbj = jcl.make_uniform_block_jacobi_cl(
        jsys, *jcl.uniform_block_jacobi_blocks(jsys, S_u),
        *jcl.uniform_bj_from_deltas(jsys, S_u, jhf, jvf, jnp.float64))
    bj = cells_last.make_uniform_block_jacobi_cl(
        sys_, *cells_last.uniform_block_jacobi_blocks(sys_, S_u),
        *cells_last.uniform_bj_from_deltas(sys_, S_u, hf, vf, F64))
    z = bj(x)
    for a, b in zip(z, jbj(jx)):
        _close(a, b)

    # the port's lean level against the port's full level: one system
    S, lean = port_levels["full"].cond.S, port_levels["lean"]
    pdS = lean.cond.dS
    _close(cells_last.uniform_deltas(S, lean.S_u, irr), pdS)
    for a, b in zip(
            cells_last.make_uniform_operator_cl(sys_, lean.S_u, irr, pdS)(x),
            cells_last.make_structured_operator_cl(sys_, S)(x)):
        _close(a, b)
    hf, vf = cells_last.uniform_face_block_deltas(sys_, pdS, irr)
    bj = cells_last.make_uniform_block_jacobi_cl(
        sys_, *cells_last.uniform_block_jacobi_blocks(sys_, lean.S_u),
        *cells_last.uniform_bj_from_deltas(sys_, lean.S_u, hf, vf, F64))
    xm = cells_last.mask_cl(sys_, x)    # frozen faces: identity blocks
    for a, b in zip(cells_last.mask_cl(sys_, bj(xm)),
                    cells_last.mask_cl(
                        sys_, cells_last.block_jacobi_preconditioner_cl(
                            sys_, S)(xm))):
        _close(a, b)


def test_uniform_rhs_and_recover_match(jax_level, systems):
    """uniform_rhs_cl with a Dirichlet fold and uniform_recover_cl against
    JAX, 1e-11."""
    jsys, sys_ = systems
    S_u, irr = jax_level.S_u, jax_level.irr_ids
    ucond = convert.uniform_cond_cl(jax_level.cond, CPU)
    rng = np.random.default_rng(1)
    g = rng.standard_normal((4 * FBS, N * N))
    for gj, gt in ((None, None), (jnp.asarray(g), torch.as_tensor(g))):
        for a, b in zip(
                cells_last.uniform_rhs_cl(sys_, ucond, S_u, irr, gt),
                jcl.uniform_rhs_cl(jsys, jax_level.cond, S_u, irr, gj)):
            _close(a, b, 1e-11)
    _, X_u, ATT_u, _ = jfs._unit_cell_host(JHHODegreeInfo(K + 1, K), 1.0 / N)
    jx = _grid(rng, FBS, N)
    _close(cells_last.uniform_recover_cl(sys_, ucond, X_u, ATT_u, irr,
                                         convert.grid_vec_cl(jx, CPU),
                                         torch.as_tensor(g)),
           jcl.uniform_recover_cl(jsys, jax_level.cond, X_u, ATT_u, irr, jx,
                                  jnp.asarray(g)), 1e-11)


@pytest.mark.parametrize("patch_colors", [1, 2])
def test_patch_setups_and_apply_match(jax_level, port_levels, systems,
                                      patch_colors):
    """uniform_patch_setup_lean and cut_patch_setup_cl (Binv, wH, wV)
    against JAX on the cut cells grown by one ring, per color group, and
    the patch apply on a random residual, 1e-11."""
    jsys, sys_ = systems
    S_u, irr, jdS = jax_level.S_u, jax_level.irr_ids, jax_level.cond.dS
    dS = convert.tensor(jdS, CPU)
    S = port_levels["full"].cond.S
    patch_ids = fs.expand_ring(jax_level.cut_ids, N, 1)
    groups = cells_last.patch_color_groups(patch_ids, N, patch_colors)
    jgroups = jcl.patch_color_groups(patch_ids, N, patch_colors)
    assert len(groups) == len(jgroups) == patch_colors
    rng = np.random.default_rng(2)
    jr = _grid(rng, FBS, N)
    r = convert.grid_vec_cl(jr, CPU)
    for g, jg in zip(groups, jgroups):
        assert np.array_equal(g, jg)
        jsetup = jcl.uniform_patch_setup_lean(jsys, S_u, jdS, irr, jg,
                                              jnp.float64)
        setup = cells_last.uniform_patch_setup_lean(sys_, S_u, dS, irr, g,
                                                    F64)
        full = cells_last.cut_patch_setup_cl(sys_, S, g)
        jfull = jcl.cut_patch_setup_cl(jsys, jnp.asarray(S.numpy()), jg)
        for a, b, c, e in zip(setup, jsetup, full, jfull):
            _close(a, b, 1e-11)
            _close(c, e, 1e-11)
        japplied = jcl.apply_cut_patch_cl(jsys, jg, *jsetup, jr)
        for a, b in zip(cells_last.make_patch_apply(sys_, g, *setup)(r),
                        japplied):
            _close(a, b, 1e-11)
        for a, b in zip(cells_last.make_cut_patch_smoother_cl(sys_, S, g)(r),
                        japplied):
            _close(a, b, 1e-11)


# JAX package, CPU, float64, solve_fictdom_structured(N, k, precond="mg",
# fitted="lean", mixed=False, use_pallas=False), CG tol 1e-10, divergence
# 1e8, max_iter 50000: (iterations, H1 error). Each of these JAX solves
# takes one to two minutes, nearly all tracing and compiling, so they are
# recorded here and only the first is also run live (below).
MG_GATES = {(16, 1): (10, 4.434838982578402e-3),
            (32, 1): (15, 1.134476548999272e-3),
            (16, 2): (10, 1.8041372726985633e-4)}


@pytest.mark.parametrize("n,k", sorted(MG_GATES))
def test_default_solve_gates(n, k):
    """The default solve (lean + MG) at CG tol 1e-10: iterations within 1
    of the JAX gate, H1 within rtol 1e-6."""
    r = fs.solve_fictdom_structured(n, k, cg_params=cg.CGParams(**_cgp()),
                                    device="cpu")
    iters, h1 = MG_GATES[(n, k)]
    assert r.exit_reason == cg.CONVERGED and r.rel_residual < 1e-10
    assert abs(r.iterations - iters) <= 1
    assert np.isclose(r.h1_error, h1, rtol=1e-6)
    assert {"assemble_coarse_s", "mg_setup_s"} <= set(r.timings)


def test_full_mg_matches_lean_mg():
    """fitted="full" with precond="mg" (K1's function on every cell of
    every level, the generic branch of build_multigrid): the lean solve's
    iterations within 1, local dofs within 1e-8 at tol 1e-12."""
    kw = dict(precond="mg", cg_params=cg.CGParams(**_cgp(1e-12)),
              device="cpu")
    lean = fs.solve_fictdom_structured(16, 1, fitted="lean", **kw)
    full = fs.solve_fictdom_structured(16, 1, fitted="full", **kw)
    assert lean.exit_reason == full.exit_reason == cg.CONVERGED
    assert abs(lean.iterations - full.iterations) <= 1
    assert float((lean.local - full.local).abs().max()) < 1e-8
    assert np.isclose(lean.h1_error, full.h1_error, rtol=1e-8)


def test_lean_block_jacobi_matches_full_block_jacobi():
    """fitted="lean" with precond="block_jacobi" (the uniform block-Jacobi
    with the dS corrections) is the same preconditioned system as
    fitted="full": 115 +- 2 iterations at 32^2 k=1 and tol 1e-10 (the JAX
    package's count for full + block-Jacobi), the same count as the
    port's full solve, local dofs within 1e-8; Jacobi on the lean system
    is refused."""
    kw = dict(precond="block_jacobi", cg_params=cg.CGParams(**_cgp()),
              device="cpu")
    lean = fs.solve_fictdom_structured(32, 1, fitted="lean", **kw)
    full = fs.solve_fictdom_structured(32, 1, fitted="full", **kw)
    assert lean.exit_reason == full.exit_reason == cg.CONVERGED
    assert abs(lean.iterations - 115) <= 2
    assert abs(lean.iterations - full.iterations) <= 1
    assert float((lean.local - full.local).abs().max()) < 1e-8
    with pytest.raises(ValueError, match="lean"):
        fs.solve_fictdom_structured(8, 1, fitted="lean", precond="jacobi",
                                    device="cpu")


def test_default_solve_matches_live_jax_solve(jax_level, monkeypatch):
    """The one live JAX lean + MG solve, 16^2 k=1, both at tol 1e-12:
    equal iteration counts within 1, per-cell local dofs within 1e-8 (the
    cut cells' cell dofs 1e-7), H1 within rtol 1e-6. The JAX solve takes
    its fine level from the module's jax_level fixture (the same
    build_level call, made once) and memoizes the pure transfer-matrix
    builders its multigrid setup calls more than once."""
    build_level = jfs.build_level

    def shared_fine_level(n, hdi, problem, *args, **kw):
        if (n, hdi, args, kw) == (N, JHHODegreeInfo(K + 1, K),
                                  (jfs.nitsche_eta(K), 4, False, False),
                                  dict(with_rhs=True, fitted="lean")) and \
                problem.cache_key == jfs.default_problem().cache_key:
            return jax_level
        return build_level(n, hdi, problem, *args, **kw)

    monkeypatch.setattr(jfs, "build_level", shared_fine_level)
    for name in ("_unit_recmap", "_transfer_slot_matrices"):
        monkeypatch.setattr(jmg, name, functools.lru_cache(maxsize=None)(
            getattr(jmg, name)))
    r = fs.solve_fictdom_structured(16, 1,
                                    cg_params=cg.CGParams(**_cgp(1e-12)),
                                    device="cpu")
    jr = jfs.solve_fictdom_structured(16, 1, precond="mg", fitted="lean",
                                      mixed=False, use_pallas=False,
                                      cg_params=jcg.CGParams(**_cgp(1e-12)))
    assert r.exit_reason == int(jr.exit_reason) == cg.CONVERGED
    assert abs(r.iterations - int(jr.iterations)) <= 1
    diff = np.abs(r.local.numpy() - np.asarray(jr.local))
    cut_ids = fs.classify_level(16, fs.default_problem(), 4, device=CPU)[2]
    assert diff[cut_ids, :CBS].max() < 1e-7
    diff[cut_ids, :CBS] = 0.0
    assert diff.max() < 1e-8
    assert np.isclose(r.h1_error, float(jr.h1_error), rtol=1e-6)
