"""The port's lean/uniform system against proton_tpu on the CPU, float64:
the constant-stencil operator and its block-Jacobi, the lean level build,
the rhs fold, the recovery and the patch setups on the JAX package's own
16^2 level, and the end-to-end gates of the default solve
(precond="mg", fitted="lean").

The JAX package's level, its operators on it and its solve are read from
tests/jax_refs/test_torch_lean.npz (REFS below;
tests/torch_jax_reference.py writes it, running the JAX package on the
same seeded inputs; the patch setups of the full S take the port's full
level, whose digest the store keeps)."""

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
from proton_tpu_torch.core.ops import HHODegreeInfo
from proton_tpu_torch.cut import fictdom_structured as fs
from proton_tpu_torch.methods import cells_last, fused_assembly, structured
from proton_tpu_torch.solvers import cg
from torch_jax_reference import Refs, jax_solve_ref

CPU = torch.device("cpu")
F64 = torch.float64
N, K, FBS, CBS = 16, 1, 2, 6
REFS = Refs(__name__)


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


@functools.lru_cache(maxsize=None)
def _jax_level_data():
    """The JAX package's lean 16^2 k=1 level, with its right-hand side."""
    return jfs.build_level(N, JHHODegreeInfo(K + 1, K), jfs.default_problem(),
                           jfs.nitsche_eta(K), 4, False, False,
                           with_rhs=True, fitted="lean")


def _jax_level():
    lev = _jax_level_data()
    return dict(irr_ids=lev.irr_ids, cut_ids=lev.cut_ids, S_u=lev.S_u,
                cond=lev.cond)


REFS.add("level", "level",
         "build_level(16, HHODegreeInfo(2, 1), default_problem(), "
         "nitsche_eta(1), 4, False, False, with_rhs=True, fitted='lean')",
         _jax_level)


def _jax_cond(level):
    """The stored level's UniformCondCL, as JAX arrays."""
    return jcl.UniformCondCL(*(jnp.asarray(a) for a in level.cond))


@pytest.fixture(scope="module")
def jax_level():
    """The JAX package's stored lean 16^2 k=1 level."""
    return REFS["level"]


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


def _jax_uniform_operator(level):
    """The JAX package's lean and pure uniform operator, face block
    deltas and uniform block-Jacobi on the stored level and a random grid
    vector."""
    jsys = jstructured.make_structured_system(N, N, FBS)
    S_u, irr, jdS = level.S_u, level.irr_ids, jnp.asarray(level.cond.dS)
    jx = _grid(np.random.default_rng(0), FBS, N)
    jhf, jvf = jcl.uniform_face_block_deltas(jsys, jdS, irr)
    jbj = jcl.make_uniform_block_jacobi_cl(
        jsys, *jcl.uniform_block_jacobi_blocks(jsys, S_u),
        *jcl.uniform_bj_from_deltas(jsys, S_u, jhf, jvf, jnp.float64))
    return dict(op=jcl.make_uniform_operator_cl(jsys, S_u, irr, jdS)(jx),
                op_uniform=jcl.make_uniform_operator_cl(jsys, S_u)(jx),
                hf=jhf, vf=jvf, bj=jbj(jx))


REFS.add("uniform_operator", "operator",
         "make_uniform_operator_cl (with and without the irregular "
         "columns), uniform_face_block_deltas and the uniform "
         "block-Jacobi on the stored level, applied to a random grid",
         _jax_uniform_operator, needs=("level",), seed=0)


def test_uniform_operator_and_block_jacobi_match(jax_level, port_levels,
                                                 systems):
    """Port against JAX on the level's (S_u, irr, dS) and a random grid
    vector, 1e-12; the pure uniform operator too; and the port's lean
    operator and block-Jacobi against its own full-S ones on the
    fitted="full" level, 1e-12."""
    _, sys_ = systems
    S_u, irr, jdS = jax_level.S_u, jax_level.irr_ids, jax_level.cond.dS
    dS = convert.tensor(jdS, CPU)
    rng = np.random.default_rng(0)
    jx = _grid(rng, FBS, N)
    x = convert.grid_vec_cl(jx, CPU)
    ref = REFS["uniform_operator"]

    y = cells_last.make_uniform_operator_cl(sys_, S_u, irr, dS)(x)
    for a, b in zip(y, ref.op):
        _close(a, b)
    for a, b in zip(cells_last.make_uniform_operator_cl(sys_, S_u)(x),
                    ref.op_uniform):
        _close(a, b)

    jhf, jvf = ref.hf, ref.vf
    hf, vf = cells_last.uniform_face_block_deltas(sys_, dS, irr)
    for f, jf in ((hf, jhf), (vf, jvf)):
        assert np.array_equal(f[0], jf[0]) and np.array_equal(f[1], jf[1])
        _close(f[2], jf[2])
    # faces shared by two irregular cells got both contributions
    assert len(hf[0]) + len(vf[0]) < 4 * len(irr)
    bj = cells_last.make_uniform_block_jacobi_cl(
        sys_, *cells_last.uniform_block_jacobi_blocks(sys_, S_u),
        *cells_last.uniform_bj_from_deltas(sys_, S_u, hf, vf, F64))
    z = bj(x)
    for a, b in zip(z, ref.bj):
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


def _jax_uniform_rhs_recover(level):
    """The JAX package's uniform_rhs_cl (without and with a random
    Dirichlet fold) and uniform_recover_cl on the stored level."""
    jsys = jstructured.make_structured_system(N, N, FBS)
    S_u, irr, cond = level.S_u, level.irr_ids, _jax_cond(level)
    rng = np.random.default_rng(1)
    g = rng.standard_normal((4 * FBS, N * N))
    rhs = [jcl.uniform_rhs_cl(jsys, cond, S_u, irr, gj)
           for gj in (None, jnp.asarray(g))]
    _, X_u, ATT_u, _ = jfs._unit_cell_host(JHHODegreeInfo(K + 1, K), 1.0 / N)
    jx = _grid(rng, FBS, N)
    return dict(rhs=rhs, recover=jcl.uniform_recover_cl(
        jsys, cond, X_u, ATT_u, irr, jx, jnp.asarray(g)))


REFS.add("uniform_rhs_recover", "operator",
         "uniform_rhs_cl(sys, cond, S_u, irr, g) for g None and random, and "
         "uniform_recover_cl on the stored level", _jax_uniform_rhs_recover,
         needs=("level",), seed=1)


def test_uniform_rhs_and_recover_match(jax_level, systems):
    """uniform_rhs_cl with a Dirichlet fold and uniform_recover_cl against
    JAX, 1e-11."""
    _, sys_ = systems
    S_u, irr = jax_level.S_u, jax_level.irr_ids
    ucond = convert.uniform_cond_cl(jax_level.cond, CPU)
    ref = REFS["uniform_rhs_recover"]
    rng = np.random.default_rng(1)
    g = rng.standard_normal((4 * FBS, N * N))
    for gt, jrhs in zip((None, torch.as_tensor(g)), ref.rhs):
        for a, b in zip(
                cells_last.uniform_rhs_cl(sys_, ucond, S_u, irr, gt), jrhs):
            _close(a, b, 1e-11)
    _, X_u, ATT_u, _ = jfs._unit_cell_host(JHHODegreeInfo(K + 1, K), 1.0 / N)
    jx = _grid(rng, FBS, N)
    _close(cells_last.uniform_recover_cl(sys_, ucond, X_u, ATT_u, irr,
                                         convert.grid_vec_cl(jx, CPU),
                                         torch.as_tensor(g)),
           ref.recover, 1e-11)


def _port_full_S():
    """The port's fitted="full" 16^2 k=1 level's S (the input of the JAX
    cut_patch_setup_cl below)."""
    return fs.build_level(N, HHODegreeInfo(K + 1, K), fs.default_problem(),
                          fs.nitsche_eta(K), 4, device=CPU,
                          fitted="full").cond.S


def _jax_patch_setups(level, patch_colors):
    """Per color group of the stored level's cut cells grown by one ring:
    the group, the JAX package's uniform_patch_setup_lean, its
    cut_patch_setup_cl on the port's full S, and the patch apply on a
    random residual; with the digest of S."""
    jsys = jstructured.make_structured_system(N, N, FBS)
    S_u, irr, jdS = level.S_u, level.irr_ids, jnp.asarray(level.cond.dS)
    S = _port_full_S()
    patch_ids = jfs.expand_ring(level.cut_ids, N, 1)
    jr = _grid(np.random.default_rng(2), FBS, N)
    out = dict(inputs=[S], groups=[], setup=[], full=[], applied=[])
    for jg in jcl.patch_color_groups(patch_ids, N, patch_colors):
        jsetup = jcl.uniform_patch_setup_lean(jsys, S_u, jdS, irr, jg,
                                              jnp.float64)
        out["groups"].append(jg)
        out["setup"].append(jsetup)
        out["full"].append(jcl.cut_patch_setup_cl(
            jsys, jnp.asarray(S.numpy()), jg))
        out["applied"].append(jcl.apply_cut_patch_cl(jsys, jg, *jsetup, jr))
    return out


for _colors in (1, 2):
    REFS.add(f"patch_setups[{_colors}]", "smoother",
             f"patch_color_groups(expand_ring(cut_ids, 16, 1), 16, "
             f"{_colors}); per group uniform_patch_setup_lean, "
             f"cut_patch_setup_cl on the port's full S, apply_cut_patch_cl "
             f"of a random residual", _jax_patch_setups, needs=("level",),
             seed=2, patch_colors=_colors)


@pytest.mark.parametrize("patch_colors", [1, 2])
def test_patch_setups_and_apply_match(jax_level, port_levels, systems,
                                      patch_colors):
    """uniform_patch_setup_lean and cut_patch_setup_cl (Binv, wH, wV)
    against JAX on the cut cells grown by one ring, per color group, and
    the patch apply on a random residual, 1e-11."""
    _, sys_ = systems
    S_u, irr, jdS = jax_level.S_u, jax_level.irr_ids, jax_level.cond.dS
    dS = convert.tensor(jdS, CPU)
    S = port_levels["full"].cond.S
    ref = REFS.get(f"patch_setups[{patch_colors}]", inputs=[S])
    patch_ids = fs.expand_ring(jax_level.cut_ids, N, 1)
    groups = cells_last.patch_color_groups(patch_ids, N, patch_colors)
    jgroups = ref.groups
    assert len(groups) == len(jgroups) == patch_colors
    rng = np.random.default_rng(2)
    jr = _grid(rng, FBS, N)
    r = convert.grid_vec_cl(jr, CPU)
    for g, jg, jsetup, jfull, japplied in zip(groups, jgroups, ref.setup,
                                              ref.full, ref.applied):
        assert np.array_equal(g, jg)
        setup = cells_last.uniform_patch_setup_lean(sys_, S_u, dS, irr, g,
                                                    F64)
        full = cells_last.cut_patch_setup_cl(sys_, S, g)
        for a, b, c, e in zip(setup, jsetup, full, jfull):
            _close(a, b, 1e-11)
            _close(c, e, 1e-11)
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


def _jax_default_solve():
    """The JAX lean + MG solve, 16^2 k=1, tol 1e-12: its _solve_jit over
    the levels its solve_fictdom_structured builds (the fine level of
    _jax_level_data, and the 8^2 level of build_coarse_level without the
    deviations drec that only mg_transfer="cut" reads)."""
    coarse = jfs.build_level(8, JHHODegreeInfo(K + 1, K),
                             jfs.default_problem(), jfs.nitsche_eta(K), 4,
                             False, False, with_rhs=False, fitted="lean")
    return jax_solve_ref({N: _jax_level_data(), 8: coarse}, K,
                         jcg.CGParams(**_cgp(1e-12)),
                         keep=("local", "iterations", "exit_reason", "h1"))


REFS.add("default_solve", "solve",
         "solve_fictdom_structured(16, 1, precond='mg', fitted='lean', "
         "mixed=False, use_pallas=False), CG tol 1e-12: _solve_jit over "
         "build_level(16, fitted='lean') and build_level(8, fitted='lean')",
         _jax_default_solve)


def test_default_solve_matches_live_jax_solve():
    """The JAX lean + MG solve, 16^2 k=1, both at tol 1e-12: equal
    iteration counts within 1, per-cell local dofs within 1e-8 (the cut
    cells' cell dofs 1e-7), H1 within rtol 1e-6. The JAX solve is stored
    (_jax_default_solve)."""
    r = fs.solve_fictdom_structured(16, 1,
                                    cg_params=cg.CGParams(**_cgp(1e-12)),
                                    device="cpu")
    jlocal, jiters, jexit, jh1 = REFS["default_solve"]
    assert r.exit_reason == jexit == cg.CONVERGED
    assert abs(r.iterations - jiters) <= 1
    diff = np.abs(r.local.numpy() - np.asarray(jlocal))
    cut_ids = fs.classify_level(16, fs.default_problem(), 4, device=CPU)[2]
    assert diff[cut_ids, :CBS].max() < 1e-7
    diff[cut_ids, :CBS] = 0.0
    assert diff.max() < 1e-8
    assert np.isclose(r.h1_error, jh1, rtol=1e-6)
