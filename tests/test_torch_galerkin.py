"""The port's Galerkin coarse hierarchy against proton_tpu on the CPU,
float64: every function of the pair-operator engine on the same input
(the port's lean fine levels at 16^2 and 32^2 k=1 and 16^2 k=2; 1e-12,
rows and columns equal), the Galerkin operator apply on seeded random
data, galerkin_patch_setup, band_galerkin_levels level by level, one
V-cycle over the Galerkin hierarchy at gamma 1 and 2, the end-to-end
solve against the JAX package's numbers, and the exactness of the
hierarchy against the port's own dense R A P at 16 -> 8.

The JAX side is handed the port's level data, so no JAX level is built.
Its transfer slot matrices (its own, run once under jax.jit), its
Galerkin levels with their patch setups, its Galerkin operator on random
data and its V-cycles are read from tests/jax_refs/test_torch_galerkin.npz
(REFS below; tests/torch_jax_reference.py writes it, with the digest of
the port's level data it was given). The pair-operator engine (host
NumPy in both packages) runs live on the stored slot matrices. BLAS and
torch run on one thread."""

import functools
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import threadpoolctl
import torch

from proton_tpu.core.ops import HHODegreeInfo as JHHODegreeInfo
from proton_tpu.cut import fictdom_structured as jfs
from proton_tpu.methods import cells_last as jcl, structured as jstructured
from proton_tpu.solvers import multigrid as jmg
from proton_tpu_torch import convert
from proton_tpu_torch.core.ops import HHODegreeInfo
from proton_tpu_torch.cut import fictdom_structured as fs
from proton_tpu_torch.methods import cells_last, structured
from proton_tpu_torch.solvers import cg, multigrid
from torch_jax_reference import Refs, jax_transfer_arrays

CPU = torch.device("cpu")
F64 = torch.float64
CASES = [(16, 1), (32, 1), (16, 2)]
REFS = Refs(__name__)

# The JAX package on the CPU in float64, (iterations, H1) of
# solve_fictdom_structured(N, k, mg_galerkin=True, mg_gamma=gamma,
# mixed=False, use_pallas=False) at CG tol 1e-11, divergence 1e8,
# max_iter 50000 (its default fitted="uniform"; a live JAX solve costs
# 55-85 s on a CPU, so the numbers are stored, as chip_smoke.py stores
# them).
JAX_GALERKIN = {(16, 1, 1): (11, 0.004434838976281151),
                (32, 1, 1): (19, 0.0011344765335767838),
                (16, 2, 1): (9, 0.0001804137275041844),
                (32, 1, 2): (22, 0.0011344765320524402)}


# (k, n) of the coarse cells of side 1/n whose transfer slot matrices the
# pair-operator engine of CASES reads
SLOT_MATRICES = ((1, 16), (1, 8), (2, 8))
for _k, _n in SLOT_MATRICES:
    REFS.add(f"slot_matrices[{_k}-{_n}]", "transfer",
             f"_transfer_slot_matrices(HHODegreeInfo({_k + 1}, {_k}), 1/{_n}, "
             f"float64) under jax.jit",
             lambda k, n: jax_transfer_arrays(
                 "_transfer_slot_matrices", JHHODegreeInfo(k + 1, k),
                 1.0 / n, "float64"), k=_k, n=_n)


def _stored_slot_matrices(jhdi, h, dtype):
    """The JAX package's own (MH, MV), read from the store."""
    MH, MV = REFS[f"slot_matrices[{jhdi.face_degree}-{round(1.0 / h)}]"]
    return jnp.asarray(MH, dtype), jnp.asarray(MV, dtype)


@pytest.fixture(autouse=True, scope="module")
def _stored_transfers_one_thread():
    with pytest.MonkeyPatch.context() as mp, \
            threadpoolctl.threadpool_limits(1):
        mp.setattr(jmg, "_transfer_slot_matrices", _stored_slot_matrices)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)


def _close(a, ref, tol=1e-12):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    ref = np.asarray(ref)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    scale = max(float(np.max(np.abs(ref))), 1e-300) if ref.size else 1.0
    assert np.max(np.abs(a - ref), initial=0.0) <= tol * scale


@functools.lru_cache(maxsize=None)
def _levels(N, k):
    """The port's lean levels N, N/2, ..., 8 ({n: LevelData})."""
    hdi, problem, eta = HHODegreeInfo(k + 1, k), fs.default_problem(), \
        fs.nitsche_eta(k)
    levels = {N: fs.build_level(N, hdi, problem, eta, 4, device=CPU,
                                fitted="lean")}
    levels.update(fs.build_coarse_levels(N, hdi, problem, eta, 4,
                                         device=CPU))
    return levels


def _fine_args(N, k):
    fine = _levels(N, k)[N]
    return (N, fine.S_u.numpy(), fine.cond.dS.numpy(),
            np.asarray(fine.irr_ids))


def _same_pairop(op, jop):
    (const, corr), (jconst, jcorr) = op, jop
    assert sorted(const) == sorted(jconst)
    scale = max(np.abs(B).max() for B in jconst.values())
    for d, B in jconst.items():
        assert np.abs(const[d] - B).max() <= 1e-12 * scale
    np.testing.assert_array_equal(corr[0], jcorr[0])
    np.testing.assert_array_equal(corr[1], jcorr[1])
    _close(corr[2], jcorr[2])


def _jax_levels(N, k):
    """The JAX package's band_galerkin_levels input built from the port's
    levels: the fine level's (S_u, dS, irr_ids) in a JAX UniformCondCL;
    the coarse levels enter by their sizes only."""
    fine = _levels(N, k)[N]
    dS = jnp.asarray(fine.cond.dS.numpy())
    cond = jcl.UniformCondCL(*([dS] + [None] * (
        len(jcl.UniformCondCL._fields) - 1)))
    out = {n: None for n in _levels(N, k)}
    out[N] = types.SimpleNamespace(cond=cond, S_u=fine.S_u.numpy(),
                                   irr_ids=np.asarray(fine.irr_ids))
    return out


@functools.lru_cache(maxsize=None)
def _galerkin(N, k):
    """The port's {n: GalerkinLevel} of its fine level."""
    return fs.band_galerkin_levels(_levels(N, k), HHODegreeInfo(k + 1, k))


def _jax_galerkin(N, k):
    """The JAX package's {n: GalerkinLevel} of the port's fine level."""
    return jfs.band_galerkin_levels(_jax_levels(N, k),
                                    JHHODegreeInfo(k + 1, k),
                                    jfs.default_problem(), jfs.nitsche_eta(k),
                                    dtype=jnp.float64)


def _level_inputs(N, k):
    """The port's level data the JAX side is given: the fine level's
    (S_u, dS, irr_ids) and every level's cut ids."""
    return list(_fine_args(N, k)[1:]) + [
        np.asarray(lev.cut_ids) for _, lev in sorted(_levels(N, k).items())]


@pytest.mark.parametrize("N,k", CASES)
def test_pair_op_engine_matches(N, k):
    """finest_pair_op, mask_pair_op, galerkin_coarsen_pair_op,
    pair_op_diag_data, pair_op_cell_face_blocks and pair_op_kernel at
    every coarsening step down to 8^2, _mloc_cells and _frozen_slot_mask
    on the way, pair_op_dense at 8^2: 1e-12 relative, rows, columns and
    cells equal."""
    hdi, jhdi = HHODegreeInfo(k + 1, k), JHHODegreeInfo(k + 1, k)
    fbs = k + 1
    args = _fine_args(N, k)
    op, jop = multigrid.finest_pair_op(*args), jmg.finest_pair_op(*args)
    _same_pairop(op, jop)
    nf = N
    while nf > 8:
        nc = nf // 2
        MH, MV = (m.numpy() for m in multigrid._transfer_slot_matrices(
            hdi, 1.0 / nc, F64, device=CPU))
        jMH, jMV = jmg._transfer_slot_matrices(jhdi, 1.0 / nc, jnp.float64)
        for py in (0, 1):
            for px in (0, 1):
                for (o, M), (jo, jM) in zip(
                        multigrid._mloc_cells(MH, MV, py, px),
                        jmg._mloc_cells(np.asarray(jMH), np.asarray(jMV),
                                        py, px)):
                    assert o == jo
                    _close(M, jM)
        cells = np.arange(-1, nf * nf + 1)
        np.testing.assert_array_equal(
            multigrid._frozen_slot_mask(nf, cells, 4 * fbs),
            jmg._frozen_slot_mask(nf, cells, 4 * fbs))
        op = (op[0], multigrid.mask_pair_op(nf, *op))
        jop = (jop[0], jmg.mask_pair_op(nf, *jop))
        _same_pairop(op, jop)
        op = multigrid.galerkin_coarsen_pair_op(hdi, nc, *op)
        jop = jmg.galerkin_coarsen_pair_op(jhdi, nc, *jop)
        _same_pairop(op, jop)
        BHu, BVu, fH, fV = multigrid.pair_op_diag_data(nc, *op, fbs)
        jBHu, jBVu, jfH, jfV = jmg.pair_op_diag_data(nc, *jop, fbs)
        _close(BHu, jBHu)
        _close(BVu, jBVu)
        for f, jf in ((fH, jfH), (fV, jfV)):
            np.testing.assert_array_equal(f[0], jf[0])
            np.testing.assert_array_equal(f[1], jf[1])
            _close(f[2], jf[2])
        Bu, cells, blocks = multigrid.pair_op_cell_face_blocks(nc, *op, fbs)
        jBu, jcells, jblocks = jmg.pair_op_cell_face_blocks(nc, *jop, fbs)
        _close(Bu, jBu)
        np.testing.assert_array_equal(cells, jcells)
        _close(blocks, jblocks)
        _close(multigrid.pair_op_kernel(op[0]), jmg.pair_op_kernel(jop[0]))
        nf = nc
    _close(multigrid.pair_op_dense(8, *op, fbs),
           jmg.pair_op_dense(8, *jop, fbs))


def _galerkin_operator_data(fbs):
    """Seeded random data at 12 x 12 cells: a 5 x 5 stencil, deviation
    pairs with repeated rows, a random grid vector (JAX)."""
    rng = np.random.default_rng(fbs)
    n, nfd, P = 12, 4 * fbs, 40
    K = rng.standard_normal((nfd, nfd, 5, 5))
    rows = rng.integers(0, n * n, P)
    rows[:10] = rows[10:20]        # rows repeat
    cols = np.clip(rows + rng.integers(-n - 1, n + 2, P), 0, n * n - 1)
    blocks = rng.standard_normal((P, nfd, nfd))
    jx = jcl.GridVecCL(jnp.asarray(rng.standard_normal((fbs, n + 1, n))),
                       jnp.asarray(rng.standard_normal((fbs, n, n + 1))))
    return n, K, rows, cols, blocks, jx


def _jax_galerkin_operator(fbs):
    n, K, rows, cols, blocks, jx = _galerkin_operator_data(fbs)
    jsys = jstructured.make_structured_system(n, n, fbs)
    return dict(pairs=jmg.make_galerkin_operator_cl(
        jsys, jnp.asarray(K), jnp.asarray(rows), jnp.asarray(cols),
        jnp.asarray(blocks))(jx),
        stencil=jmg.make_galerkin_operator_cl(jsys, jnp.asarray(K))(jx))


for _fbs in (2, 3):
    REFS.add(f"galerkin_operator[{_fbs}]", "operator",
             f"make_galerkin_operator_cl(sys 12 x 12, fbs {_fbs}, K, rows, "
             f"cols, blocks)(x) and make_galerkin_operator_cl(sys, K)(x) on "
             f"seeded random data", _jax_galerkin_operator, seed=_fbs,
             fbs=_fbs)


@pytest.mark.parametrize("fbs", [2, 3])
def test_galerkin_operator_matches(fbs):
    """make_galerkin_operator_cl on seeded random data at 12 x 12 cells:
    a 5 x 5 stencil, deviation pairs with repeated rows, a random grid
    vector, 1e-12."""
    n, K, rows, cols, blocks, jx = _galerkin_operator_data(fbs)
    sys_ = structured.make_structured_system(n, n, fbs, device=CPU)
    ref = REFS[f"galerkin_operator[{fbs}]"]
    t = torch.as_tensor
    y = multigrid.make_galerkin_operator_cl(
        sys_, t(K), t(rows), t(cols), t(blocks))(
            convert.grid_vec_cl(jx, CPU))
    for a, b in zip(y, ref.pairs):
        _close(a, b)
    # without pairs: the constant stencil alone
    y = multigrid.make_galerkin_operator_cl(sys_, t(K))(
        convert.grid_vec_cl(jx, CPU))
    for a, b in zip(y, ref.stencil):
        _close(a, b)


GALERKIN_FIELDS = ("kernel", "blocks", "cblocks", "Bu_cell", "rows", "cols",
                   "cells", "coarse_Q", "coarse_winv")


def _jax_band_levels(N, k):
    """The JAX package's band_galerkin_levels of the port's fine level,
    level by level, with its galerkin_patch_setup on each coarse level's
    patch cells; and the digest of the port's level data."""
    out = dict(inputs=_level_inputs(N, k))
    for n, jg in _jax_galerkin(N, k).items():
        pids = fs.expand_ring(_levels(N, k)[n].cut_ids, n, 1)
        jsys = jstructured.make_structured_system(n, n, k + 1)
        out[n] = dict({f: getattr(jg, f) for f in GALERKIN_FIELDS},
                      patch=jmg.galerkin_patch_setup(jsys, jg, pids,
                                                     jnp.float64))
    return out


for _N, _k in ((16, 1), (16, 2)):
    REFS.add(f"band_levels[{_N}-{_k}]", "galerkin",
             f"band_galerkin_levels(the port's {_N}^2 k={_k} lean levels, "
             f"HHODegreeInfo({_k + 1}, {_k}), default_problem(), "
             f"nitsche_eta({_k})), and galerkin_patch_setup(sys, level, "
             f"expand_ring(cut_ids, n, 1)) per coarse level",
             _jax_band_levels, N=_N, k=_k)


@pytest.mark.parametrize("N,k", [(16, 1), (16, 2)])
def test_band_galerkin_levels_and_patch_setup_match(N, k):
    """band_galerkin_levels level by level (kernel, pairs, patch blocks;
    the coarsest pseudo-inverse as Q diag(winv) Q^T, 1e-10), then
    galerkin_patch_setup on the patch cells of each coarse level (the
    inverted blocks 1e-10, the weights 1e-12)."""
    gal = _galerkin(N, k)
    jgal = REFS.get(f"band_levels[{N}-{k}]", inputs=_level_inputs(N, k))
    assert sorted(gal) == sorted(int(n) for n in jgal._fields
                                 if n != "inputs") == \
        [n for n in _levels(N, k) if n < N]
    for n, g in gal.items():
        jg = jgal[n]
        for f in ("kernel", "blocks", "cblocks", "Bu_cell"):
            _close(getattr(g, f), getattr(jg, f))
        for f in ("rows", "cols", "cells"):
            np.testing.assert_array_equal(getattr(g, f).numpy(),
                                          np.asarray(getattr(jg, f)))
        assert (g.coarse_Q is None) == (jg.coarse_Q is None) == (n != 8)
        if g.coarse_Q is not None:
            pinv = (g.coarse_Q * g.coarse_winv) @ g.coarse_Q.T
            jQ = np.asarray(jg.coarse_Q)
            _close(pinv, (jQ * np.asarray(jg.coarse_winv)) @ jQ.T, 1e-10)
        pids = fs.expand_ring(_levels(N, k)[n].cut_ids, n, 1)
        sys_ = structured.make_structured_system(n, n, k + 1, device=CPU)
        out = multigrid.galerkin_patch_setup(sys_, g, pids, F64)
        jout = jg.patch
        _close(out[0], jout[0], 1e-10)
        for a, b in zip(out[1:], jout[1:]):
            _close(a, b)


def _vcycle_residuals(N, fbs):
    """The seeded residual r (JAX) and second vector s (the port's)."""
    rng = np.random.default_rng(32)
    jr = jcl.GridVecCL(jnp.asarray(rng.standard_normal((fbs, N + 1, N))),
                       jnp.asarray(rng.standard_normal((fbs, N, N + 1))))
    s = convert.grid_vec_cl(jcl.GridVecCL(
        jnp.asarray(rng.standard_normal((fbs, N + 1, N))),
        jnp.asarray(rng.standard_normal((fbs, N, N + 1)))), CPU)
    return jr, s


def _jax_galerkin_vcycles():
    """The JAX package's V-cycle over the Galerkin hierarchy of the port's
    32^2 k=1 levels at gamma 1 and 2, on the seeded residual (one jitted
    graph); and the digest of the port's level data."""
    N, k = 32, 1
    fbs = k + 1
    levels = _levels(N, k)
    cuts = {n: fs.expand_ring(lev.cut_ids, n, 1) for n, lev in levels.items()}
    jS = {n: jnp.asarray(lev.cond.dS.numpy()) for n, lev in levels.items()}
    jkw = dict(
        uniform_per_level={n: (lev.S_u.numpy(), np.asarray(lev.irr_ids))
                           for n, lev in levels.items()},
        cut_ids_per_level=cuts)
    jr, _ = _vcycle_residuals(N, fbs)

    def jax_cycles(r, S, galerkin):
        # one compiled graph, the arrays as arguments: the eager build
        # and cycles cost twice as much
        m = jmg.build_multigrid(N, fbs, S, hdi=JHHODegreeInfo(k + 1, k),
                                coarsest=8, n_smooth=1, smoother="chebyshev",
                                layout="cl", galerkin_per_level=galerkin,
                                **jkw)
        return tuple(m._replace(gamma=gamma).precondition(r)
                     for gamma in (1, 2))

    return dict(inputs=_vcycle_inputs(levels),
                cycles=jax.jit(jax_cycles)(jr, jS, _jax_galerkin(N, k)))


def _vcycle_inputs(levels):
    return [a for _, lev in sorted(levels.items()) for a in
            (lev.cond.dS, lev.S_u, np.asarray(lev.irr_ids),
             np.asarray(lev.cut_ids))]


REFS.add("vcycle", "vcycle",
         "build_multigrid(32, 2, dS per level, HHODegreeInfo(2, 1), "
         "coarsest=8, n_smooth=1, smoother='chebyshev', layout='cl', "
         "galerkin_per_level=band_galerkin_levels(...)).precondition(r) at "
         "gamma 1 and 2 under jax.jit, over the port's 32^2 k=1 levels",
         _jax_galerkin_vcycles, seed=32)


def test_vcycle_over_galerkin_levels_matches():
    """One V-cycle of build_multigrid(galerkin_per_level=...) over the
    32^2 k=1 hierarchy (32, 16, 8: the top gap re-visits at gamma 2) on a
    seeded residual, gamma 1 and 2, against the JAX package's over the
    same levels: 1e-10. The cycle stays symmetric, <M r, s> = <r, M s>."""
    N, k = 32, 1
    fbs = k + 1
    levels = _levels(N, k)
    gal = _galerkin(N, k)
    jr, s = _vcycle_residuals(N, fbs)
    r = convert.grid_vec_cl(jr, CPU)
    jcycles = REFS.get("vcycle", inputs=_vcycle_inputs(levels)).cycles
    mgrid = fs.level_multigrid(levels, HHODegreeInfo(k + 1, k),
                               galerkin=gal)
    for gamma, jz in zip((1, 2), jcycles):
        z = mgrid._replace(gamma=gamma).precondition(r)
        for a, b in zip(z, jz):
            _close(a, b, 1e-10)
        Ms = mgrid._replace(gamma=gamma).precondition(s)
        lhs = float(sum(torch.sum(a * b) for a, b in zip(z, s)))
        rhs = float(sum(torch.sum(a * b) for a, b in zip(r, Ms)))
        assert abs(lhs - rhs) <= 1e-10 * abs(lhs)


@pytest.mark.parametrize("N,k,gamma", sorted(JAX_GALERKIN))
def test_galerkin_solve_gates(N, k, gamma):
    """solve_fictdom_structured(mg_galerkin=True) at tol 1e-11 against the
    JAX package's numbers: iterations within 2, H1 rtol 1e-6 at k=1 and
    1e-4 at k=2; the Galerkin setup is timed."""
    r = fs.solve_fictdom_structured(
        N, k, mg_galerkin=True, mg_gamma=gamma, device="cpu",
        cg_params=cg.CGParams(1e-11, 1e8, 50000, True))
    iters, h1 = JAX_GALERKIN[(N, k, gamma)]
    assert r.exit_reason == cg.CONVERGED and r.rel_residual < 1e-11
    assert abs(r.iterations - iters) <= 2
    assert np.isclose(r.h1_error, h1, rtol=1e-6 if k == 1 else 1e-4)
    assert r.timings["galerkin_setup_s"] > 0


def _dense(apply, n, fbs):
    """The operator of ``apply`` on the n^2 grids, column by column, in
    the flat order of multigrid._flatten."""
    shapes = ((fbs, n + 1, n), (fbs, n, n + 1))
    eye = torch.eye(2 * fbs * n * (n + 1), dtype=F64)
    return torch.stack([multigrid._flatten(apply(
        multigrid._unflatten(e, shapes))) for e in eye], dim=1).numpy()


def _dense_16_8():
    """(the dense Galerkin operator of the 8^2 level, R A_f P from the
    16^2 lean operator and the transfers, the port's 16^2 levels and
    Galerkin levels)."""
    N, nc, k = 16, 8, 1
    fbs = k + 1
    hdi = HHODegreeInfo(k + 1, k)
    levels = _levels(N, k)
    fine = levels[N]
    sys_f = structured.make_structured_system(N, N, fbs, device=CPU)
    sys_c = structured.make_structured_system(nc, nc, fbs, device=CPU)
    A_f = cells_last.make_uniform_operator_cl(sys_f, fine.S_u, fine.irr_ids,
                                              fine.cond.dS)
    gal = _galerkin(N, k)
    g = gal[nc]
    A_c = multigrid.make_galerkin_operator_cl(sys_c, g.kernel, g.rows,
                                              g.cols, g.blocks)
    prol = multigrid.make_reconstruction_prolongation_cl(sys_f, sys_c, hdi,
                                                         1.0 / nc)
    restr = multigrid.make_reconstruction_restriction_cl(sys_f, sys_c, hdi,
                                                         1.0 / nc)
    return (_dense(A_c, nc, fbs),
            _dense(lambda v: restr(A_f(prol(v))), nc, fbs), levels, gal)


def test_galerkin_engine_matches_dense_rap():
    """The engine's 8^2 operator equals the dense R A_f P of the 16^2 cut
    problem on the free dofs, 1e-9 (domain-boundary masking and
    phantom-pair cancellations included; JAX's test of the same name)."""
    ENG, RAP, _, _ = _dense_16_8()
    frozen = (np.abs(np.diag(ENG) - 1) < 1e-13) & \
        ((np.abs(ENG) > 1e-13).sum(0) == 1)
    free = ~frozen
    D = (ENG - RAP)[np.ix_(free, free)]
    assert np.abs(D).max() < 1e-9 * max(1.0, np.abs(RAP).max())


def test_galerkin_patch_blocks_are_exact_restrictions():
    """galerkin_patch_setup's blocks equal the dense Galerkin operator
    restricted to each patch cell's 4 faces, 1e-9 (JAX's test of the same
    name)."""
    nc, fbs = 8, 2
    Ad, _, levels, gal = _dense_16_8()
    sys_c = structured.make_structured_system(nc, nc, fbs, device=CPU)
    pids = fs.expand_ring(levels[nc].cut_ids, nc, 1)
    B = np.linalg.inv(multigrid.galerkin_patch_setup(
        sys_c, gal[nc], pids, F64)[0].numpy())
    nH = fbs * (nc + 1) * nc

    def face_dofs(kind, j, i):
        if kind == "H":
            return [m * (nc + 1) * nc + j * nc + i for m in range(fbs)]
        return [nH + m * nc * (nc + 1) + j * (nc + 1) + i for m in range(fbs)]

    err = 0.0
    for c, pid in enumerate(pids):
        jj, ii = pid // nc, pid % nc
        dofs = np.array(sum((face_dofs(*f) for f in (
            ("H", jj, ii), ("V", jj, ii + 1), ("H", jj + 1, ii),
            ("V", jj, ii))), []))
        err = max(err, np.abs(B[c] - Ad[np.ix_(dofs, dofs)]).max())
    assert err < 1e-9 * max(1.0, np.abs(B).max())
