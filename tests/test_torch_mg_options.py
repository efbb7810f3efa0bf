"""The multigrid options the JAX package keeps off by default, ported in
proton_tpu_torch, against proton_tpu on the CPU, float64: the cut-aware
transfer correction (prolongation, restriction, their adjointness), the
reconstruction-map deviations of a coarse level, the interface-band
deflation, one V-cycle apply for each option (cheb_ops 'mixed' and
'uniform', mg_transfer 'smoothed' and 'cut', mg_deflate=4) over the JAX
package's own 16^2 and 8^2 lean levels, and the ValueErrors where the
JAX package ignores an option (the bench's knobs:
tests/test_torch_bench.py). The end-to-end solves with each option and
the family app in float32 are in tests/test_torch_mg_options_solve.py.

The JAX package's side of the transfers, the deviations and the V-cycles,
and its levels, are read from tests/jax_refs/test_torch_mg_options.npz
(REFS below; tests/torch_jax_reference.py writes it, running the JAX
package alone, with its own transfer builders, on the same seeded
inputs; each V-cycle under jax.jit over the stored levels). BLAS and
torch run on one thread."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import threadpoolctl
import torch

from proton_tpu.cut import fictdom_structured as jfs
from proton_tpu.core.ops import HHODegreeInfo as JHHODegreeInfo
from proton_tpu.methods import cells_last as jcl, structured as jstructured
from proton_tpu.solvers import multigrid as jmg
from proton_tpu_torch import convert
from proton_tpu_torch.core.ops import HHODegreeInfo
from proton_tpu_torch.cut import fictdom_structured as fs
from proton_tpu_torch.methods import cells_last, structured
from proton_tpu_torch.solvers import multigrid
from torch_jax_reference import Refs

CPU = torch.device("cpu")
F64 = torch.float64
REFS = Refs(__name__)
# The V-cycle options, as solve_fictdom_structured keywords.
OPTIONS = {"cheb_mixed": dict(cheb_ops="mixed"),
           "cheb_uniform": dict(cheb_ops="uniform"),
           "smoothed": dict(mg_transfer="smoothed"),
           "cut": dict(mg_transfer="cut"), "deflate": dict(mg_deflate=4)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Keeps BLAS and torch on one thread."""
    with threadpoolctl.threadpool_limits(1):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)


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
    """(port prolongation, restriction), 16^2 <- 8^2, with the correction
    (IDS, drec)."""
    hdi = HHODegreeInfo(k + 1, k)
    fbs = k + 1
    sf, sc = (structured.make_structured_system(n, n, fbs, device=CPU)
              for n in (16, 8))
    PH, PV = multigrid._transfer_face_projectors(hdi, 0.125, device=CPU)
    corr = (IDS, torch.as_tensor(drec), PH, PV) if corr_on else None
    return (multigrid.make_reconstruction_prolongation_cl(
                sf, sc, hdi, 0.125, corr=corr),
            multigrid.make_reconstruction_restriction_cl(
                sf, sc, hdi, 0.125, corr=corr))


def _drec(k, seed):
    rbs = (k + 2) * (k + 3) // 2
    return 0.3 * np.random.default_rng(seed).standard_normal(
        (rbs * 4 * (k + 1), len(IDS)))


def _jax_corrected_transfers(k):
    """The JAX package's cut-aware prolongation of a random coarse grid
    plus its restriction of a random fine one, 16^2 <- 8^2, with its own
    transfer matrices and face projectors and the correction (IDS,
    _drec(k, k))."""
    jhdi = JHHODegreeInfo(k + 1, k)
    jf, jc = (jstructured.make_structured_system(n, n, k + 1)
              for n in (16, 8))
    PH, PV = jmg._transfer_face_projectors(jhdi, 0.125)
    jcorr = (IDS, jnp.asarray(_drec(k, k)), PH, PV)
    mats = jmg._transfer_slot_matrices(jhdi, 0.125, jnp.float64)
    jp = jmg.make_reconstruction_prolongation_cl(
        jf, jc, jhdi, 0.125, jnp.float64, mats=mats, corr=jcorr)
    jr = jmg.make_reconstruction_restriction_cl(
        jf, jc, jhdi, 0.125, jnp.float64, mats=mats, corr=jcorr)
    rng = np.random.default_rng(10 + k)
    jxc, jrf = _grid(rng, k + 1, 8), _grid(rng, k + 1, 16)
    return jax.jit(jp)(jxc) + jax.jit(jr)(jrf)


for _k in (1, 2):
    REFS.add(f"corrected_transfers[{_k}]", "transfer",
             f"make_reconstruction_prolongation_cl(corr=...)(x_c) + "
             f"make_reconstruction_restriction_cl(corr=...)(r_f), k={_k}, "
             f"16^2 <- 8^2, drec 0.3 * N(0, 1) seed {_k}",
             _jax_corrected_transfers, seed=[_k, 10 + _k], k=_k)


@pytest.mark.parametrize("k", [1, 2])
def test_corrected_transfers_match(k):
    """The cut-aware prolongation and restriction against the JAX
    package's on the same random drec and ids, 16^2 <- 8^2, 1e-12
    relative. Cells that share a face add to the same fine slots: JAX's
    .at[].add sums them, and so must the port."""
    p, r = _transfer_pair(k, _drec(k, k))
    rng = np.random.default_rng(10 + k)
    jxc, jrf = _grid(rng, k + 1, 8), _grid(rng, k + 1, 16)
    out = p(convert.grid_vec_cl(jxc, CPU)) + r(convert.grid_vec_cl(jrf, CPU))
    for a, b in zip(out, REFS[f"corrected_transfers[{k}]"]):
        _close(a, b, 1e-12)


@pytest.mark.parametrize("k", [1, 2])
def test_corrected_transfers_are_adjoint(k):
    """<P x, y> = <x, R y> with a random correction, to 1e-10: the
    restriction stays the exact adjoint, or the V-cycle is no longer a
    symmetric CG preconditioner."""
    p, r = _transfer_pair(k, _drec(k, 20 + k))
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
    p0, r0 = _transfer_pair(k, zero, corr_on=False)
    p1, r1 = _transfer_pair(k, zero)
    rng = np.random.default_rng(40 + k)
    xc = convert.grid_vec_cl(_grid(rng, k + 1, 8), CPU)
    yf = convert.grid_vec_cl(_grid(rng, k + 1, 16), CPU)
    for a, b in zip(p0(xc) + r0(yf), p1(xc) + r1(yf)):
        assert float((a - b).abs().max()) <= 1e-14


# ---------------------------------------------------------------------------
# The JAX package's own levels, built once
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_level_data():
    """The JAX package's lean 16^2 level (with its right-hand side) and
    its 8^2 coarse level (build_coarse_level: on the CPU it carries drec),
    k=1."""
    hdi, problem = JHHODegreeInfo(2, 1), jfs.default_problem()
    eta = jfs.nitsche_eta(1)
    return {16: jfs.build_level(16, hdi, problem, eta, 4, False, False,
                                with_rhs=True, fitted="lean"),
            8: jfs.build_coarse_level(8, hdi, problem, eta, 4, False)}


def _jax_levels():
    """What the tests read of _jax_level_data: ids, S_u, dS; drec at 8^2."""
    return {n: dict(cut_ids=lev.cut_ids, irr_ids=lev.irr_ids, S_u=lev.S_u,
                    cond=dict(dS=lev.cond.dS),
                    **({"drec": lev.drec} if n == 8 else {}))
            for n, lev in _jax_level_data().items()}


REFS.add("levels", "level",
         "build_level(16, HHODegreeInfo(2, 1), default_problem(), "
         "nitsche_eta(1), 4, False, False, with_rhs=True, fitted='lean') "
         "and build_coarse_level(8, ..., 4, False)", _jax_levels)


def _jax_recdev(k):
    """_level_recdev of the 8^2 coarse level's cut batch at degree k: its
    float64 value (the batch's ids as floats) and the value it stores
    (float32; at k=1 the level's own drec)."""
    jlev = _jax_level_data()[8]
    jhdi, jproblem = JHHODegreeInfo(k + 1, k), jfs.default_problem()

    def jax_drec(batch):
        return jfs._level_recdev(batch, jlev.cut_ids, jlev.irr_ids, jhdi,
                                 jproblem, jfs.nitsche_eta(k), 8)

    return dict(f64=jax_drec(jlev.batch._replace(
        ids=jlev.batch.ids.astype(jnp.float64))),
        stored=jlev.drec if k == 1 else jax_drec(jlev.batch))


for _k in (1, 2):
    REFS.add(f"recdev[{_k}]", "deviation",
             f"_level_recdev(batch, cut_ids, irr_ids, HHODegreeInfo({_k + 1}, "
             f"{_k}), default_problem(), nitsche_eta({_k}), 8) on the 8^2 "
             f"coarse level's batch, with float ids and as it is",
             _jax_recdev, k=_k)


@pytest.fixture(scope="module")
def jax_levels():
    """The stored levels of _jax_level_data."""
    return REFS["levels"]


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
    jdrec = REFS[f"recdev[{k}]"]
    rbs, nfd = (k + 2) * (k + 3) // 2, 4 * (k + 1)
    assert lev.drec.dtype == F64
    assert tuple(lev.drec.shape) == (rbs * nfd, len(lev.irr_ids))
    _close(lev.drec, jdrec.f64, 1e-10)
    stored = jdrec.stored
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


def _jax_vcycle(jax_levels, name):
    """The JAX package's V-cycle with option ``name`` (and its deflation)
    applied to the random residual of the test, over the stored levels."""
    rng = np.random.default_rng(7)
    jr = _grid(rng, 2, 16)
    return _jax_preconditioner(jax_levels, OPTIONS[name])(jr.H, jr.V)


for _name, _option in OPTIONS.items():
    REFS.add(f"vcycle[{_name}]", "vcycle",
             f"build_multigrid(16, 2, layout='cl', coarsest=8, n_smooth=1, "
             f"smoother='chebyshev', {_option}).precondition(r) over the "
             f"stored levels, under jax.jit", _jax_vcycle,
             needs=("levels",), seed=7, name=_name)


@pytest.mark.parametrize("name", list(OPTIONS))
def test_vcycle_option_matches_and_is_symmetric(jax_levels, name):
    """One V-cycle apply with each option against the JAX package's on the
    same lean 16^2 / 8^2 levels and random residual, 1e-10 relative, and
    its symmetry <M r, s> = <r, M s> to 1e-10."""
    pre = _port_preconditioner(jax_levels, OPTIONS[name])
    rng = np.random.default_rng(7)
    jr, js = _grid(rng, 2, 16), _grid(rng, 2, 16)
    r, s = convert.grid_vec_cl(jr, CPU), convert.grid_vec_cl(js, CPU)
    Mr, Ms = pre(r), pre(s)
    for a, b in zip(Mr, REFS[f"vcycle[{name}]"]):
        _close(a, b, 1e-10)
    lhs, rhs = _dot(Mr, s), _dot(r, Ms)
    assert abs(lhs - rhs) <= 1e-10 * abs(lhs)


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
