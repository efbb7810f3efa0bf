"""The port's multigrid transfers against proton_tpu on the CPU, float64:
the transfer matrices of a coarse cell, prolongation and restriction
(and their adjoint identity), the level sizes, the patch rings and the
coarsest factor. The V-cycle is in tests/test_torch_multigrid.py.

The JAX package's transfer-matrix builders are pure functions of (hdi, h);
this module runs its own under jax.jit, once each (the same arrays, memoized:
tests/torch_jax_reference.py), as the store of JAX references that the
port's test files read was written. The JAX prolongation and restriction
applied to random grids with those matrices are read from
tests/jax_refs/test_torch_multigrid_transfers.npz (REFS below)."""

import numpy as np
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
from proton_tpu_torch.methods import structured
from proton_tpu_torch.solvers import multigrid
from torch_jax_reference import Refs, jax_transfer_builders

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


def _systems(nf, nc, fbs):
    return (structured.make_structured_system(nf, nf, fbs, device=CPU),
            structured.make_structured_system(nc, nc, fbs, device=CPU))


@pytest.fixture(autouse=True, scope="module")
def _memoized_jax_transfers_one_thread():
    """Memoize the JAX package's own _transfer_face_projectors,
    _unit_recmap and _transfer_slot_matrices for this module, each run
    under jax.jit, and keep BLAS and torch on one thread."""
    with pytest.MonkeyPatch.context() as mp, \
            threadpoolctl.threadpool_limits(1):
        jax_transfer_builders(mp)
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


def _jax_prolongation_restriction(k):
    """The JAX package's prolongation of a random 8^2 grid and restriction
    of a random 16^2 one, with its own transfer matrices of the coarse
    cell of side 1/8."""
    fbs = k + 1
    jhdi = JHHODegreeInfo(k + 1, k)
    jf, jc = (jstructured.make_structured_system(n, n, fbs) for n in (16, 8))
    rng = np.random.default_rng(k)
    jxc, jrf = _grid(rng, fbs, 8), _grid(rng, fbs, 16)
    jp = jmg.make_reconstruction_prolongation_cl(
        jf, jc, jhdi, 0.125, jnp.float64, mats=_jax_mats(k))(jxc)
    jr = jmg.make_reconstruction_restriction_cl(
        jf, jc, jhdi, 0.125, jnp.float64, mats=_jax_mats(k))(jrf)
    return jp + jr


for _k in (1, 2):
    REFS.add(f"prolongation_restriction[{_k}]", "transfer",
             f"make_reconstruction_prolongation_cl(16^2 <- 8^2, "
             f"HHODegreeInfo({_k + 1}, {_k}), 1/8, mats=own)(x_c) + "
             f"make_reconstruction_restriction_cl(...)(r_f) on random grids",
             _jax_prolongation_restriction, seed=_k, k=_k)


@pytest.mark.parametrize("k", [1, 2])
def test_prolongation_and_restriction_match(k):
    """Port against JAX on random grids, 16^2 <- 8^2, 1e-12. The port
    computes its own transfer matrices; the JAX side is handed the ones
    test_transfer_slot_matrices_match compares them with."""
    fbs = k + 1
    hdi = HHODegreeInfo(k + 1, k)
    sf, sc = _systems(16, 8, fbs)
    rng = np.random.default_rng(k)
    jxc, jrf = _grid(rng, fbs, 8), _grid(rng, fbs, 16)
    p = multigrid.make_reconstruction_prolongation_cl(sf, sc, hdi, 0.125)(
        convert.grid_vec_cl(jxc, CPU))
    r = multigrid.make_reconstruction_restriction_cl(sf, sc, hdi, 0.125)(
        convert.grid_vec_cl(jrf, CPU))
    for a, b in zip(p + r, REFS[f"prolongation_restriction[{k}]"]):
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
