"""Kernel K1 (proton_tpu_torch/methods/fused_assembly.py) against the JAX
package: the plain version on the CPU against poisson.assemble_local and
the Pallas kernel in interpret mode. The CUDA kernel is held against the
plain version on the card in tests/test_torch_cuda.py.

The Pallas kernel runs live. The JAX package's assemble_local is read
from tests/jax_refs/test_torch_fused_assembly.npz (REFS below;
tests/torch_jax_reference.py writes it on the same meshes)."""

import dataclasses
import re

import numpy as np
import jax.numpy as jnp
import pytest
import threadpoolctl
import torch

import proton_tpu as pt
from proton_tpu.core.geometry import cell_geometry as jcell_geometry
from proton_tpu.core.ops import HHODegreeInfo as JHDI
from proton_tpu.methods import pallas_assembly, poisson
from proton_tpu_torch import convert, native
from proton_tpu_torch.core.geometry import cell_geometry
from proton_tpu_torch.core.mesh import make_poly_mesh
from proton_tpu_torch.core.ops import HHODegreeInfo
from proton_tpu_torch.methods import fused_assembly as fa
from torch_jax_reference import Refs

CPU = torch.device("cpu")
REFS = Refs(__name__)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """BLAS and torch on one thread: with a pool per core in every test
    worker the cores are oversubscribed many times over."""
    with threadpoolctl.threadpool_limits(1):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)


def _jittered_mesh(N, seed):
    """The generated N x N mesh with interior points moved (general
    convex quads), as a JAX mesh and its port."""
    jm = pt.make_poly_mesh(Nx=N, Ny=N)
    pts = np.asarray(jm.points).copy()
    rng = np.random.default_rng(seed)
    inner = (pts > 0).all(1) & (pts < 1).all(1)
    pts[inner] += rng.uniform(-0.15 / N, 0.15 / N, (inner.sum(), 2))
    jm = jm.with_points(jnp.asarray(pts))
    return jm, convert.mesh(jm, CPU)


def _rel(a, ref):
    return float(np.max(np.abs(a - ref)) / np.max(np.abs(ref)))


def _jax_assemble_local(k, jitter):
    """poisson.assemble_local(..., 'naive') of the JAX package on the 8x8
    mesh, jittered with seed k or not."""
    jm = _jittered_mesh(8, k)[0] if jitter else pt.make_poly_mesh(Nx=8, Ny=8)
    return poisson.assemble_local(jm, jcell_geometry(jm), JHDI(k + 1, k),
                                  "naive")[1]


for _k in (0, 1, 2):
    for _jitter in (False, True):
        REFS.add(f"assemble_local[{_k}-{_jitter}]", "operator",
                 f"poisson.assemble_local(make_poly_mesh(8, 8)"
                 + (f" jittered (seed {_k})" if _jitter else "")
                 + f", cell_geometry, HHODegreeInfo({_k + 1}, {_k}), "
                 f"'naive')", _jax_assemble_local,
                 seed=_k if _jitter else None, k=_k, jitter=_jitter)


@pytest.mark.parametrize("jitter", [False, True])
@pytest.mark.parametrize("k", [0, 1, 2])
def test_plain_matches_assemble_local(k, jitter):
    """Plain K1 == poisson.assemble_local(..., 'naive') on 8x8, 1e-12
    relative."""
    if jitter:
        _, tm = _jittered_mesh(8, k)
    else:
        tm = make_poly_mesh(Nx=8, Ny=8, device=CPU)
    ref = REFS[f"assemble_local[{k}-{jitter}]"]
    lc = fa.fitted_local_operator(tm, cell_geometry(tm),
                                  HHODegreeInfo(k + 1, k))
    assert _rel(lc.numpy(), np.asarray(ref)) < 1e-12


def test_plain_matches_pallas_interpret():
    """Plain K1 == the Pallas kernel in interpret mode at k=1 (cells-last),
    1e-12 relative."""
    jm, tm = _jittered_mesh(8, 7)
    ref = pallas_assembly.fitted_local_operator(
        jm, jcell_geometry(jm), JHDI(2, 1), interpret=True, cells_last=True)
    lc = fa.fitted_local_operator(tm, cell_geometry(tm), HHODegreeInfo(2, 1),
                                  cells_last=True)
    assert lc.shape == ref.shape
    assert _rel(lc.numpy(), np.asarray(ref)) < 1e-12


REFS.add("equal_order", "operator",
         "poisson.assemble_local(make_quad_mesh(5, 3), cell_geometry, "
         "HHODegreeInfo(1, 1), 'naive')",
         lambda: poisson.assemble_local(
             jm := pt.make_quad_mesh(Nx=5, Ny=3), jcell_geometry(jm),
             JHDI(1, 1), "naive")[1])


def test_equal_order_and_ragged_cell_count():
    """15 cells (no multiple of any block size) with HHODegreeInfo(1, 1)."""
    jm = pt.make_quad_mesh(Nx=5, Ny=3)
    ref = REFS["equal_order"]
    tm = convert.mesh(jm, CPU)
    lc = fa.fitted_local_operator(tm, cell_geometry(tm), HHODegreeInfo(1, 1))
    assert lc.shape == (15, 11, 11)
    np.testing.assert_allclose(lc.numpy(), np.asarray(ref), atol=1e-11)


def test_rejects_general_polygons():
    tm = dataclasses.replace(make_poly_mesh(Nx=3, Ny=3, device=CPU),
                             all_quads=False)
    with pytest.raises(ValueError):
        fa.fitted_local_operator(tm, cell_geometry(tm), HHODegreeInfo(1, 1))


def test_checks_inputs():
    tm = make_poly_mesh(Nx=3, Ny=3, device=CPU)
    inp = fa.pack_inputs(tm, cell_geometry(tm))
    with pytest.raises(ValueError, match="shape"):
        fa.fused_local_operator(inp[0][:, :, :5], *inp[1:], 2, 1)
    with pytest.raises(ValueError, match="dtype"):
        fa.fused_local_operator(inp[0].float(), *inp[1:], 2, 1)


def test_cpu_tensors_take_the_plain_path():
    """On CPU tensors the wrapper returns the plain version and launches
    nothing."""
    tm = make_poly_mesh(Nx=4, Ny=4, device=CPU)
    inp = fa.pack_inputs(tm, cell_geometry(tm))
    before = fa.fused_local_operator.launches
    out = fa.fused_local_operator(*inp, 2, 1)
    assert fa.fused_local_operator.launches == before
    torch.testing.assert_close(out, fa.fitted_local_operator_plain(*inp, 2, 1),
                               rtol=0, atol=0)


def _compiled_constant(name: str, cd: int, fd: int) -> int:
    """A per-degree-pair constant of csrc/fused_assembly.cu: the body of
    ``constexpr int <name>(int cd, int fd)``, a chain c1 ? v1 : ... : vn."""
    src = (native.CSRC / "fused_assembly.cu").read_text()
    body = re.search(r"constexpr int " + name + r"\(int cd, int fd\) \{\s*"
                     r"return ([^;]*);", src).group(1)
    *branches, default = body.split(":")
    for branch in branches:
        cond, value = branch.split("?")
        if eval(cond.replace("&&", " and "), {"cd": cd, "fd": fd}):
            return int(value)
    return int(default)


def test_launch_geometry_table():
    """Every instantiation's launch geometry matches the kernel source
    (tile = kTile, warps = warps_for), its shared memory is the kernel's
    rows x tile x bytes and fits in a block's 227 KB, and the blocks per SM
    the registers are cut for (min_blocks_for) fit in the SM's 228 KB of
    shared memory (1 KB of it reserved per block)."""
    pairs = {(1, 0), (2, 1), (3, 2), (1, 1)}
    assert set(fa.LAUNCH_GEOMETRY) == {(dt, cd, fd) for dt in
                                       (torch.float64, torch.float32)
                                       for cd, fd in pairs}
    src = (native.CSRC / "fused_assembly.cu").read_text()
    k_tile = int(re.search(r"constexpr int kTile = (\d+);", src).group(1))
    for (dtype, cd, fd), (tile, warps, smem) in fa.LAUNCH_GEOMETRY.items():
        item = torch.finfo(dtype).bits // 8
        assert tile == k_tile == 32
        assert warps == _compiled_constant("warps_for", cd, fd)
        assert smem == fa.shared_rows(cd, fd) * tile * item
        assert smem <= 232448
        assert (smem + 1024) * _compiled_constant("min_blocks_for", cd, fd) <= 233472
    # k=1: inputs 40, moments 6, K 15, gr 5 x 14, face factors 4 x 3,
    # solved traces 4 x 2 x 6
    assert fa.shared_rows(2, 1) == 40 + 6 + 15 + 70 + 12 + 48
