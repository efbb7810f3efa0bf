"""Tests of proton_tpu_torch that need an NVIDIA GPU: each hand-written
kernel against its plain PyTorch version on the card, and the default
solve on the card against the same solve on the CPU. They skip with a
reason where no card is present. This file imports neither JAX nor
proton_tpu, so on a machine without JAX it runs alone:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from proton_tpu_torch.core.geometry import cell_geometry
from proton_tpu_torch.core.mesh import make_poly_mesh
from proton_tpu_torch.cut import fictdom_structured as fs
from proton_tpu_torch.methods import fused_assembly as fa
from proton_tpu_torch.solvers import cg


def _jittered_cuda_mesh(N, seed):
    """The generated N x N mesh with interior points moved (general
    convex quads), on the card."""
    mesh = make_poly_mesh(Nx=N, Ny=N, device="cuda")
    pts = mesh.points.cpu().numpy()
    rng = np.random.default_rng(seed)
    inner = (pts > 0).all(1) & (pts < 1).all(1)
    pts[inner] += rng.uniform(-0.15 / N, 0.15 / N, (inner.sum(), 2))
    return mesh.with_points(torch.as_tensor(pts, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-11),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("cd,fd", [(1, 0), (2, 1), (3, 2), (1, 1)])
def test_fused_assembly_kernel_matches_plain(cd, fd, dtype, tol):
    """K1 against its plain version on a jittered 37x37 mesh (a ragged
    last block), max|diff| / max|plain| < tol."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mesh = _jittered_cuda_mesh(37, 3)
    inp = tuple(a.to(dtype) for a in fa.pack_inputs(mesh, cell_geometry(mesh)))
    before = fa.fused_local_operator.launches
    out = fa.fused_local_operator(*inp, cd, fd)
    torch.cuda.synchronize()
    assert fa.fused_local_operator.launches == before + 1
    ref = fa.fitted_local_operator_plain(*inp, cd, fd)
    assert float((out - ref).abs().max() / ref.abs().max()) < tol


@pytest.mark.cuda
def test_fused_assembly_kernel_rejects_bad_layout():
    """A non-contiguous input on the card raises instead of launching."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mesh = make_poly_mesh(Nx=8, Ny=8, device="cuda")
    inp = list(fa.pack_inputs(mesh, cell_geometry(mesh)))
    inp[1] = inp[1].T.contiguous().T
    with pytest.raises(ValueError, match="contiguous"):
        fa.fused_local_operator(*inp, 2, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-11),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("cd,fd", [(1, 0), (2, 1), (3, 2), (1, 1)])
@pytest.mark.parametrize("nx,ny", [(1, 1), (5, 3)])
def test_fused_assembly_kernel_partial_tile(nx, ny, cd, fd, dtype, tol):
    """K1 on meshes of fewer cells than one tile (C = 1 and C = 15)
    against its plain version, max|diff| / max|plain| < tol."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mesh = make_poly_mesh(Nx=nx, Ny=ny, device="cuda")
    inp = tuple(a.to(dtype) for a in fa.pack_inputs(mesh, cell_geometry(mesh)))
    out = fa.fused_local_operator(*inp, cd, fd)
    torch.cuda.synchronize()
    ref = fa.fitted_local_operator_plain(*inp, cd, fd)
    assert out.shape == ref.shape == (ref.shape[0], nx * ny)
    assert float((out - ref).abs().max() / ref.abs().max()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("cd,fd", [(2, 1), (3, 2)])
def test_fused_assembly_kernel_is_deterministic(cd, fd):
    """Two launches on the same inputs give bitwise equal results."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mesh = _jittered_cuda_mesh(37, 5)
    inp = fa.pack_inputs(mesh, cell_geometry(mesh))
    first = fa.fused_local_operator(*inp, cd, fd)
    second = fa.fused_local_operator(*inp, cd, fd)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_fused_assembly_kernel_rejects_other_geometry():
    """A launch geometry that differs from the compiled one raises and
    leaves the output untouched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mesh = make_poly_mesh(Nx=8, Ny=8, device="cuda")
    inp = fa.pack_inputs(mesh, cell_geometry(mesh))
    tile, warps, smem = fa.LAUNCH_GEOMETRY[(torch.float64, 2, 1)]
    out = torch.zeros((14 * 14, 64), dtype=torch.float64, device="cuda")
    for geometry in ((tile // 2, warps, smem // 2), (tile, warps + 1, smem),
                     (tile, warps, smem + 8)):
        with pytest.raises(RuntimeError, match="geometry"):
            fa._launch(inp, out, 2, 1, geometry)
    torch.cuda.synchronize()
    assert not out.any()


@pytest.mark.cuda
@pytest.mark.parametrize("fitted", ["lean", "full"])
def test_multigrid_solve_on_card_matches_cpu(fitted):
    """The multigrid-preconditioned 32^2 k=1 solve on the card (K1 on the
    unit cell and the displaced cells, or on every cell) against the same
    solve on the CPU (the plain version): equal iteration counts, local
    dofs within 1e-9; K1 was launched on every level."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    params = cg.CGParams(convergence_threshold=1e-12,
                         divergence_threshold=1e8, max_iter=50000,
                         apply_preconditioner=True)
    fs._unit_cell_host.cache_clear()
    before = fa.fused_local_operator.launches
    card = fs.solve_fictdom_structured(32, 1, fitted=fitted, cg_params=params)
    launched = fa.fused_local_operator.launches - before
    host = fs.solve_fictdom_structured(32, 1, fitted=fitted,
                                       cg_params=params, device="cpu")
    assert card.local.device.type == "cuda"
    assert launched >= 3        # 32^2, 16^2 and 8^2
    assert card.exit_reason == host.exit_reason == cg.CONVERGED
    assert abs(card.iterations - host.iterations) <= 1
    assert float((card.local.cpu() - host.local).abs().max()) < 1e-9
    assert np.isclose(card.h1_error, host.h1_error, rtol=1e-7)
