"""Tests of proton_tpu_torch that need an NVIDIA GPU: each hand-written
kernel against its plain PyTorch version on the card, the default solve,
the uncut HHO path and the generic cut solves on the card against the
same computations on the CPU, and the V-cycle's CUDA graph against the
V-cycle run op by op. They skip with a
reason where no card is present. This file imports neither JAX nor
proton_tpu, so on a machine without JAX it runs alone:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from proton_tpu_torch.core.geometry import cell_geometry
from proton_tpu_torch.core.mesh import load_poly_mesh, make_poly_mesh
from proton_tpu_torch.core.ops import HHODegreeInfo, cell_rhs
from proton_tpu_torch.cut import fictdom_structured as fs
from proton_tpu_torch.methods import assembly, condensation, hho, poisson
from proton_tpu_torch.methods import fused_assembly as fa
from proton_tpu_torch.methods.cells_last import GridVecCL
from proton_tpu_torch.solvers import cg, multigrid
from proton_tpu_torch.tools.brick_mesh import write_brick_mesh


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


def _uncut_meshes(tmp_path):
    """The jittered 37 x 37 quad mesh and the 12 x 9 brick mesh (4-, 5-
    and 6-gons), on the card."""
    write_brick_mesh(tmp_path / "brick.txt", 12, 9)
    return {"jittered": _jittered_cuda_mesh(37, 7),
            "brick": load_poly_mesh(str(tmp_path / "brick.txt"),
                                    device="cuda")}


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [(2, 1), (1, 1), (3, 2)])
def test_hho_operators_on_card_match_cpu(tmp_path, hd):
    """hho_laplacian and both stabilizations on the card against the
    same functions on the CPU, 1e-12 relative, on a jittered quad mesh
    and on a brick mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    hdi = HHODegreeInfo(*hd)
    for mesh in _uncut_meshes(tmp_path).values():
        host = dataclasses.replace(mesh, **{
            f: getattr(mesh, f).cpu() for f in (
                "points", "cell_ptids", "cell_npts", "cell_faces",
                "face_ptids", "face_bnd")})
        outs = []
        for m in (mesh, host):
            g = cell_geometry(m)
            oper, data = hho.hho_laplacian(m, g, hdi)
            outs.append((oper, data, hho.naive_stabilization(m, g, hdi),
                         hho.fancy_stabilization(m, g, hdi, oper)))
        for a, b in zip(*outs):
            assert a.device.type == "cuda"
            assert float((a.cpu() - b).abs().max() / b.abs().max()) < 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("cd,fd", [(1, 0), (2, 1), (3, 2)])
def test_fused_assembly_kernel_matches_generic_naive_path(cd, fd):
    """K1 on the jittered 37 x 37 mesh against hho_laplacian's data +
    naive_stabilization on the card, max|diff| / max|K1| < 1e-11."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mesh = _jittered_cuda_mesh(37, 9)
    geom = cell_geometry(mesh)
    hdi = HHODegreeInfo(cd, fd)
    k1 = fa.fused_local_operator(*fa.pack_inputs(mesh, geom), cd, fd)
    lc = hho.hho_laplacian(mesh, geom, hdi)[1] + \
        hho.naive_stabilization(mesh, geom, hdi)
    d = lc.shape[1]
    generic = lc.permute(1, 2, 0).reshape(d * d, -1)
    assert float((generic - k1).abs().max() / k1.abs().max()) < 1e-11


@pytest.mark.cuda
def test_poisson_solves_on_card_match_cpu():
    """solve_poisson and solve_condensed (gather form) at 32^2 k=1 on the
    card against the CPU: equal iteration counts, local dofs within
    1e-10."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pi = np.pi
    sol = lambda p: torch.sin(pi * p[..., 0]) * torch.sin(pi * p[..., 1])
    rhs = lambda p: 2 * pi ** 2 * sol(p)
    hdi = HHODegreeInfo(2, 1)
    runs = {}
    for dev in ("cuda", "cpu"):
        mesh = make_poly_mesh(Nx=32, Ny=32, device=dev)
        dm = assembly.build_dofmap(mesh, hdi)
        full = poisson.solve_poisson(mesh, dm, hdi, rhs, sol)
        geom = cell_geometry(mesh)
        _, lc = poisson.assemble_local(mesh, geom, hdi)
        g = assembly.local_dirichlet_data(
            dm, mesh, assembly.dirichlet_face_data(mesh, hdi, sol))
        local, res = condensation.solve_condensed(
            dm, lc, cell_rhs(mesh, geom, hdi.cell_degree, rhs), g,
            assembly.build_face_incidence(mesh, dm))
        runs[dev] = (full, local, res)
    (full, local, res), (hfull, hlocal, hres) = runs["cuda"], runs["cpu"]
    assert full.local.device.type == "cuda"
    assert full.exit_reason == res.exit_reason == cg.CONVERGED
    assert full.iterations == hfull.iterations
    assert res.iterations == hres.iterations
    assert float((full.local.cpu() - hfull.local).abs().max()) < 1e-10
    assert float((local.cpu() - hlocal).abs().max()) < 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["interface", "fictdom"])
def test_generic_cut_solves_on_card_match_cpu(solver):
    """run_interface (condensed + MG) and run_fictdom (Jacobi PCG) at
    16^2 k=1 on the card against the same solves on the CPU: iteration
    counts within 2, local dofs within 1e-10, H1 within 1e-10 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from proton_tpu_torch.cut import fictdom, interface_problem

    run = interface_problem.run_interface if solver == "interface" \
        else fictdom.run_fictdom
    card, host = run(16, 1, device="cuda"), run(16, 1, device="cpu")
    assert card.exit_reason == host.exit_reason == cg.CONVERGED
    assert abs(card.iterations - host.iterations) <= 2
    assert abs(card.h1_error - host.h1_error) < 1e-10 * host.h1_error
    for f in (("local_neg", "local_pos") if solver == "interface"
              else ("local",)):
        a, b = getattr(card, f), getattr(host, f)
        assert a.device.type == "cuda"
        assert float((a.cpu() - b).abs().max()) < 1e-10


@pytest.mark.cuda
def test_fused_assembly_kernel_on_family_mesh():
    """K1 against its plain version on the displaced 64^2 mesh of one
    family geometry (the circle of radius 0.35 centred at (0.48, 0.52),
    nodes of badly cut cells moved), max|diff| / max|plain| < 1e-11."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from proton_tpu_torch.cut.classify import _preprocess_core

    p = fs.default_problem(0.35, (0.48, 0.52))
    mesh = make_poly_mesh(Nx=64, Ny=64, device="cuda")
    pts, cutdata, _, _ = _preprocess_core(mesh, p.ls, 4)
    assert bool(cutdata.distorted.any())
    mesh2 = mesh.with_points(pts)
    inp = fa.pack_inputs(mesh2, cell_geometry(mesh2))
    out = fa.fused_local_operator(*inp, 2, 1)
    torch.cuda.synchronize()
    ref = fa.fitted_local_operator_plain(*inp, 2, 1)
    assert float((out - ref).abs().max() / ref.abs().max()) < 1e-11


@pytest.mark.cuda
def test_family_solve_on_card_matches_cpu():
    """A two-circle family at 16^2 k=1 on the card against the same
    family on the CPU: one K1 launch per geometry, iteration counts
    within 2, cut counts equal, H1 within 1e-8 relative (the tolerance of
    the family against the JAX package; measured 4.8e-10 on an H100: the
    sliver cut cells of the second circle amplify K1's 1e-13 rounding)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from proton_tpu_torch.cut import batched

    radii, centers = [0.35, 0.3], [[0.5, 0.5], [0.48, 0.52]]
    params = cg.CGParams(convergence_threshold=1e-10,
                         divergence_threshold=1e8, max_iter=20000,
                         apply_preconditioner=True)
    before = fa.fused_local_operator.launches
    card = batched.solve_fictdom_family(16, 1, radii, centers,
                                        cg_params=params, device="cuda")
    assert fa.fused_local_operator.launches == before + 2
    host = batched.solve_fictdom_family(16, 1, radii, centers,
                                        cg_params=params, device="cpu")
    assert card.exit_reason.tolist() == host.exit_reason.tolist() == [0, 0]
    assert card.n_cut.tolist() == host.n_cut.tolist()
    assert torch.all((card.iterations - host.iterations).abs() <= 2)
    assert torch.all((card.h1_error - host.h1_error).abs() <
                     1e-8 * host.h1_error)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2])
def test_fused_assembly_float32_on_mixed_lean_shapes(k):
    """K1 in float32 at the shapes the mixed lean path gives it on the
    64^2 level (d = 14 at k=1, 22 at k=2): the displaced cells of the
    float32 classification and one cell of side 1/64, against its plain
    float32 version, max|diff| / max|plain| < 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from proton_tpu_torch.core.mesh import unit_cell_mesh

    mesh, _, _, _, _, dist = fs.classify_cells(
        64, fs.default_problem(), 4, device=torch.device("cuda"), mixed=True)
    assert mesh.points.dtype == torch.float32 and len(dist) > 0
    sub, gsub = fs._gather_cells(mesh, cell_geometry(mesh),
                                 torch.as_tensor(dist, device="cuda"))
    one = fs._cast(unit_cell_mesh(1.0 / 64, device="cuda"), torch.float32)
    for inp in (fa.pack_inputs(sub, gsub),
                fa.pack_inputs(one, cell_geometry(one))):
        out = fa.fused_local_operator(*inp, k + 1, k)
        torch.cuda.synchronize()
        assert fa.fused_local_operator.launch_dtypes[-1] == torch.float32
        ref = fa.fitted_local_operator_plain(*inp, k + 1, k)
        assert float((out - ref).abs().max() / ref.abs().max()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("options", [dict(mixed=True), dict(mg_f32=True)])
def test_precision_modes_on_card_match_cpu(options):
    """The mixed system (K1 in float32 on the displaced cells of every
    level) and the float32 V-cycle at 32^2 k=2, tol 1e-9, on the card
    against the same solve on the CPU: iteration counts within 3; with
    mg_f32, H1 within rtol 1e-7; with mixed, K1 ran in float32, and the
    two H1 errors differ by at most a tenth of the float32 system's noise
    (its H1 less the float64 solve's on the CPU: 5.0e-5 against 2.3e-5
    here; the card and the CPU round it 2.5% of that apart on an H100)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    params = cg.CGParams(convergence_threshold=1e-9,
                         divergence_threshold=1e8, max_iter=50000,
                         apply_preconditioner=True)
    fa.reset_launch_counts()
    card = fs.solve_fictdom_structured(32, 2, cg_params=params, **options)
    dtypes = list(fa.fused_local_operator.launch_dtypes)
    host = fs.solve_fictdom_structured(32, 2, cg_params=params,
                                       device="cpu", **options)
    assert card.exit_reason == host.exit_reason == cg.CONVERGED
    assert abs(card.iterations - host.iterations) <= 3
    mixed = options.get("mixed", False)
    assert (torch.float32 in dtypes) == mixed
    assert card.local.dtype == (torch.float32 if mixed else torch.float64)
    if mixed:
        f64 = fs.solve_fictdom_structured(32, 2, cg_params=params,
                                          device="cpu")
        noise = abs(host.h1_error - f64.h1_error)
        assert abs(card.h1_error - host.h1_error) <= 0.1 * noise
    else:
        assert np.isclose(card.h1_error, host.h1_error, rtol=1e-7)


@pytest.mark.cuda
def test_cg_iteration_waits_for_the_card_only_in_its_exit_test():
    """64^2 k=1, lean + multigrid: one V-cycle apply and one fine operator
    apply enqueue without a host wait (torch's sync debug mode "error"
    lets them through); CG under that mode stops at its first wait, inside
    the cg_wait span after the first apply and V-cycle; and under "warn"
    a capped CG waits once an iteration, as many times as cg_wait ran."""
    import warnings

    from proton_tpu_torch.utils.timing import sink
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    N, k, dev = 64, 1, torch.device("cuda")
    hdi, eta, problem = HHODegreeInfo(k + 1, k), fs.nitsche_eta(k), \
        fs.default_problem()
    level = fs.build_level(N, hdi, problem, eta, 4, device=dev,
                           fitted="lean")
    vcycle = fs.mg_preconditioner(level, N, hdi, problem, eta, 4,
                                  device=dev)
    fsys = fs.face_system(level, N, hdi, problem, "mg", device=dev)
    params = cg.CGParams(convergence_threshold=1e-30,
                         divergence_threshold=1e8, max_iter=3,
                         apply_preconditioner=True)
    fsys.apply_S(vcycle(fsys.rhs))              # warm: allocator, handles
    torch.cuda.synchronize()
    t = {}
    try:
        torch.cuda.set_sync_debug_mode("error")
        y = fsys.apply_S(vcycle(fsys.rhs))
        with sink(t), pytest.raises(RuntimeError, match="synchroniz"):
            cg.conjugated_gradient(fsys.apply_S, fsys.rhs, None, params,
                                   precond=vcycle)
        torch.cuda.set_sync_debug_mode("warn")
        with sink(waits := {}), warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            res = cg.conjugated_gradient(fsys.apply_S, fsys.rhs, None,
                                         params, precond=vcycle)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(y.H).all() and torch.isfinite(y.V).all()
    assert t.get("cg_apply_calls") == t.get("cg_precond_calls") == 1
    assert "cg_wait_calls" not in t
    syncs = [x for x in w if "synchroniz" in str(x.message)]
    assert res.iterations == waits["cg_wait_calls"] == len(syncs)


def _cuda_multigrid(N, k, **options):
    """The lean level hierarchy of the default fictdom problem at N^2 on
    the card (``options``: build_level's precision switch) and its
    Multigrid, whose V-cycle build_multigrid captured."""
    hdi, eta, problem = HHODegreeInfo(k + 1, k), fs.nitsche_eta(k), \
        fs.default_problem()
    dev = torch.device("cuda")
    fine = fs.build_level(N, hdi, problem, eta, 4, device=dev,
                          fitted="lean", **options)
    levels = {N: fine, **fs.build_coarse_levels(N, hdi, problem, eta, 4,
                                                device=dev, **options)}
    return fs.level_multigrid(levels, hdi)


def _cuda_grid(like, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return GridVecCL(*(torch.randn(a.shape, generator=g, device="cuda",
                                   dtype=a.dtype) for a in like))


def _rel_diff(a, b):
    """max|a - b| / max|b| over the members of two vectors."""
    num = max(float((x - y).abs().max()) for x, y in zip(a, b))
    return num / max(float(y.abs().max()) for y in b)


def _no_capture(monkeypatch):
    """build_multigrid without its capture: the V-cycle then runs op by
    op on the card, as on the CPU."""
    monkeypatch.setattr(multigrid, "capture_vcycle", lambda mg, dtype: None)


@pytest.mark.cuda
@pytest.mark.parametrize("N,k", [(128, 1), (64, 2)])
def test_vcycle_graph_matches_eager(N, k):
    """The graphed V-cycle of a lean 1024^2-like hierarchy (cut levels
    N ... 8^2) equals the same Multigrid's V-cycle run op by op to 1e-12
    relative, over several inputs in a row; its static buffers are the
    fine level's grids in float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from proton_tpu_torch.utils.timing import sink
    mg = _cuda_multigrid(N, k)
    assert mg.graph is not None
    assert mg.graph.x.H.dtype == torch.float64
    with sink(t := {}):
        for seed in range(4):
            r = _cuda_grid(mg.graph.x, seed)
            z = mg.precondition(r)
            assert _rel_diff(z, multigrid._vcycle(mg, 0, r)) < 1e-12
    assert t["mg_graph_replay_calls"] == 4


@pytest.mark.cuda
def test_vcycle_graph_result_survives_the_next_call():
    """A result held across the next call is left as it was: each call
    returns a copy of the graph's static output (CG keeps the first
    call's result as its direction while it calls again)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mg = _cuda_multigrid(64, 1)
    r1, r2 = _cuda_grid(mg.graph.x, 1), _cuda_grid(mg.graph.x, 2)
    z1 = mg.precondition(r1)
    held = GridVecCL(z1.H.clone(), z1.V.clone())
    z2 = mg.precondition(r2)
    torch.cuda.synchronize()
    assert torch.equal(z1.H, held.H) and torch.equal(z1.V, held.V)
    assert z1.H.data_ptr() != mg.graph.y.H.data_ptr()
    assert _rel_diff(z2, multigrid._vcycle(mg, 0, r2)) < 1e-12


@pytest.mark.cuda
def test_solve_with_vcycle_graph_matches_eager(monkeypatch):
    """solve_fictdom_structured(64, 1) (lean + MG, tol 1e-10) with the
    V-cycle graphed against the same solve with it run op by op: the same
    iteration count and exit, local dofs within 1e-12 relative; every
    V-cycle call of CG replayed the graph (captured once, in mg_setup,
    so no call of CG was a warm-up or a capture), and the eager solve
    counts no graph span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    params = cg.CGParams(convergence_threshold=1e-10,
                         divergence_threshold=1e8, max_iter=50000,
                         apply_preconditioner=True)
    graphed = fs.solve_fictdom_structured(64, 1, cg_params=params)
    _no_capture(monkeypatch)
    eager = fs.solve_fictdom_structured(64, 1, cg_params=params)
    assert graphed.exit_reason == eager.exit_reason == cg.CONVERGED
    assert graphed.iterations == eager.iterations
    diff = float((graphed.local - eager.local).abs().max())
    assert diff < 1e-12 * float(eager.local.abs().max())
    t = graphed.timings
    assert t["mg_graph_capture_calls"] == 1
    assert t["mg_graph_replay_calls"] == t["cg_precond_calls"] == \
        graphed.iterations
    assert not [key for key in eager.timings if key.startswith("mg_graph")]


@pytest.mark.cuda
def test_interface_vcycle_graph_matches_eager(monkeypatch):
    """The interface problem's preconditioner (uniform MG + cut-band
    Schwarz) at 64^2 k=1 on the card, its V-cycle graphed, against the
    same system's with the V-cycle run op by op: equal to 1e-12 relative
    over several residuals."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from proton_tpu_torch.cut import classify, interface_problem as ip

    p, hdi, parms = fs.default_problem(), HHODegreeInfo(2, 1), \
        ip.InterfaceParams()
    mesh, cd = classify.cut_preprocess(
        make_poly_mesh(Nx=64, Ny=64, device="cuda"), p.ls, 4)
    asm = ip.assemble_interface(mesh, cd, p.ls, hdi, p.rhs_fun, p.sol_fun,
                                parms)
    graphed = ip.condensed_face_system(mesh, asm, hdi, parms)
    _no_capture(monkeypatch)
    eager = ip.condensed_face_system(mesh, asm, hdi, parms)
    assert graphed.preconditioner == eager.preconditioner == "mg"
    g = torch.Generator(device="cuda").manual_seed(5)
    for _ in range(3):
        r = torch.randn(graphed.rhs.shape, generator=g, device="cuda",
                        dtype=graphed.rhs.dtype)
        z, ref = graphed.precond(r), eager.precond(r)
        assert float((z - ref).abs().max()) < 1e-12 * float(ref.abs().max())


@pytest.mark.cuda
def test_interface_precond_on_card_matches_cpu(monkeypatch):
    """The interface problem's preconditioner (its copy maps, the graphed
    V-cycle and the cut band) built on the card at 64^2 k=1 and the same
    function built on the CPU from the same inputs, moved there: equal to
    1e-12 relative over several residuals."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from proton_tpu_torch.cut import classify, interface_problem as ip

    p, hdi, parms = fs.default_problem(0.35, (0.5 + 0.3 / 64, 0.5)), \
        HHODegreeInfo(2, 1), ip.InterfaceParams()
    mesh, cd = classify.cut_preprocess(
        make_poly_mesh(Nx=64, Ny=64, device="cuda"), p.ls, 4)
    asm = ip.assemble_interface(mesh, cd, p.ls, hdi, p.rhs_fun, p.sol_fun,
                                parms)
    seen, real = [], ip._interface_mg_precond
    monkeypatch.setattr(ip, "_interface_mg_precond",
                        lambda *a: seen.append(a) or real(*a))
    card = ip.condensed_face_system(mesh, asm, hdi, parms)
    assert card.preconditioner == "mg"

    def host(a):
        if isinstance(a, torch.Tensor):
            return a.cpu()
        if isinstance(a, (tuple, list)):
            return type(a)(host(b) for b in a)
        if dataclasses.is_dataclass(a):
            return dataclasses.replace(a, **{
                f.name: host(getattr(a, f.name))
                for f in dataclasses.fields(a)})
        return a

    cpu_precond = real(*host(seen[0]))
    g = torch.Generator(device="cuda").manual_seed(20)
    for _ in range(3):
        r = torch.randn(card.rhs.shape, generator=g, device="cuda",
                        dtype=card.rhs.dtype)
        z, ref = card.precond(r).cpu(), cpu_precond(r.cpu())
        assert float((z - ref).abs().max()) < 1e-12 * float(ref.abs().max())


@pytest.mark.cuda
def test_mixed_vcycle_graph_matches_eager():
    """Under mixed=True (the stored system and the V-cycle in float32)
    the graph is captured in float32 and equals the float32 V-cycle run
    op by op at float32 rounding (1e-5 relative)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mg = _cuda_multigrid(64, 1, mixed=True)
    assert mg.graph.x.H.dtype == torch.float32
    for seed in range(3):
        r = _cuda_grid(mg.graph.x, seed)
        assert _rel_diff(mg.precondition(r), multigrid._vcycle(mg, 0, r)) \
            < 1e-5


@pytest.mark.cuda
def test_vcycle_graph_leaves_no_memory_behind():
    """Multigrids captured and freed one after another leave the card's
    allocated memory where it was: the graph's pool, its static buffers
    and the cuBLAS workspace of its capture stream go with it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import gc

    a = torch.ones((64, 64), dtype=torch.float64, device="cuda")

    def settled():
        gc.collect()
        torch.mm(a, a)                  # the eager stream's cuBLAS workspace
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    mg = _cuda_multigrid(64, 1)         # the caches of the level set-up
    del mg
    before = settled()
    for seed in range(3):
        mg = _cuda_multigrid(64, 1)
        mg.precondition(_cuda_grid(mg.graph.x, seed))
        del mg
    assert settled() == before
