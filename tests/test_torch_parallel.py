"""proton_tpu_torch.parallel on the CPU over gloo: the cell-sharded global
solve (sharding.py) and the row-halo face-grid solve (halo.py) on 1, 2
and 4 ranks give the single-process port's numbers and the JAX package's
(tests/test_parallel.py and tests/test_halo.py are the models).

The ranks are spawned with torch.multiprocessing, once per world size,
each spawn running every check; the process group meets in a file:// store
under the test's tmp_path, so parallel test workers never share a port.
One rank runs in this process. The spawned ranks import this module, so
JAX is imported inside functions only. The JAX package's row-halo
references (its structured operator, diagonal and condensed solve on the
port's 16^2 arrays) are read from tests/jax_refs/test_torch_parallel.npz
(REFS below; tests/torch_jax_reference.py writes it, with the digest of
those arrays)."""

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from proton_tpu_torch.core.geometry import cell_geometry
from proton_tpu_torch.core.mesh import make_quad_mesh
from proton_tpu_torch.core.ops import HHODegreeInfo, cell_rhs
from proton_tpu_torch.methods import assembly, condensation, poisson, \
    structured
from proton_tpu_torch.parallel import halo, sharding
from proton_tpu_torch.solvers import cg
from torch_jax_reference import Refs

CPU = torch.device("cpu")
N_SHARDED, N_HALO, K = 7, 16, 1
CGP = cg.CGParams(convergence_threshold=1e-12, divergence_threshold=1e8,
                  max_iter=10000, apply_preconditioner=True)
REFS = Refs(__name__)


def _uncut_system(N, bc_zero: bool):
    """(mesh, dofmap, lc, cell loads, g_loc) of the uncut N^2 k=1 problem:
    sin(pi x) sin(pi y) data (zero Dirichlet data with ``bc_zero``)."""
    pi = np.pi
    mesh = make_quad_mesh(Nx=N, Ny=N, device=CPU)
    hdi = HHODegreeInfo(K + 1, K)
    geom = cell_geometry(mesh)
    _, lc = poisson.assemble_local(mesh, geom, hdi)

    def sol(p):
        return torch.sin(pi * p[..., 0]) * torch.sin(pi * p[..., 1])

    f = cell_rhs(mesh, geom, hdi.cell_degree, lambda p: 2 * pi ** 2 * sol(p))
    dm = assembly.build_dofmap(mesh, hdi)
    fd = assembly.dirichlet_face_data(
        mesh, hdi, (lambda p: torch.zeros_like(p[..., 0])) if bc_zero
        else sol)
    return mesh, dm, lc, f, assembly.local_dirichlet_data(dm, mesh, fd)


def _random_grid(N, fbs):
    """A seeded row-major GridVec with its frozen top H row zeroed (the
    halo layout drops it)."""
    rng = np.random.default_rng(N)
    H = torch.as_tensor(rng.standard_normal((N + 1, N, fbs)))
    H[-1] = 0.0
    return structured.GridVec(H, torch.as_tensor(
        rng.standard_normal((N, N + 1, fbs))))


def _rank_checks(rank, world, init_method, out_dir):
    """Every check of one rank: its results go to out_dir/r{rank}.npz."""
    torch.set_num_threads(1)
    dmesh = sharding.make_device_mesh("cpu", init_method=init_method,
                                      rank=rank, world_size=world)
    try:
        assert (dmesh.rank, dmesh.world_size, dmesh.backend) == \
            (rank, world, "gloo")
        out = {}
        mesh, dm, lc, f, g_loc = _uncut_system(N_SHARDED, bc_zero=True)
        rhs = assembly.assemble_rhs(dm, f, lc, g_loc)
        dm_pad, C = sharding.build_dofmap_padded(
            mesh, HHODegreeInfo(K + 1, K), world)
        pad = dm_pad.n_cells - C
        lc_pad = torch.cat([lc, lc.new_zeros((pad,) + lc.shape[1:])])
        mesh_pad, C2 = sharding.pad_cells_to_multiple(mesh, world)
        assert C2 == C and mesh_pad.cell_ptids.shape[0] == dm_pad.n_cells
        res = sharding.sharded_solve(dmesh, dm_pad, lc_pad, rhs, CGP)
        out.update(sharded_x=res.x.numpy(), sharded_iters=res.iterations,
                   sharded_exit=res.exit_reason)

        mesh, dm, lc, f, g_loc = _uncut_system(N_HALO, bc_zero=False)
        cond = condensation.condense(lc, f, dm.cbs)
        sys_ = structured.make_structured_system(N_HALO, N_HALO, dm.fbs,
                                                 device=CPU)
        S, x = halo.shard_system(dmesh, sys_, cond.S,
                                 halo.to_halo(_random_grid(N_HALO, dm.fbs)))
        y = halo.make_halo_operator(dmesh, sys_, S)(x)
        d = halo.halo_diagonal(dmesh, sys_, cond.S)
        local, res = halo.solve_condensed_halo(dmesh, sys_, cond, g_loc,
                                               dm.cbs, CGP)
        out.update(y_H=y.H.numpy(), y_V=y.V.numpy(), d_H=d.H.numpy(),
                   d_V=d.V.numpy(), halo_local=local.numpy(),
                   halo_iters=res.iterations, halo_exit=res.exit_reason)
        np.savez(out_dir / f"r{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def _jax_cg_params():
    from proton_tpu.solvers import cg as jcg
    return jcg.CGParams(convergence_threshold=1e-12,
                        divergence_threshold=1e8, max_iter=10000,
                        apply_preconditioner=True)


def _jax_halo():
    """The JAX package's structured operator on the seeded grid vector,
    its diagonal, and its condensed structured solve on the port's 16^2
    local matrices, loads and Dirichlet data (their digest)."""
    import jax.numpy as jnp

    from proton_tpu.methods import condensation as jcondensation
    from proton_tpu.methods import structured as jstructured

    _, dm, lc, f, g_loc = _uncut_system(N_HALO, bc_zero=False)
    x = _random_grid(N_HALO, dm.fbs)
    jsys = jstructured.make_structured_system(N_HALO, N_HALO, dm.fbs)
    jS = jcondensation.condense(jnp.asarray(lc.numpy()),
                                jnp.asarray(f.numpy()), dm.cbs).S
    jlocal, jres = jstructured.solve_condensed_structured(
        jsys, jnp.asarray(lc.numpy()), jnp.asarray(f.numpy()), dm.cbs,
        jnp.asarray(g_loc.numpy()), _jax_cg_params())
    return dict(
        inputs=[lc, f, g_loc, x.H, x.V],
        y=jstructured.make_structured_operator(jsys, jS)(
            jstructured.GridVec(jnp.asarray(x.H.numpy()),
                                jnp.asarray(x.V.numpy()))),
        d=jstructured.structured_diagonal(jsys, jS),
        local=jlocal, iterations=jres.iterations)


REFS.add("halo", "solve",
         "make_structured_operator(sys, condense(lc, f, cbs).S)(x), "
         "structured_diagonal, solve_condensed_structured(sys, lc, f, cbs, "
         "g_loc, tol 1e-12) on the port's uncut 16^2 k=1 arrays",
         _jax_halo, seed=N_HALO)


@pytest.fixture(scope="module")
def references():
    """The single-process port's and the JAX package's numbers on the
    same inputs (the port's local matrices, loads and Dirichlet data)."""
    import jax.numpy as jnp

    import proton_tpu as pt
    from proton_tpu.core.ops import HHODegreeInfo as JHHODegreeInfo
    from proton_tpu.methods import assembly as jassembly
    from proton_tpu.solvers import cg as jcg

    jcgp = _jax_cg_params()
    ref = {}
    _, dm, lc, f, g_loc = _uncut_system(N_SHARDED, bc_zero=True)
    rhs = assembly.assemble_rhs(dm, f, lc, g_loc)
    res = cg.conjugated_gradient(assembly.make_operator(dm, lc), rhs,
                                 assembly.operator_diagonal(dm, lc), CGP)
    jdm = jassembly.build_dofmap(pt.make_quad_mesh(Nx=N_SHARDED,
                                                   Ny=N_SHARDED),
                                 JHHODegreeInfo(K + 1, K))
    jlc = jnp.asarray(lc.numpy())
    jres = jcg.conjugated_gradient(jassembly.make_operator(jdm, jlc),
                                   jnp.asarray(rhs.numpy()),
                                   jassembly.operator_diagonal(jdm, jlc),
                                   jcgp)
    ref.update(sharded=(res.x.numpy(), res.iterations),
               jax_sharded=(np.asarray(jres.x), int(jres.iterations)))

    _, dm, lc, f, g_loc = _uncut_system(N_HALO, bc_zero=False)
    cond = condensation.condense(lc, f, dm.cbs)
    sys_ = structured.make_structured_system(N_HALO, N_HALO, dm.fbs,
                                             device=CPU)
    x = _random_grid(N_HALO, dm.fbs)
    local, res = structured.solve_condensed_structured(sys_, lc, f, dm.cbs,
                                                       g_loc, CGP)
    ref.update(y=structured.make_structured_operator(sys_, cond.S)(x),
               d=structured.structured_diagonal(sys_, cond.S),
               halo=(local.numpy(), res.iterations))
    jhalo = REFS.get("halo", inputs=[lc, f, g_loc, x.H, x.V])
    ref.update(jax_y=jhalo.y, jax_d=jhalo.d,
               jax_halo=(np.asarray(jhalo.local), int(jhalo.iterations)))
    return ref


@pytest.fixture(scope="module", params=[1, 2, 4])
def ranks(request, tmp_path_factory):
    """Every rank's results at one world size: one spawn of `world`
    processes (world 1 runs in this process)."""
    world = request.param
    tmp = tmp_path_factory.mktemp(f"world{world}")
    init = f"file://{tmp / 'store'}"
    if world == 1:
        _rank_checks(0, 1, init, tmp)
    else:
        mp.spawn(_rank_checks, args=(world, init, tmp), nprocs=world,
                 join=True)
    return world, [dict(np.load(tmp / f"r{r}.npz")) for r in range(world)]


def _close(a, ref, tol):
    assert np.max(np.abs(np.asarray(a) - np.asarray(ref))) <= tol


def test_sharded_solve_matches(ranks, references):
    """sharded_solve at 7 x 7 cells (49: padded on 2 and 4 ranks) equals
    the single-process Jacobi PCG (the same iterations, x within 1e-9) on
    every rank, and the JAX package's make_operator CG (iterations within
    2, x within 1e-9)."""
    _, out = ranks
    x_ref, it_ref = references["sharded"]
    jx, jit_ = references["jax_sharded"]
    for o in out:
        assert int(o["sharded_exit"]) == cg.CONVERGED
        assert int(o["sharded_iters"]) == it_ref
        assert abs(int(o["sharded_iters"]) - jit_) <= 2
        _close(o["sharded_x"], x_ref, 1e-9)
        _close(o["sharded_x"], jx, 1e-9)


def test_halo_operator_and_diagonal_match(ranks, references):
    """The halo operator on a seeded grid vector and halo_diagonal, the
    ranks' slabs stacked, equal structured.make_structured_operator and
    structured_diagonal of the port (1e-12) and of the JAX package
    (1e-12); the diagonal's frozen top row is dropped."""
    _, out = ranks
    yH = np.concatenate([o["y_H"] for o in out])
    yV = np.concatenate([o["y_V"] for o in out])
    dH = np.concatenate([o["d_H"] for o in out])
    dV = np.concatenate([o["d_V"] for o in out])
    y = halo.from_halo(halo.HaloGridVec(torch.as_tensor(yH),
                                        torch.as_tensor(yV)))
    for ref_y, ref_d in ((references["y"], references["d"]),
                         (references["jax_y"], references["jax_d"])):
        scale = float(np.max(np.abs(np.asarray(ref_y.H))))
        _close(y.H, ref_y.H, 1e-12 * scale)
        _close(y.V, ref_y.V, 1e-12 * scale)
        scale = float(np.max(np.abs(np.asarray(ref_d.V))))
        _close(dH, np.asarray(ref_d.H)[:-1], 1e-12 * scale)
        _close(dV, ref_d.V, 1e-12 * scale)


def test_halo_solve_matches(ranks, references):
    """solve_condensed_halo at 16^2 equals solve_condensed_structured (the
    same iterations, local dofs within 1e-9) on every rank, and the JAX
    package's solve_condensed_structured (iterations within 2, 1e-9)."""
    _, out = ranks
    local_ref, it_ref = references["halo"]
    jlocal, jit_ = references["jax_halo"]
    for o in out:
        assert int(o["halo_exit"]) == cg.CONVERGED
        assert int(o["halo_iters"]) == it_ref
        assert abs(int(o["halo_iters"]) - jit_) <= 2
        _close(o["halo_local"], local_ref, 1e-9)
        _close(o["halo_local"], jlocal, 1e-9)


def test_nccl_without_cuda_raises(monkeypatch, tmp_path):
    """NCCL carries CUDA tensors: asked for (device "cuda") where it cannot
    run, it raises before any group starts; with no device and no CUDA the
    device rule raises first. No process group is left behind."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="'nccl'"):
        sharding.make_device_mesh("cuda",
                                  init_method=f"file://{tmp_path}/store",
                                  rank=0, world_size=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        sharding.make_device_mesh()
    with pytest.raises(ValueError, match="init_method"):
        sharding.make_device_mesh("cpu")
    assert not dist.is_initialized()
