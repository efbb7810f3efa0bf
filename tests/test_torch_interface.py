"""proton_tpu_torch's interface problem against proton_tpu on the CPU,
float64: the doubled dofmap (exact), interface_laplacian with its exact
rank-one regularization, check_eigs, the side projection, the assembled
face blocks, both preconditioners of the condensed system applied to a
seeded vector, take_local_data, the H1 error, and the solve (condensed
+ MG, condensed against the full system, a kappa contrast on the
block-Jacobi branch). The JAX package's interface solve at 16^2 k=1 (its
per-cell operators and its multigrid setup under jax.jit; its
preconditioner's inputs captured on the way and fed to both packages),
its operators on the solve's cut batch and its preconditioners applied
to seeded vectors are read from tests/jax_refs/test_torch_interface.npz
(REFS below; tests/torch_jax_reference.py writes it, running the JAX
package alone)."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import threadpoolctl
import torch

from proton_tpu.core.geometry import cell_geometry as jcell_geometry
from proton_tpu.core.ops import HHODegreeInfo as JHDI
from proton_tpu.cut import interface_problem as jip, levelset as jlevelset, \
    methods as jmethods
from proton_tpu.methods import assembly as jassembly, \
    condensation as jcondensation, hho as jhho
from proton_tpu.solvers import cg as jcg, multigrid as jmultigrid
from proton_tpu_torch import convert
from proton_tpu_torch.core.geometry import cell_geometry
from proton_tpu_torch.core.mesh import make_poly_mesh
from proton_tpu_torch.core.ops import HHODegreeInfo
from proton_tpu_torch.cut import interface_problem as ip, methods
from proton_tpu_torch.cut.classify import LOC_NEG, LOC_POS, cut_preprocess
from proton_tpu_torch.cut.fictdom_structured import default_problem
from proton_tpu_torch.solvers import cg
from torch_jax_reference import Refs

CPU = torch.device("cpu")
PI = np.pi

# The JAX package on the CPU, float64: run_interface(8, 1,
# parms=InterfaceParams(1.0, 3.0)), the block-Jacobi branch (kappa_1 !=
# kappa_2): (CG iterations, H1 error).
KAPPA_CONTRAST_8 = (130, 1.2251883059052757)
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


def _jax_problem():
    def sol(p):
        return jnp.sin(PI * p[..., 0]) * jnp.sin(PI * p[..., 1])

    def grad(p):
        return jnp.stack([PI * jnp.cos(PI * p[..., 0]) * jnp.sin(PI * p[..., 1]),
                          PI * jnp.sin(PI * p[..., 0]) * jnp.cos(PI * p[..., 1])],
                         -1)

    return (lambda p: 2.0 * PI ** 2 * sol(p)), sol, grad


@functools.lru_cache(maxsize=None)
def _jax_interface():
    """The JAX package's solve_interface at 16^2 k=1 (condensed + MG),
    with its per-cell operators and mg_setup_cl under jax.jit, and the
    arguments of its preconditioner and of its CG captured."""
    import proton_tpu as pt
    from proton_tpu.cut import classify as jclassify

    captured = {}
    mp = pytest.MonkeyPatch()
    jit = jax.jit
    mp.setattr(jmethods, "interface_laplacian",
               jit(jmethods.interface_laplacian, static_argnums=(1, 2, 3)))
    mp.setattr(jmethods, "cut_stabilization",
               jit(jmethods.cut_stabilization, static_argnums=(1, 2)))
    mp.setattr(jmethods, "_side_cell_evals",
               jit(jmethods._side_cell_evals, static_argnums=(2, 3),
                   static_argnames=("want_grads",)))
    mp.setattr(jhho, "hho_laplacian", jit(jhho.hho_laplacian,
                                          static_argnums=(2,)))
    mp.setattr(jhho, "naive_stabilization",
               jit(jhho.naive_stabilization, static_argnums=(2,)))
    mp.setattr(jip, "cell_rhs", jit(jip.cell_rhs, static_argnums=(2, 3)))
    mp.setattr(jassembly, "dirichlet_face_data",
               jit(jassembly.dirichlet_face_data, static_argnums=(1, 2)))
    mp.setattr(jcondensation, "condense",
               jit(jcondensation.condense, static_argnums=(2,),
                   static_argnames=("robust",)))
    mp.setattr(jip, "interface_h1_error",
               jit(jip.interface_h1_error, static_argnums=(4, 7)))
    mp.setattr(jip, "take_local_data",
               jit(jip.take_local_data, static_argnums=(5,)))
    mp.setattr(jip, "make_cut_batch", jit(jip.make_cut_batch))
    mp.setattr(jmethods, "side_polygon",
               jit(jmethods.side_polygon, static_argnums=(1,)))
    mp.setattr(jassembly, "multi_assemble_rhs",
               jit(jassembly.multi_assemble_rhs, static_argnums=(0,)))
    mp.setattr(jip, "spd_inverse", jit(jip.spd_inverse))
    setup = jmultigrid.mg_setup_cl
    mp.setattr(jmultigrid, "mg_setup_cl", lambda N, fbs, S, hdi, **kw:
               jit(lambda S: setup(N, fbs, S, hdi, **kw))(S))
    mg_precond = jip._interface_mg_precond

    def spy_precond(*args, **kw):
        captured["precond_args"] = args
        captured["precond"] = mg_precond(*args, **kw)
        return captured["precond"]

    mp.setattr(jip, "_interface_mg_precond", spy_precond)
    solve = jcg.conjugated_gradient

    def spy_cg(apply_A, b, *args, **kw):
        captured["rhs"] = b
        return solve(apply_A, b, *args, **kw)

    mp.setattr(jcg, "conjugated_gradient", spy_cg)
    try:
        ls = jlevelset.circle_level_set(0.35, 0.5, 0.5)
        jmesh, jcd = jclassify.cut_preprocess(pt.make_poly_mesh(Nx=16, Ny=16),
                                              ls, levels=4)
        rhs, sol, grad = _jax_problem()
        res = jip.solve_interface(jmesh, jcd, ls, 1, rhs, sol, grad)
        hdi = JHDI(2, 1)
        jdm = jip.build_interface_dofmap(jmesh, jcd, hdi)
        fd = jassembly.dirichlet_face_data(jmesh, hdi, sol)
        geom = jcell_geometry(jmesh)
        jbatch = jmethods.make_cut_batch(jmesh, geom, jcd,
                                         np.asarray(jdm.cut_ids))
        neg = jip.take_local_data(jmesh, jdm, jcd, res.x, fd, LOC_NEG)
        pos = jip.take_local_data(jmesh, jdm, jcd, res.x, fd, LOC_POS)
        h1 = jip.interface_h1_error(jmesh, geom, jbatch, jcd, hdi, neg, pos,
                                    grad)
    finally:
        mp.undo()
    return dict(mesh=jmesh, cd=jcd, res=res, dm=jdm, fd=fd, batch=jbatch,
                neg=neg, pos=pos, h1=h1, ls=ls, **captured)


def _jax_solve():
    """What the tests read of _jax_interface: the classified mesh, cut
    data, dofmap, result, Dirichlet data, cut batch, both sides' local
    data and H1; the CG's right-hand side; the preconditioner's arguments
    and its apply to a seeded vector; the assembled face blocks and the
    face block-Jacobi apply to another."""
    ref = _jax_interface()
    (_, jdm, nfd, S, idx_c, blocks, N, _, _) = ref["precond_args"]
    r = np.random.default_rng(5).standard_normal(nfd)
    r6 = np.random.default_rng(6).standard_normal(nfd)
    return dict(
        {k: ref[k] for k in ("mesh", "cd", "res", "dm", "fd", "batch", "neg",
                             "pos", "h1", "rhs")},
        precond_args=dict(dm=jdm, nfd=nfd, S=S, idx_c=idx_c, blocks=blocks,
                          N=N),
        precond_z=jax.jit(ref["precond"])(jnp.asarray(r)),
        face_blocks=jip._assembled_face_blocks(jdm, nfd, blocks),
        block_jacobi_z=jip._face_block_jacobi(jdm, nfd, blocks)(
            jnp.asarray(r6)))


REFS.add("solve", "solve",
         "solve_interface(cut_preprocess(make_poly_mesh(16, 16), circle "
         "0.35, levels=4), ls, 1, rhs, sol, grad) with its per-cell stages "
         "and mg_setup_cl under jax.jit; take_local_data, "
         "interface_h1_error; _interface_mg_precond(...)(r), "
         "_assembled_face_blocks, _face_block_jacobi(...)(r)", _jax_solve,
         seed=[5, 6])


@pytest.fixture(scope="module")
def ref():
    """The JAX package's stored interface solve at 16^2 k=1 and what the
    tests read beside it (_jax_solve)."""
    return REFS["solve"]


@pytest.fixture(scope="module")
def port(ref):
    """The JAX classified mesh and cut data, converted."""
    return convert.mesh(ref["mesh"], CPU), convert.cut_data(ref["cd"], CPU)


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def test_dofmap_matches(ref, port):
    """Every table of the doubled dofmap equal to the JAX package's."""
    mesh, cd = port
    dm = ip.build_interface_dofmap(mesh, cd, HHODegreeInfo(2, 1))
    jdm = ref["dm"]
    want = convert.interface_dofmap(jdm, CPU)
    for f in ("asm_uncut", "asm_cut", "uncut_ids", "cut_ids",
              "dirichlet_uncut", "cell_table", "face_table", "face_is_cut"):
        np.testing.assert_array_equal(getattr(dm, f).numpy(),
                                      getattr(want, f).numpy(), err_msg=f)
    assert (dm.cbs, dm.fbs, dm.num_all_cells, dm.n_dofs) == \
        (jdm.cbs, jdm.fbs, jdm.num_all_cells, jdm.n_dofs)
    assert len(dm.cut_ids) > 0 and dm.n_dofs > int(dm.asm_uncut.max()) - 1


def _jax_operators(k):
    """interface_laplacian, check_eigs and cut_project_function of both
    sides on the JAX solve's cut batch at degree k, under jax.jit."""
    ref = _jax_interface()
    jbatch, jhdi = ref["batch"], JHDI(k + 1, k)
    joper, jdata = jax.jit(jmethods.interface_laplacian,
                           static_argnums=(1, 2, 3))(
        jbatch, ref["ls"], jhdi, jmethods.InterfaceParams(1.0, 2.0))
    out = dict(oper=joper, data=jdata)
    for side in (LOC_NEG, LOC_POS):
        out[f"eig{side}"] = jax.jit(jmethods.check_eigs,
                                    static_argnums=(1, 2, 3))(
            jbatch, ref["ls"], jhdi, side)
        out[f"proj{side}"] = jax.jit(jmethods.cut_project_function,
                                     static_argnums=(1, 2, 3))(
            jbatch, jhdi, side, _jax_problem()[1])
    return out


for _k in (0, 1, 2):
    REFS.add(f"operators[{_k}]", "operator",
             f"interface_laplacian(batch, ls, HHODegreeInfo({_k + 1}, {_k}), "
             f"InterfaceParams(1.0, 2.0)), check_eigs and "
             f"cut_project_function of both sides on the solve's cut batch",
             _jax_operators, k=_k)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_interface_operators_match(ref, k):
    """interface_laplacian (oper and data), check_eigs and the side
    projections of both sides from the same cut batch. Each goes through
    a solve with a matrix of the sliver cuts: the regularized Nitsche
    stiffness (cond ~1e7; measured data 1.5e-12, oper 3.0e-12 apart at
    k=1, 2) and the side mass matrix of a sliver (measured 3.5e-12 at
    k=1, 9.6e-10 at k=2 with the degree-3 cell basis). So data is held
    to 1e-11, oper to 1e-10 (as cut_hho_laplacian's,
    tests/test_torch_cut.py) and the projections to 1e-8."""
    batch = convert.cut_cell_batch(ref["batch"], CPU)
    p = default_problem()
    parms = methods.InterfaceParams(1.0, 2.0)
    hdi = HHODegreeInfo(k + 1, k)
    jops = REFS[f"operators[{k}]"]
    joper, jdata = jops.oper, jops.data
    oper, data = methods.interface_laplacian(batch, p.ls, hdi, parms)
    assert _rel(data, jdata) < 1e-11
    assert _rel(oper, joper) < 1e-10
    # the doubled operator is symmetric positive semi-definite
    assert float((data - data.transpose(1, 2)).abs().max()) < \
        1e-12 * float(data.abs().max())
    assert float(torch.linalg.eigvalsh(data).min()) > \
        -1e-10 * float(data.abs().max())
    assert bool(torch.isfinite(oper).all())
    for side in (LOC_NEG, LOC_POS):
        jeig = jops[f"eig{side}"]
        assert _rel(methods.check_eigs(batch, p.ls, hdi, side), jeig) < 1e-11
        jproj = jops[f"proj{side}"]
        proj = methods.cut_project_function(batch, hdi, side, p.sol_fun)
        assert _rel(proj, jproj) < 1e-8


def _precond_inputs(ref, port):
    """The JAX preconditioner's arguments, converted (identical inputs)."""
    mesh, _ = port
    jdm, nfd, S, idx_c, blocks, N = ref["precond_args"]
    blocks_t = [tuple(convert.tensor(a, CPU) for a in blk)
                for blk in blocks]
    return (mesh, convert.interface_dofmap(jdm, CPU), nfd,
            convert.tensor(S, CPU), convert.tensor(idx_c, CPU), blocks_t, N,
            HHODegreeInfo(2, 1), torch.float64), blocks


def test_assembled_face_blocks_match(ref, port):
    """The assembled per-face diagonal blocks from the same condensed
    blocks, 1e-13 relative; they sum both neighbours' contributions."""
    args, _ = _precond_inputs(ref, port)
    jFB = ref["face_blocks"]
    FB = ip._assembled_face_blocks(args[1], args[2], args[5])
    assert _rel(FB, jFB) < 1e-13


def test_mg_precond_apply_matches(ref, port):
    """One application of _interface_mg_precond (uniform V-cycle + P / P^T
    + cut-band Schwarz) to a seeded vector, from identical inputs: 1e-10
    relative; the apply is symmetric (u.M v = v.M u)."""
    args, _ = _precond_inputs(ref, port)
    M = ip._interface_mg_precond(*args)
    n = args[2]
    rng = np.random.default_rng(5)
    r, s = rng.standard_normal(n), rng.standard_normal(n)
    jz = ref["precond_z"]
    z = M(torch.as_tensor(r))
    assert _rel(z, jz) < 1e-10
    a = float(torch.dot(torch.as_tensor(s), z))
    b = float(torch.dot(torch.as_tensor(r), M(torch.as_tensor(s))))
    assert abs(a - b) < 1e-10 * abs(a)


def test_block_jacobi_apply_matches(ref, port):
    """_face_block_jacobi (the branch of kappa contrasts and of other
    meshes) applied to a seeded vector from identical blocks: 1e-12."""
    args, _ = _precond_inputs(ref, port)
    n = args[2]
    r = np.random.default_rng(6).standard_normal(n)
    jz = ref["block_jacobi_z"]
    z = ip._face_block_jacobi(args[1], n, args[5])(torch.as_tensor(r))
    assert _rel(z, jz) < 1e-12


def test_precond_scatter_accumulates_duplicates(ref, port):
    """The Schwarz scatter of the MG preconditioner meets the same global
    dof from several patches (a face shared by two cut cells) and both
    copies of an uncut face of a cut cell at one index: the values add
    up, as JAX's .at[].add does; x[idx] += v keeps one of them."""
    args, _ = _precond_inputs(ref, port)
    idx_c = args[4]
    live = idx_c[idx_c < args[2]]
    assert len(torch.unique(live)) < len(live)      # duplicates present
    vals = torch.arange(1.0, len(live) + 1.0, dtype=torch.float64)
    y = ip._flat_scatter(args[2] + 1, live, vals)
    want = np.zeros(args[2] + 1)
    np.add.at(want, live.numpy(), vals.numpy())
    np.testing.assert_array_equal(y.numpy(), want)
    lossy = torch.zeros(args[2] + 1, dtype=torch.float64)
    lossy[live] += vals
    assert not torch.equal(lossy, y)


def test_take_local_data_and_h1_match(ref, port):
    """take_local_data of both sides (the corrected face offset) and the
    H1 error from the JAX solution vector: 1e-14 / 1e-13 relative."""
    mesh, cd = port
    hdi = HHODegreeInfo(2, 1)
    dm = ip.build_interface_dofmap(mesh, cd, hdi)
    x = convert.tensor(ref["res"].x, CPU)
    fd = convert.tensor(ref["fd"], CPU)
    neg = ip.take_local_data(mesh, dm, cd, x, fd, LOC_NEG)
    pos = ip.take_local_data(mesh, dm, cd, x, fd, LOC_POS)
    assert _rel(neg, ref["neg"]) < 1e-14 and _rel(pos, ref["pos"]) < 1e-14
    geom = cell_geometry(mesh)
    batch = methods.make_cut_batch(mesh, geom, cd, dm.cut_ids)
    h1 = ip.interface_h1_error(mesh, geom, batch, cd, hdi, neg, pos,
                               default_problem().sol_grad)
    assert abs(float(h1) - float(ref["h1"])) < 1e-13 * float(ref["h1"])


def test_solve_interface_matches(ref, port):
    """solve_interface (condensed + MG) at 16^2 k=1 on the JAX classified
    mesh: the MG branch, iterations within 2, H1 within 1e-9 relative,
    the local dofs of both sides within 1e-8 of their max."""
    mesh, cd = port
    p = default_problem()
    res = ip.solve_interface(mesh, cd, p.ls, 1, p.rhs_fun, p.sol_fun,
                             p.sol_grad)
    jres = convert.interface_result(ref["res"], CPU)
    assert res.exit_reason == cg.CONVERGED
    assert abs(res.iterations - jres.iterations) <= 2
    assert abs(res.h1_error - jres.h1_error) < 1e-9 * jres.h1_error
    assert _rel(res.local_neg, ref["neg"]) < 1e-8
    assert _rel(res.local_pos, ref["pos"]) < 1e-8


def test_face_rhs_matches(ref, port):
    """The condensed face-system right-hand side (Dirichlet folded through
    the condensed operator) equal to the JAX CG's to 1e-12."""
    mesh, cd = port
    p = default_problem()
    hdi = HHODegreeInfo(2, 1)
    parms = methods.InterfaceParams()
    asm = ip.assemble_interface(mesh, cd, p.ls, hdi, p.rhs_fun, p.sol_fun,
                                parms)
    fsys = ip.condensed_face_system(mesh, asm, hdi, parms)
    assert fsys.preconditioner == "mg"
    assert _rel(fsys.rhs, ref["rhs"]) < 1e-12


@pytest.mark.parametrize("N", [8, 16])
def test_condensed_equals_full_system(N):
    """condensed=False (the reference's Jacobi PCG on the doubled full
    system) and the condensed solve give the same solution: x within 1e-7
    of max|x| (tol 1e-9 on both)."""
    p = default_problem()
    mesh, cd = cut_preprocess(make_poly_mesh(Nx=N, Ny=N, device=CPU), p.ls,
                              4)
    out = {}
    for condensed in (True, False):
        out[condensed] = ip.solve_interface(mesh, cd, p.ls, 1, p.rhs_fun,
                                            p.sol_fun, p.sol_grad,
                                            condensed=condensed)
        assert out[condensed].exit_reason == cg.CONVERGED
    a, b = out[True].x, out[False].x
    assert float((a - b).abs().max()) <= 1e-7 * float(a.abs().max())
    assert out[False].iterations > out[True].iterations
    assert abs(out[True].h1_error - out[False].h1_error) < \
        1e-6 * out[True].h1_error


def test_kappa_contrast_takes_block_jacobi():
    """kappa_1 = 1, kappa_2 = 3 at 8^2: the structured-MG premise fails,
    the per-face block-Jacobi branch solves, equal to the JAX package's
    run (KAPPA_CONTRAST_8): iterations within 2, H1 within 1e-8."""
    parms = methods.InterfaceParams(1.0, 3.0)
    p = default_problem()
    mesh, cd = cut_preprocess(make_poly_mesh(Nx=8, Ny=8, device=CPU), p.ls, 4)
    assert not ip._is_structured(mesh, parms, "auto")
    assert ip._is_structured(mesh, methods.InterfaceParams(), "auto")
    assert not ip._is_structured(mesh, methods.InterfaceParams(), "bj")
    res = ip.run_interface(8, 1, parms=parms, device=CPU)
    assert res.exit_reason == cg.CONVERGED
    assert abs(res.iterations - KAPPA_CONTRAST_8[0]) <= 2
    assert abs(res.h1_error - KAPPA_CONTRAST_8[1]) < 1e-8 * KAPPA_CONTRAST_8[1]
    bj = ip.run_interface(8, 1, device=CPU, precond_kind="bj")
    mg = ip.run_interface(8, 1, device=CPU)
    assert abs(bj.h1_error - mg.h1_error) < 1e-6 * mg.h1_error
    with pytest.raises(ValueError, match="precond_kind"):
        ip.run_interface(8, 1, device=CPU, precond_kind="jacobi")


def test_run_interface_raises_without_cuda(monkeypatch):
    """No device given and no CUDA: run_interface raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ip.run_interface(8, 1)
