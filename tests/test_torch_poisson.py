"""The port's uncut HHO Poisson path against proton_tpu on the CPU,
float64: the dofmap and face incidence (exact), operator applies,
diagonals and right-hand sides (1e-13), the sparse export, CG with its
residual history and the dense solve, static condensation, solve_poisson
with its errors, and the convergence, stabilization and polymesh apps.
Meshes: the generated 8 x 8 quad mesh and a brick mesh of mixed 4-, 5-
and 6-gons. Every JAX reference runs under jax.jit, once per module."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import threadpoolctl
import torch

import proton_tpu as pt
from proton_tpu.core import geometry as jgeometry, ops as jops
from proton_tpu.methods import assembly as jassembly, \
    condensation as jcondensation, hho as jhho, poisson as jpoisson
from proton_tpu.solvers import cg as jcg
from proton_tpu_torch import convert
from proton_tpu_torch.apps import convergence_test, polymesh, \
    stabilization_test
from proton_tpu_torch.core import geometry, mesh, ops
from proton_tpu_torch.methods import assembly, condensation, poisson
from proton_tpu_torch.solvers import cg
from proton_tpu_torch.tools.brick_mesh import write_brick_mesh

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """BLAS and torch on one thread: with a pool per core in every test
    worker the cores are oversubscribed many times over."""
    with threadpoolctl.threadpool_limits(1):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)
PI = np.pi
DOFMAP_FIELDS = ("asm_idx", "free_local", "dirichlet_local",
                 "face_compress", "is_dirichlet_face")


def _problem(lib):
    """sin(pi x) sin(pi y), its load and its gradient, in jnp or torch."""
    def sol(p):
        return lib.sin(PI * p[..., 0]) * lib.sin(PI * p[..., 1])

    def grad(p):
        return lib.stack(
            [PI * lib.cos(PI * p[..., 0]) * lib.sin(PI * p[..., 1]),
             PI * lib.sin(PI * p[..., 0]) * lib.cos(PI * p[..., 1])], -1)

    return (lambda p: 2.0 * PI ** 2 * sol(p)), sol, grad


def _close(a, ref, tol=1e-13):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    ref = np.asarray(ref)
    assert a.shape == ref.shape
    assert np.max(np.abs(a - ref)) <= tol * np.max(np.abs(ref))


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """name -> (JAX mesh, port mesh, (cell, face) degrees): the 8 x 8 quad
    mesh at k=1 and the 3 x 4 brick mesh at equal order 1."""
    path = tmp_path_factory.mktemp("mesh") / "brick.txt"
    write_brick_mesh(path, 3, 4)
    jb = pt.load_poly_mesh(str(path))
    jq = pt.make_quad_mesh(Nx=8, Ny=8)
    return {"quad": (jq, convert.mesh(jq, CPU), (2, 1)),
            "brick": (jb, convert.mesh(jb, CPU), (1, 1))}


@pytest.fixture(scope="module")
def systems(cases):
    """name -> (lc, loads f, Dirichlet data g_loc, dofmap) of the port."""
    rhs, sol, _ = _problem(torch)
    out = {}
    for name, (_, tm, hd) in cases.items():
        hdi = ops.HHODegreeInfo(*hd)
        tg = geometry.cell_geometry(tm)
        lc = poisson.assemble_local(tm, tg, hdi)[1]
        dm = assembly.build_dofmap(tm, hdi)
        g_loc = assembly.local_dirichlet_data(
            dm, tm, assembly.dirichlet_face_data(tm, hdi, sol))
        out[name] = (lc, ops.cell_rhs(tm, tg, hdi.cell_degree, rhs), g_loc,
                     dm)
    return out


@pytest.fixture(scope="module")
def jax_refs(cases, systems):
    """Per case, the JAX package's assembly and condensation functions on
    the port's local operators lc, loads f, Dirichlet data g and a random
    vector x, as one jax.jit call."""
    out = {}
    for name, (jm, _, hd) in cases.items():
        jh = jops.HHODegreeInfo(*hd)
        lc, f, g, _ = systems[name]
        jdm = jassembly.build_dofmap(jm, jh)
        inc = jassembly.build_face_incidence(jm, jdm)
        x = np.random.default_rng(1).standard_normal(jdm.n_dofs)
        blocks = ((jdm.asm_idx[:7], jnp.asarray(lc.numpy()[:7])),
                  (jdm.asm_idx, jnp.asarray(lc.numpy())))

        def run(lc, f, g, x):
            A = jassembly.make_operator(jdm, lc)
            sys_ = jcondensation.condense(lc, f, jdm.cbs)
            _, nfd = jcondensation.face_dof_view(jdm)
            xf = x[:nfd]
            return [A(x), jassembly.operator_diagonal(jdm, lc),
                    jassembly.assemble_rhs(jdm, f, lc, g),
                    jassembly.take_local_data(jdm, x, g),
                    jassembly.make_gather_operator(jdm, inc, lc)(x),
                    jassembly.make_multi_operator(jdm.n_dofs, blocks)(x),
                    jassembly.multi_operator_diagonal(jdm.n_dofs, blocks),
                    jassembly.multi_assemble_rhs(
                        jdm.n_dofs, [(jdm.asm_idx, g), (jdm.asm_idx, g)]),
                    *sys_,
                    jcondensation.make_condensed_operator(jdm, None,
                                                          sys_.S)(xf),
                    jcondensation.make_condensed_operator(jdm, inc,
                                                          sys_.S)(xf),
                    jcondensation.condensed_diagonal(jdm, sys_.S),
                    jcondensation.condensed_rhs(jdm, sys_, g),
                    jcondensation.recover_local(jdm, sys_, xf, g)]

        vals = jax.jit(run)(*(jnp.asarray(a.numpy()) for a in (lc, f, g)),
                            jnp.asarray(x))
        out[name] = (jdm, inc, x, [np.asarray(v) for v in vals])
    return out


@pytest.mark.parametrize("name", ["quad", "brick"])
def test_dofmap_and_incidence_equal(cases, systems, jax_refs, name):
    """Every array of the dofmap and the face incidence, exactly; on the
    generated mesh build_dofmap is build_dofmap_structured."""
    jdm, jinc = jax_refs[name][:2]
    dm = systems[name][-1]
    for f in DOFMAP_FIELDS:
        np.testing.assert_array_equal(getattr(dm, f).numpy(),
                                      np.asarray(getattr(jdm, f)))
    for f in ("cbs", "fbs", "n_cells", "n_dofs"):
        assert getattr(dm, f) == getattr(jdm, f)
    inc = assembly.build_face_incidence(cases[name][1], dm)
    for a, b in zip((inc.face_cells, inc.face_slot, inc.expand),
                    (jinc.face_cells, jinc.face_slot, jinc.expand)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    converted = convert.dofmap(jdm, CPU)
    assert all(torch.equal(getattr(converted, f), getattr(dm, f))
               for f in DOFMAP_FIELDS)
    if name == "quad":
        for k in (0, 1, 2):
            hdi = ops.HHODegreeInfo(k + 1, k)
            a = assembly.build_dofmap(mesh.make_quad_mesh(Nx=8, Ny=8,
                                                          device=CPU), hdi)
            b = assembly.build_dofmap_structured(8, hdi, device=CPU)
            assert all(torch.equal(getattr(a, f), getattr(b, f))
                       for f in DOFMAP_FIELDS) and a.n_dofs == b.n_dofs


@pytest.mark.parametrize("name", ["quad", "brick"])
def test_assembly_and_condensation_match(systems, jax_refs, name):
    """Operator applies (scatter and gather form, two-block operator),
    diagonals, right-hand sides, local data, and every condensation
    function against JAX on the same lc, f, g and x: 1e-13 relative."""
    lc, f, g, dm = systems[name]
    _, jinc, x, ref = jax_refs[name]
    x = torch.as_tensor(x)
    inc = convert.face_incidence(jinc, CPU)
    blocks = ((dm.asm_idx[:7], lc[:7]), (dm.asm_idx, lc))
    sys_ = condensation.condense(lc, f, dm.cbs)
    _, nfd = condensation.face_dof_view(dm)
    xf = x[:nfd]
    out = [assembly.make_operator(dm, lc)(x),
           assembly.operator_diagonal(dm, lc),
           assembly.assemble_rhs(dm, f, lc, g),
           assembly.take_local_data(dm, x, g),
           assembly.make_gather_operator(dm, inc, lc)(x),
           assembly.make_multi_operator(dm.n_dofs, blocks)(x),
           assembly.multi_operator_diagonal(dm.n_dofs, blocks),
           assembly.multi_assemble_rhs(dm.n_dofs, [(dm.asm_idx, g),
                                                   (dm.asm_idx, g)]),
           *sys_,
           condensation.make_condensed_operator(dm, None, sys_.S)(xf),
           condensation.make_condensed_operator(dm, inc, sys_.S)(xf),
           condensation.condensed_diagonal(dm, sys_.S),
           condensation.condensed_rhs(dm, sys_, g),
           condensation.recover_local(dm, sys_, xf, g)]
    assert len(out) == len(ref)
    for i, (a, b) in enumerate(zip(out, ref)):
        _close(a, b, 1e-12 if i >= 8 else 1e-13)
    assert isinstance(convert.condensed_system(
        jcondensation.CondensedSystem(*ref[8:13]), CPU),
        condensation.CondensedSystem)


def test_scatter_accumulates_duplicates():
    """Repeated indices add up (JAX segment_sum semantics), the sentinel
    bin is dropped; x[idx] += v would keep one of the duplicates."""
    idx = torch.tensor([[0, 2, 2, 5], [2, 0, 5, 5]])
    vals = torch.arange(1.0, 9.0, dtype=torch.float64).reshape(2, 4)
    y = assembly.scatter_values(idx, 5, vals)
    ref = jassembly.scatter_values(jnp.asarray(idx.numpy()), 5,
                                   jnp.asarray(vals.numpy()))
    np.testing.assert_array_equal(y.numpy(), np.asarray(ref))
    assert y.tolist() == [1.0 + 6.0, 0.0, 2.0 + 3.0 + 5.0, 0.0, 0.0]
    lossy = torch.zeros(6, dtype=torch.float64)
    lossy[idx.reshape(-1)] += vals.reshape(-1)
    assert not torch.equal(lossy[:5], y)


@pytest.mark.parametrize("name", ["quad", "brick"])
def test_assemble_bcoo_is_the_operator(systems, name):
    """The coalesced sparse matrix, densified, is make_operator applied to
    the identity (1e-13) and symmetric."""
    lc, _, _, dm = systems[name]
    A = assembly.assemble_bcoo(dm, lc)
    assert A.is_coalesced() and A.shape == (dm.n_dofs, dm.n_dofs)
    dense = A.to_dense()
    apply_A = assembly.make_operator(dm, lc)
    cols = torch.stack([apply_A(e) for e in
                        torch.eye(dm.n_dofs, dtype=torch.float64)], 1)
    _close(dense, cols)
    _close(dense, dense.T)


def test_sparse_dump_and_outputs(systems, tmp_path):
    """dump_sparse_matrix writes the coalesced matrix's triplets; the
    point-cloud writers write every row; HHODegreeInfo.equal_order."""
    from proton_tpu_torch.io import gnuplot, vtk

    lc, _, _, dm = systems["brick"]
    A = assembly.assemble_bcoo(dm, lc)
    vtk.dump_sparse_matrix(A, str(tmp_path / "A.txt"))
    rows = np.loadtxt(tmp_path / "A.txt")
    dense = np.zeros((dm.n_dofs, dm.n_dofs))
    dense[rows[:, 0].astype(int), rows[:, 1].astype(int)] = rows[:, 2]
    np.testing.assert_array_equal(dense, A.to_dense().numpy())
    out = gnuplot.PostprocessOutput()
    for i in range(2):
        g = gnuplot.GnuplotOutput(str(tmp_path / f"p{i}.dat"))
        g.add_data(torch.rand(3, 4, 2), torch.rand(3, 4))
        out.add_object(g)
    assert out.write()
    assert np.loadtxt(tmp_path / "p1.dat").shape == (12, 3)
    assert ops.HHODegreeInfo.equal_order(2) == ops.HHODegreeInfo(2, 2)


def test_cg_history_and_dense_solve():
    """The residual history against JAX's on one SPD system (same
    iterations, same NaN padding, entries within 1e-12 of nr/nr0 = 1:
    the two recurrences round apart near the tolerance), and
    solve_spd_dense."""
    rng = np.random.default_rng(3)
    B = rng.standard_normal((40, 40))
    A = B @ B.T + 40 * np.eye(40)
    b = rng.standard_normal(40)
    kw = dict(convergence_threshold=1e-10, divergence_threshold=1e8,
              max_iter=60, apply_preconditioner=True, record_history=True)
    jr = jax.jit(lambda A, b: jcg.conjugated_gradient(
        lambda x: A @ x, b, jnp.diagonal(A), jcg.CGParams(**kw)))(
        jnp.asarray(A), jnp.asarray(b))
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    r = cg.conjugated_gradient(lambda x: At @ x, bt, torch.diagonal(At),
                               cg.CGParams(**kw))
    assert r.iterations == int(jr.iterations) and r.exit_reason == 0
    h, jh = r.history.numpy(), np.asarray(jr.history)
    assert h.shape == jh.shape == (62,)
    np.testing.assert_array_equal(np.isnan(h), np.isnan(jh))
    assert h[0] == 1.0 and h[r.iterations] == r.rel_residual
    ok = ~np.isnan(h)
    assert np.abs(h[ok] - jh[ok]).max() < 1e-12
    assert cg.conjugated_gradient(lambda x: At @ x, bt, torch.diagonal(At),
                                  cg.CGParams(apply_preconditioner=True)
                                  ).history is None
    x = cg.solve_spd_dense(At, bt)
    _close(x, jcg.solve_spd_dense(jnp.asarray(A), jnp.asarray(b)), 1e-12)
    _close(cg.solve_spd_dense(At, bt[:, None])[:, 0], x, 1e-15)


# JAX package, CPU, float64, eager: the iterations of
# solve_poisson(make_quad_mesh(Nx=8, Ny=8), build_dofmap(...),
# HHODegreeInfo(k + 1, k), rhs, sol) with its default CG parameters (tol
# 1e-12, Jacobi). The jitted pipeline below rounds differently at the
# residual floor: at k=2 its residual crosses 1e-12 two iterations earlier
# (25); the errors agree to 1e-14 either way.
EAGER_ITERATIONS = {0: 3, 1: 8, 2: 27}


@pytest.fixture(scope="module")
def jax_solutions(cases):
    """JAX make_jitted_pipeline results (the port's PoissonSolution,
    errors) at 8 x 8, k = 0, 1, 2, and on the brick mesh at equal order
    1."""
    rhs, sol, grad = _problem(jnp)
    runs = {k: (pt.make_quad_mesh(Nx=8, Ny=8), jops.HHODegreeInfo(k + 1, k))
            for k in (0, 1, 2)}
    runs["brick"] = (cases["brick"][0], jops.HHODegreeInfo(1, 1))
    out = {}
    for key, (jm, jh) in runs.items():
        s, e = jpoisson.make_jitted_pipeline(jh, rhs, sol, grad)(
            jm, jassembly.build_dofmap(jm, jh))
        out[key] = (convert.poisson_solution(s, CPU), [float(v) for v in e])
    return out


@pytest.mark.parametrize("k", [0, 1, 2])
def test_solve_poisson_matches_jax(jax_solutions, k):
    """8 x 8, (k+1, k), HHO stabilization, tol 1e-12: iterations within 1
    of the JAX package's, the three errors rtol 1e-8, local dofs 1e-9;
    the plain pipeline and the naive stabilization run too."""
    rhs, sol, grad = _problem(torch)
    tm = mesh.make_quad_mesh(Nx=8, Ny=8, device=CPU)
    hdi = ops.HHODegreeInfo(k + 1, k)
    dm = assembly.build_dofmap(tm, hdi)
    timings = {}
    s = poisson.solve_poisson(tm, dm, hdi, rhs, sol, timings=timings)
    e = poisson.compute_errors(tm, hdi, s, sol, grad)
    jsol, jerr = jax_solutions[k]
    assert s.exit_reason == jsol.exit_reason == cg.CONVERGED
    assert abs(s.iterations - EAGER_ITERATIONS[k]) <= 1
    np.testing.assert_allclose([float(v) for v in e], jerr, rtol=1e-8)
    _close(s.local, jsol.local, 1e-9)
    _close(s.oper, jsol.oper, 1e-12)
    assert set(timings) == {"geometry_s", "local_operators_s", "rhs_s",
                            "cg_s", "recover_s"}
    ps, pe = poisson.make_jitted_pipeline(hdi, rhs, sol, grad)(tm, dm)
    assert torch.equal(ps.local, s.local) and torch.equal(pe.l2, e.l2)
    naive = poisson.solve_poisson(tm, dm, hdi, rhs, sol, stab="naive")
    assert naive.exit_reason == cg.CONVERGED
    with pytest.raises(ValueError, match="stabilization"):
        poisson.assemble_local(tm, geometry.cell_geometry(tm), hdi, "x")


def test_solve_poisson_on_brick_mesh_matches_jax(cases, jax_solutions):
    """Mixed 4-, 5- and 6-gons at equal order 1: errors rtol 1e-8, local
    dofs 1e-9; the converted JAX solution holds the same arrays."""
    rhs, sol, grad = _problem(torch)
    tm = cases["brick"][1]
    hdi = ops.HHODegreeInfo(1, 1)
    s = poisson.solve_poisson(tm, assembly.build_dofmap(tm, hdi), hdi,
                              rhs, sol)
    e = poisson.compute_errors(tm, hdi, s, sol, grad)
    jsol, jerr = jax_solutions["brick"]
    assert abs(s.iterations - jsol.iterations) <= 1
    np.testing.assert_allclose([float(v) for v in e], jerr, rtol=1e-8)
    _close(s.local, jsol.local, 1e-9)


@pytest.mark.parametrize("name", ["quad", "brick"])
def test_condensed_equals_full(cases, systems, name):
    """solve_condensed in both forms (indexed-add scatter, gather through
    the face incidence) against the full system's local dofs, 1e-9, in
    fewer iterations; timings by phase when asked."""
    lc, f, g, dm = systems[name]
    rhs, sol, _ = _problem(torch)
    tm = cases[name][1]
    hdi = ops.HHODegreeInfo(*cases[name][2])
    full = poisson.solve_poisson(tm, dm, hdi, rhs, sol)
    inc = assembly.build_face_incidence(tm, dm)
    for form in (None, inc):
        timings = {}
        local, res = condensation.solve_condensed(dm, lc, f, g, form,
                                                  timings=timings)
        assert res.exit_reason == cg.CONVERGED
        assert res.iterations <= full.iterations
        assert float((local - full.local).abs().max()) < 1e-9
        assert set(timings) == {"condense_s", "cg_s", "recover_s"}


# JAX package, CPU, float64: (L2, L2 projection, energy, CG iterations) of
# the convergence study's solve (HHODegreeInfo(k + 1, k), HHO
# stabilization, Jacobi PCG at tol 1e-12, max_iter 3 * n_dofs; the rows of
# RESULTS.md:14-17), (k, N) -> row.
CONVERGENCE_JAX = {
    (0, 16): (0.013701639764531252, 0.01360735074042245,
              0.17797381888468272, 3),
    (0, 32): (0.0034297752773830457, 0.003406195247076536,
              0.08902274419419968, 3),
    (1, 16): (0.0003510074491135749, 0.00034626374512449794,
              0.008642172473482673, 10),
    (1, 32): (4.31639460481676e-05, 4.255989317592748e-05,
              0.0021243470741231906, 14)}


def test_convergence_app_matches_jax_and_runs(tmp_path, monkeypatch, capsys):
    """test_method_convergence at N = 16 and 32, k = 0, 1: the JAX
    package's errors (rtol 1e-8) and iterations (within 1), orders near
    k+2 / k+1; the CLI with --device cpu writes its history files; the
    direct path gives the iterative errors (rtol 1e-7)."""
    monkeypatch.chdir(tmp_path)
    ctp = convergence_test.ConvergenceTestParams(deg_min=0, deg_max=1,
                                                 min_N=16, steps=2)
    rows = convergence_test.test_method_convergence(ctp, write_files=False,
                                                    device="cpu")
    for k in (0, 1):
        for N, row in zip((16, 32), rows[k]):
            ref = CONVERGENCE_JAX[(k, N)]
            np.testing.assert_allclose(row[:3], ref[:3], rtol=1e-8)
            assert abs(row.iterations - ref[3]) <= 1 and row.seconds > 0
        order = np.log2(rows[k][0].l2 / rows[k][1].l2)
        assert abs(order - (k + 2)) < 0.1
    assert convergence_test.main(["--deg-min", "1", "--deg-max", "1",
                                  "--min-N", "2", "--steps", "2",
                                  "--device", "cpu"]) == 0
    assert (tmp_path / "hho_history_precond_1.txt").exists()
    hist = np.loadtxt(tmp_path / "cg_history_precond_4_1.txt")
    assert hist[0] == 1.0 and hist[-1] < 1e-12
    direct = convergence_test.test_method_convergence(
        convergence_test.ConvergenceTestParams(
            deg_min=1, deg_max=1, min_N=4, steps=1, direct=True),
        write_files=False, device="cpu")[1][0]
    it = convergence_test.test_method_convergence(
        convergence_test.ConvergenceTestParams(deg_min=1, deg_max=1,
                                               min_N=4, steps=1),
        write_files=False, device="cpu")[1][0]
    np.testing.assert_allclose(direct[:3], it[:3], rtol=1e-7)
    assert direct.iterations == 0
    assert "Testing degree 1" in capsys.readouterr().out


def test_stabilization_app_matches_jax(capsys):
    """test_stabilization(4, k) against the same quantity from the JAX
    package's operators (jitted), 1e-12; the CLI on the CPU prints one
    line of orders per degree k = 0..5, the last order of k = 0..4 (first
    cell, N = 16 -> 32) near 4, 4, 4, 6, 6 (k = 5 reaches the rounding
    floor, as in the reference)."""
    for k in (1, 2):
        hdi = jops.HHODegreeInfo(k, k)
        jm = pt.make_quad_mesh(Nx=4, Ny=4)
        f = lambda p: 2.0 * PI ** 2 * jnp.sin(2 * PI * p[..., 0]) * \
            jnp.sin(2 * PI * p[..., 1])

        def value(m):
            g = jgeometry.cell_geometry(m)
            oper, _ = jhho.hho_laplacian(m, g, hdi)
            S = jhho.fancy_stabilization(m, g, hdi, oper)
            proj = jops.project_function(m, g, hdi, f)
            return jnp.sqrt(proj[0] @ S[0] @ proj[0])

        ref = float(jax.jit(value)(jm))
        assert np.isclose(stabilization_test.test_stabilization(4, k, "cpu"),
                          ref, rtol=1e-12)
    assert stabilization_test.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 6
    for ln, expected in zip(lines, (4, 4, 4, 6, 6)):
        orders = [float(v) for v in ln.split()]
        assert len(orders) == 4 and abs(orders[-1] - expected) < 0.2


# JAX package, CPU, float64: L2 error against the projection and CG
# iterations of apps/polymesh.py's solve (HHODegreeInfo(k, k), Jacobi PCG
# at tol 1e-12) on the 16 x 16 brick mesh of
# proton_tpu_torch/tools/brick_mesh.py (264 cells).
BRICK16_JAX = {0: (0.010804982244290178, 79),
               1: (0.00040385578148711607, 195)}


@pytest.mark.parametrize("k", [0, 1])
def test_polymesh_app(tmp_path, monkeypatch, capsys, k):
    """run_polymesh on the 16 x 16 brick mesh against the JAX numbers
    (L2 against the projection rtol 1e-8, iterations within 2); the CLI
    with --device cpu writes its VTK and point-cloud files."""
    monkeypatch.chdir(tmp_path)
    write_brick_mesh(tmp_path / "brick16.txt", 16, 16)
    r = polymesh.run_polymesh(str(tmp_path / "brick16.txt"), k, "cpu")
    err, iters = BRICK16_JAX[k]
    assert np.isclose(r.l2_proj, err, rtol=1e-8)
    assert abs(r.sol.iterations - iters) <= 2
    assert r.mesh.num_cells == 264
    assert polymesh.main([str(tmp_path / "brick16.txt"), "-k", str(k),
                          "--device", "cpu"]) == 0
    assert "L2-norm error" in capsys.readouterr().out
    text = (tmp_path / "polymesh_solution.vtk").read_text()
    assert "CELLS 264" in text and "\n6 " in text
    assert (tmp_path / "polymesh_solution.dat").stat().st_size > 0
