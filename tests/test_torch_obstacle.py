"""The port's obstacle solver against proton_tpu on the CPU, float64:
run_obstacle(8, k) against the JAX solve of the same configuration
(active-set iterations equal, alpha and beta within 1e-9), the port alone
against the reference's stored table (apps/obstacle/results/
convergence.txt, BASELINE.md:12-13), the callback, checkpoint and resume
paths, and the obstacle app. The JAX solves run under jax.jit, once per
module."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import threadpoolctl
import torch

from proton_tpu.core.mesh import MeshInitParams as JMeshInitParams, \
    make_quad_mesh as jmake_quad_mesh
from proton_tpu.methods import obstacle as jobstacle
from proton_tpu_torch import convert
from proton_tpu_torch.apps import obstacle as obstacle_app
from proton_tpu_torch.methods import obstacle
from proton_tpu_torch.utils import checkpoint

# energy-norm errors of apps/obstacle/results/convergence.txt:1-3 (the
# table tests/test_obstacle.py holds the JAX package to)
REFERENCE_TABLE = {
    0: {8: 2.26205, 16: 1.2833, 32: 0.650286},
    1: {8: 0.197735, 16: 0.0588187, 32: 0.0171607},
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """BLAS and torch on one thread: with a pool per core in every test
    worker the cores are oversubscribed many times over."""
    with threadpoolctl.threadpool_limits(1):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)


def _jax_reference_solve(k):
    """The JAX package's run_obstacle(8, k) configuration (obstacle.py:
    run_obstacle: [-1, 1]^2, r0 = 0.7, zero obstacle) as one jitted
    solve_obstacle call on the same mesh."""
    r0 = 0.7

    def rhs_fun(p):
        r2 = p[..., 0] ** 2 + p[..., 1] ** 2
        return jnp.where(r2 > r0 * r0, -16.0 * r2 + 8.0 * r0 * r0,
                         -8.0 * (r0 * r0 * (r0 * r0 + 1.0))
                         + 8.0 * r0 * r0 * r2)

    def sol_fun(p):
        r2 = p[..., 0] ** 2 + p[..., 1] ** 2
        t = jnp.maximum(r2 - r0 * r0, 0.0)
        return t * t

    mesh = jmake_quad_mesh(JMeshInitParams(min_x=-1.0, min_y=-1.0, Nx=8,
                                           Ny=8))
    return jax.jit(lambda: jobstacle.solve_obstacle(
        mesh, k, rhs_fun, sol_fun, lambda p: jnp.zeros_like(p[..., 0]),
        sol_fun))()


@pytest.fixture(scope="module")
def jax_results():
    return {k: _jax_reference_solve(k) for k in (0, 1)}


@pytest.mark.parametrize("k", [0, 1])
def test_run_obstacle_matches_jax(jax_results, k):
    """Active-set iterations equal, alpha and beta within 1e-9 (relative
    to their largest entry), the energy error rtol 1e-8, both converged;
    the JAX solve itself holds the reference value."""
    jr = convert.obstacle_result(jax_results[k], torch.device("cpu"))
    r = obstacle.run_obstacle(8, k, device="cpu")
    assert r.converged and jr.converged
    assert r.iterations == jr.iterations
    for a, b in ((r.alpha, jr.alpha), (r.beta, jr.beta)):
        assert a.shape == b.shape and a.dtype == torch.float64
        assert float((a - b).abs().max()) <= 1e-9 * float(b.abs().max())
    assert np.isclose(float(r.energy_error), float(jr.energy_error),
                      rtol=1e-8)
    ref = REFERENCE_TABLE[k][8]
    assert abs(float(jr.energy_error) - ref) / ref < 1e-4


@pytest.mark.parametrize("k", [0, 1])
def test_obstacle_matches_reference_table(k):
    """N = 8, 16, 32: converged, energy error within 1e-4 (relative) of
    the reference's stored table."""
    for N, ref in REFERENCE_TABLE[k].items():
        r = obstacle.run_obstacle(N, k, device="cpu")
        assert r.converged
        err = float(r.energy_error)
        assert abs(err - ref) / ref < 1e-4, (N, k, err, ref)


def test_callback_checkpoint_and_resume(tmp_path):
    """The callback sees every iteration with its fields; a checkpoint
    after 2 iterations, resumed, reaches the full run's answer (rtol
    1e-8); the complementarity of the active set holds."""
    full = obstacle.run_obstacle(16, 0, device="cpu")
    seen = []

    def cb(i, fields):
        seen.append((i, fields["delta"], fields["cg_iterations"]))
        checkpoint.obstacle_checkpoint(str(tmp_path / "state.npz"),
                                       fields["alpha"], fields["beta"], i)

    part = obstacle.run_obstacle(16, 0, device="cpu", iteration_callback=cb,
                                 max_iter=2)
    assert [s[0] for s in seen] == [1, 2] and not part.converged
    assert all(s[2] > 0 for s in seen)
    alpha, beta, it = checkpoint.obstacle_resume(str(tmp_path / "state.npz"))
    assert it == 2 and alpha.shape == beta.shape == (256,)
    resumed = obstacle.run_obstacle(16, 0, device="cpu",
                                    initial_state=(alpha, beta))
    assert resumed.converged
    assert resumed.iterations == full.iterations - 2
    assert np.isclose(float(resumed.energy_error), float(full.energy_error),
                      rtol=1e-8)
    cells = full.alpha[:256]
    active = full.beta != 0
    assert active.any() and not active[0]
    assert float(cells[active].abs().max()) == 0.0
    assert float(cells[~active].min()) > -1e-9


def test_obstacle_app_and_degree_fallback(tmp_path, monkeypatch, capsys):
    """The CLI with --device cpu: dumps, per-iteration VTK files, a
    checkpoint, and a resumed run; an invalid degree falls back to 1."""
    monkeypatch.chdir(tmp_path)
    state = str(tmp_path / "state.npz")
    assert obstacle_app.main(["-k", "1", "-N", "8", "--device", "cpu",
                              "--dump", "--dump-iterations",
                              "--checkpoint", state]) == 0
    out = capsys.readouterr().out
    assert "Error: 0.19773" in out
    assert (tmp_path / "obstacle_solution.vtk").exists()
    assert (tmp_path / "obstacle_cycle_0.vtk").exists()
    assert obstacle_app.main(["-k", "1", "-N", "8", "--device", "cpu",
                              "--resume", state]) == 0
    assert "resuming" in capsys.readouterr().out
    r = obstacle.run_obstacle(8, 3, device="cpu")
    assert "Falling back to 1" in capsys.readouterr().out
    assert r.converged and np.isclose(float(r.energy_error),
                                      REFERENCE_TABLE[1][8], rtol=1e-4)
