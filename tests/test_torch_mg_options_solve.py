"""The multigrid options the JAX package keeps off by default, end to end,
against proton_tpu on the CPU, float64: the 16^2 solve with each option
(mg_transfer 'smoothed' and 'cut', mg_deflate=4, cheb_ops 'mixed' with
the float32 V-cycle) against the JAX package's on its own 16^2 and 8^2
lean levels, deflation on a mesh without cut cells, and the family app
in float32 (PROTON_TPU_X64=0) against the JAX app run in a subprocess
(this process keeps JAX's x64 on). The options' transfers, deviations,
deflation and V-cycles are in tests/test_torch_mg_options.py.

The JAX package's solves (its _solve_jit over its levels,
torch_jax_reference.jax_solve) and its family app's JSON line are read
from tests/jax_refs/test_torch_mg_options_solve.npz (REFS below;
tests/torch_jax_reference.py writes it, running the JAX package alone).
BLAS and torch run on one thread."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import threadpoolctl
import torch

from proton_tpu.cut import fictdom_structured as jfs
from proton_tpu.core.ops import HHODegreeInfo as JHHODegreeInfo
from proton_tpu.solvers import cg as jcg
from proton_tpu_torch.apps import fictdom_family
from proton_tpu_torch.cut import batched
from proton_tpu_torch.cut import fictdom_structured as fs
from proton_tpu_torch.solvers import cg
import functools

from torch_jax_reference import Refs, jax_solve_ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFS = Refs(__name__)

# The family app's arguments for the float32 comparison.
FAMILY_ARGS = ["-N", "32", "-k", "1", "-B", "2"]


def _jax_family(x64: str):
    """The JAX app with FAMILY_ARGS in a subprocess (x64 as given)."""
    env = dict(os.environ, PROTON_TPU_X64=x64, JAX_PLATFORMS="cpu",
               PROTON_TPU_PLATFORM="cpu",
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    return subprocess.Popen(
        [sys.executable, "-m", "proton_tpu.apps.fictdom_family",
         *FAMILY_ARGS], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _jax_family_line():
    """The JSON line of the JAX app with FAMILY_ARGS in float32 (a
    subprocess with PROTON_TPU_X64=0): what the test reads of it."""
    proc = _jax_family("0")
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-2000:]
    line = json.loads(out.strip().splitlines()[-1])
    return {k: line[k] for k in ("all_converged", "overflow", "iterations",
                                 "h1_errors")}


REFS.add("family_app_f32", "app",
         "PROTON_TPU_X64=0 python -m proton_tpu.apps.fictdom_family "
         + " ".join(FAMILY_ARGS), _jax_family_line)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Keeps BLAS and torch on one thread."""
    with threadpoolctl.threadpool_limits(1):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_family_f32():
    """The JAX family app's stored line in float32."""
    return REFS["family_app_f32"]


@functools.lru_cache(maxsize=None)
def _jax_levels():
    """The JAX package's lean 16^2 level (with its right-hand side) and
    its 8^2 coarse level (build_coarse_level: on the CPU it carries drec),
    k=1."""
    hdi, problem = JHHODegreeInfo(2, 1), jfs.default_problem()
    eta = jfs.nitsche_eta(1)
    return {16: jfs.build_level(16, hdi, problem, eta, 4, False, False,
                                with_rhs=True, fitted="lean"),
            8: jfs.build_coarse_level(8, hdi, problem, eta, 4, False)}


# ---------------------------------------------------------------------------
# End-to-end 16^2 solves
# ---------------------------------------------------------------------------

# name -> (options, iteration slack, H1 rtol)
SOLVES = {"smoothed": (dict(mg_transfer="smoothed"), 2, 1e-6),
          "cut": (dict(mg_transfer="cut"), 2, 1e-6),
          "deflate": (dict(mg_deflate=4), 2, 1e-6),
          "cheb_mixed_mg_f32": (dict(cheb_ops="mixed", mg_f32=True), 3,
                                1e-4)}


def _cg_params(pkg):
    return pkg.CGParams(convergence_threshold=1e-10, divergence_threshold=1e8,
                        max_iter=50000, apply_preconditioner=True)


def _jax_option_solve(name):
    return jax_solve_ref(_jax_levels(), 1, _cg_params(jcg),
                         keep=("iterations", "exit_reason", "h1"),
                         **SOLVES[name][0])


for _name, (_option, _, _) in SOLVES.items():
    REFS.add(f"solve[{_name}]", "solve",
             f"solve_fictdom_structured(16, 1, {_option}, mixed=False, "
             f"use_pallas=False), CG tol 1e-10: _solve_jit over its "
             f"build_level(16, fitted='lean') and build_coarse_level(8)",
             _jax_option_solve, name=_name)


@pytest.mark.parametrize("name", list(SOLVES))
def test_solve_matches_jax(name):
    """solve_fictdom_structured(16, 1, ...) with each option against the
    JAX package's solve at tol 1e-10: both converge, iterations within 2
    and H1 within rtol 1e-6; the float32 V-cycle with the mixed Chebyshev
    pair within 3 and 1e-4 (float32 rounds in another order)."""
    option, slack, rtol = SOLVES[name]
    r = fs.solve_fictdom_structured(16, 1, cg_params=_cg_params(cg),
                                    device="cpu", **option)
    iters, exit_reason, h1 = REFS[f"solve[{name}]"]
    assert r.exit_reason == cg.CONVERGED and exit_reason == 0
    assert abs(r.iterations - iters) <= slack, (r.iterations, iters)
    assert np.isclose(r.h1_error, h1, rtol=rtol), (r.h1_error, h1)
    if option.get("mg_transfer") == "cut":
        assert r.timings["drec_setup_s"] > 0.0
    if option.get("mg_deflate"):
        assert r.timings["deflate_setup_s"] > 0.0


# ---------------------------------------------------------------------------
# The family app's precision switch
# ---------------------------------------------------------------------------


def _app_line(capsys, monkeypatch, x64):
    """The app's JSON line with PROTON_TPU_X64=x64, and the dtypes of the
    local dofs of its geometries' solves (a spy on the condensed solve
    the family calls)."""
    solve, dtypes = batched.structured.solve_condensed_structured_cl, []

    def spy(*args, **kwargs):
        local, res = solve(*args, **kwargs)
        dtypes.append(local.dtype)
        return local, res

    monkeypatch.setattr(batched.structured, "solve_condensed_structured_cl",
                        spy)
    monkeypatch.setenv("PROTON_TPU_X64", x64)
    assert fictdom_family.main([*FAMILY_ARGS, "--device", "cpu"]) == 0
    monkeypatch.undo()
    return (json.loads(capsys.readouterr().out.strip().splitlines()[-1]),
            dtypes)


def test_family_float32_matches_jax_app(jax_family_f32, capsys,
                                        monkeypatch):
    """The port's family app with PROTON_TPU_X64=0 at -N 32 -k 1 -B 2
    runs float32 (the local dofs of every geometry's solve), as the JAX app
    with the same environment (run in a subprocess): all converged,
    iterations within 5%. Their H1 errors
    are float32 noise (both lie 6e-4 to 2e-3 above the float64 ones, the
    port's 1.8e-3 / 2.1e-3 and JAX's 2.5e-3 / 2.2e-3 against 6.5e-4 /
    1.5e-3), so each geometry's float32 H1 must lie no further from the
    float64 H1 than twice the JAX app's does; with the switch unset the
    app runs float64."""
    jax_line = jax_family_f32
    f32, dtypes32 = _app_line(capsys, monkeypatch, "0")
    f64, dtypes64 = _app_line(capsys, monkeypatch, "1")
    assert dtypes32 == [torch.float32] * 2 and dtypes64 == [torch.float64] * 2
    assert f32["all_converged"] and jax_line["all_converged"]
    assert f32["overflow"] == 0 and jax_line["overflow"] == 0
    for a, b in zip(f32["iterations"], jax_line["iterations"]):
        assert abs(a - b) <= 0.05 * b
    for h32, hj, h64 in zip(f32["h1_errors"], jax_line["h1_errors"],
                            f64["h1_errors"]):
        assert abs(h32 - h64) <= 2 * abs(hj - h64), (h32, hj, h64)
    # the float32 run is the float32 library solve
    angles = np.linspace(0.0, 2.0 * np.pi, 2, endpoint=False)
    res = batched.solve_fictdom_family(
        32, 1, np.linspace(0.25, 0.42, 2),
        0.5 + 0.02 * np.stack([np.cos(angles), np.sin(angles)], axis=1),
        device="cpu", dtype=torch.float32)
    assert res.iterations.tolist() == f32["iterations"]


def test_deflation_without_cut_cells_is_a_no_op():
    """mg_deflate on a mesh without cut cells (a circle of radius 2 holds
    the whole square) deflates nothing: the same iterations and local
    dofs as without it, as in the JAX package."""
    problem = fs.default_problem(2.0)
    a = fs.solve_fictdom_structured(16, 1, problem, device="cpu")
    b = fs.solve_fictdom_structured(16, 1, problem, device="cpu",
                                    mg_deflate=4)
    assert a.iterations == b.iterations
    assert torch.equal(a.local, b.local)
    assert "deflate_setup_s" not in b.timings
