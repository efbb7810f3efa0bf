"""The port's bench entry point (proton_tpu_torch/bench.py) on the CPU:
its line against the JAX package at 32^2 k=1, its timed assembly
against the fully assembled level, its keys against the JAX bench's
(read from bench.py without importing it), the stock form's two lines, a
failed k=2 run, the knobs that reach the library solve, the line of each
precision mode, the knobs that are not ported, and the device rule. The
JAX package's classification and dofmap counts at 32^2 are read from
tests/jax_refs/test_torch_bench.npz (REFS below;
tests/torch_jax_reference.py writes it)."""

import ast
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import threadpoolctl
import torch

from proton_tpu.core.ops import HHODegreeInfo as JHHODegreeInfo
from proton_tpu.cut import fictdom_structured as jfs
from proton_tpu.methods import assembly as jassembly
from proton_tpu_torch import bench
from proton_tpu_torch.core.ops import HHODegreeInfo
from proton_tpu_torch.cut import fictdom_structured as fs
from proton_tpu_torch.solvers import cg
from torch_jax_reference import Refs

ROOT = Path(__file__).resolve().parent.parent

# JAX package, CPU, float64, solve_fictdom_structured(32, 1, precond="mg",
# fitted="lean", mixed=False, use_pallas=False), CG tol 1e-10, divergence
# 1e8, max_iter 50000: (iterations, H1 error). The same numbers as
# tests/test_torch_lean.py's MG_GATES[(32, 1)] and chip_smoke.py's
# MG_GATES[32] (a live JAX solve here costs a minute of tracing).
JAX_32 = (15, 1.134476548999272e-3)
REFS = Refs(__name__)


def _jax_counts_32():
    """The JAX package's cell and cut-cell counts of its 32^2
    classification, and its build_dofmap_structured(32, k=1) sizes."""
    jmesh, _, jcut = jfs.classify_level(32, jfs.default_problem(), 4)
    jdm = jassembly.build_dofmap_structured(32, JHHODegreeInfo(2, 1))
    return dict(cells=jmesh.num_cells, cut_cells=len(jcut),
                n_dofs=jdm.n_dofs, n_cells=jdm.n_cells, cbs=jdm.cbs)


REFS.add("counts_32", "classification",
         "classify_level(32, default_problem(), 4) and "
         "build_dofmap_structured(32, HHODegreeInfo(2, 1))", _jax_counts_32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """BLAS and torch on one thread (see tests/test_torch_solve.py)."""
    with threadpoolctl.threadpool_limits(1):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)


def _clean_env(**knobs):
    """os.environ without PROTON_BENCH_* knobs, plus ``knobs``, with one
    thread per process (the suite runs several test files at once)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PROTON_BENCH_")}
    env["OMP_NUM_THREADS"] = "1"
    env.update({f"PROTON_BENCH_{k}": str(v) for k, v in knobs.items()})
    return env


@pytest.fixture(scope="module")
def run32():
    """(result, local, the timed assembly's condensed system) of the bench
    at 32^2 k=1, tol 1e-10, on the CPU, precision unset (float64
    throughout); the default values of three knobs are set and pass
    (PALLAS=1, the one value of an unported knob that is accepted;
    MGTRANSFER=uniform and CHEBOPS=exact, the defaults of two ported
    ones)."""
    with pytest.MonkeyPatch.context() as mp:
        for name in [k for k in os.environ if k.startswith("PROTON_BENCH_")]:
            mp.delenv(name)
        mp.setenv("PROTON_BENCH_TOL", "1e-10")
        mp.setenv("PROTON_BENCH_MGTRANSFER", "uniform")
        mp.setenv("PROTON_BENCH_PALLAS", "1")
        mp.setenv("PROTON_BENCH_CHEBOPS", "exact")
        return bench._run_bench(32, 1, device="cpu")


def test_bench_matches_jax_at_32(run32):
    """Cells, cut cells, dofs and condensed dofs equal the JAX package's
    (its classification and build_dofmap_structured); iterations within
    2 and H1 within rtol 1e-6 of its lean + MG solve; local dofs equal to
    the port's solve_fictdom_structured at the same tolerance to 1e-12."""
    result, local, _ = run32
    jax = REFS["counts_32"]
    assert result["cells"] == int(jax.cells) == 32 * 32
    assert result["cut_cells"] == jax.cut_cells
    assert result["dofs"] == jax.n_dofs
    assert result["condensed_dofs"] == jax.n_dofs - jax.n_cells * jax.cbs
    assert result["cg_exit"] == cg.CONVERGED
    assert result["cg_rel_residual"] < 1e-10
    assert abs(result["cg_iters"] - JAX_32[0]) <= 2
    assert np.isclose(result["h1_error"], JAX_32[1], rtol=1e-6)
    r = fs.solve_fictdom_structured(
        32, 1, cg_params=cg.CGParams(1e-10, 1e8, 50000, True), device="cpu")
    assert r.iterations == result["cg_iters"]
    assert float((local - r.local).abs().max()) <= 1e-12
    assert result["value"] == result["cells"] / result["assembly_s"]
    assert result["backend"] == "cpu" and result["precision"] == "f64"
    assert result["peak_gb"] is None and result["cut_splice_s"] == 0.0


def test_timed_assembly_matches_full_level(run32):
    """The headline phase's output (K1 on every cell, the Nitsche cut
    class, the loads, the condensation) equals the fully assembled level
    of build_level(fitted="full") member by member to 1e-12 of its
    largest entry: nothing of it may be dropped, though the bench solves
    the lean system."""
    _, _, cond = run32
    ref = fs.build_level(32, HHODegreeInfo(2, 1), fs.default_problem(),
                         fs.nitsche_eta(1), 4, device="cpu",
                         fitted="full").cond
    assert cond._fields == ref._fields
    for name, a, b in zip(ref._fields, cond, ref):
        assert a.shape == b.shape, name
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max()), \
            name


def _jax_bench_keys():
    """(keys of bench.py's result dict, its _K2_FIELDS), read with ast."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    result_keys, k2_fields = None, None
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1 or \
                not isinstance(node.targets[0], ast.Name):
            continue
        name = node.targets[0].id
        if name == "result" and isinstance(node.value, ast.Dict):
            result_keys = [k.value for k in node.value.keys]
        elif name == "_K2_FIELDS":
            k2_fields = [e.value for e in node.value.elts]
    assert result_keys and k2_fields
    return result_keys, k2_fields


def test_line_holds_every_jax_key(run32):
    """The port's line holds every key of the JAX bench's result dict,
    its _K2_FIELDS every field of the JAX bench's, and every one of them
    is a key of its own line; plus the card's keys."""
    result, _, _ = run32
    keys, k2 = _jax_bench_keys()
    assert set(keys) <= set(result)
    assert set(k2) <= set(bench._K2_FIELDS) <= set(result)
    assert {"device", "power_limit_w", "peak_gb", "ms_per_iter"} <= \
        set(result)
    assert result["metric"] == bench.METRIC


def _cli(timeout=300, **knobs):
    """python -m proton_tpu_torch.bench --device cpu with ``knobs``: (exit
    code, the JSON lines, every line of stdout and stderr in the order
    written: the k=2 process writes into the same pipe)."""
    out = subprocess.run(
        [sys.executable, "-m", "proton_tpu_torch.bench", "--device", "cpu"],
        cwd=ROOT, env=_clean_env(**knobs), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=timeout)
    lines = out.stdout.splitlines()
    return (out.returncode, [json.loads(ln) for ln in lines
                             if ln.startswith("{")], lines)


def _k2_start(lines):
    return next(i for i, ln in enumerate(lines) if "start N=16 k=2" in ln)


def test_stock_form_prints_k1_then_both():
    """The stock form at 16^2: two JSON lines, the k=1 line written before
    the k=2 process starts, the last one the k=1 line plus the k=2 fields
    under "k2"; exit code 0."""
    rc, rows, lines = _cli(N=16)
    assert rc == 0, lines
    assert len(rows) == 2
    first, last = rows
    assert first["k"] == 1 and "k2" not in first
    assert lines.index(json.dumps(first)) < _k2_start(lines)
    k2 = last.pop("k2")
    assert last == first
    _, jax_k2 = _jax_bench_keys()
    assert set(jax_k2) <= set(k2)
    assert k2["k"] == 2 and k2["cg_exit"] == cg.CONVERGED
    assert np.isfinite(k2["h1_error"]) and k2["h1_error"] < first["h1_error"]


def test_failed_k2_run_exits_nonzero():
    """A k=2 timeout too short for the run: the k=1 line is still
    printed, "k2" carries the error, and the exit code is not 0."""
    rc, rows, lines = _cli(N=16, K2_TIMEOUT=0.5)
    assert rc != 0, lines
    assert len(rows) == 2
    first, last = rows
    assert first["k"] == 1 and "k2" not in first
    assert "error" in last["k2"] and "0.5" in last["k2"]["error"]


@pytest.mark.parametrize("knob,value", [
    ("SEGSTYLE", "chunk"), ("CHUNK", "3"), ("PALLAS", "0"), ("GAMMA", "2")])
def test_unported_knobs_raise(monkeypatch, knob, value):
    """Every JAX knob the port leaves out raises NotImplementedError
    naming ROADMAP's "Not ported" before any work, one case per knob and
    non-default value, and every knob of _NOT_PORTED has a case; GAMMA > 1
    without GALERKIN=1 (a W-cycle on the rediscretized hierarchy) too."""
    monkeypatch.setenv(f"PROTON_BENCH_{knob}", value)
    with pytest.raises(NotImplementedError, match="Not ported"):
        bench.run_bench(8, 1, device="cpu")
    cases = test_unported_knobs_raise.pytestmark[0].args[1]
    assert {f"PROTON_BENCH_{k}" for k, _ in cases} == \
        set(bench._NOT_PORTED) | {"PROTON_BENCH_GAMMA"}


def _spy(monkeypatch, names):
    """Wrap the functions ``names`` of the port's fictdom_structured,
    which the bench calls: {name: [the bound arguments of each call]}."""
    calls = {name: [] for name in names}
    for name in names:
        fn = getattr(fs, name)

        def wrapper(*args, _fn=fn, _name=name, **kwargs):
            sig = inspect.signature(_fn)
            bound = dict(sig.bind(*args, **kwargs).arguments)
            for p in sig.parameters.values():
                if p.kind == p.VAR_KEYWORD:
                    bound.update(bound.pop(p.name, {}))
            calls[_name].append(bound)
            return _fn(*args, **kwargs)

        monkeypatch.setattr(fs, name, wrapper)
    return calls


def _timed_call(calls, name):
    """The arguments of the timed solve_level call (the last one), or of
    the only call of another function."""
    return calls[name][-1]


# knobs -> (function of the port the bench passes it to, the keyword
# there, the value it must arrive with), or None where the check is the
# line's or the stock form's. One case per knob value the JAX bench
# takes that the port's bench did not take before.
KNOB_CASES = [
    ({"PRECISION": "mixed"}, ("classify_cells", "mixed", True)),
    ({"PRECISION": "f64"}, ("mg_preconditioner", "mg_f32", True)),
    ({"SEGMENT": "4"}, ("solve_level", "cg_segment", 4)),
    ({"CGF64": "1"}, ("solve_level", "cg_f64", True)),
    ({"RECOMP": "5"}, ("solve_level", "cg_params.recompute_every", 5)),
    ({"UNIFORM": "0"}, ("solve_level", "level.cond", "CondensedCL")),
    ({"LEAN": "0"}, ("lean_level", "N", 8)),
    ({"PRECOND": "block_jacobi"}, ("solve_level", "precond",
                                   "block_jacobi")),
    ({"PRECOND": "jacobi", "LEAN": "0"}, ("solve_level", "precond",
                                          "jacobi")),
    ({"GALERKIN": "1", "COARSEST": "4", "GAMMA": "2"},
     ("mg_preconditioner", "mg_galerkin", True)),
    ({"COARSEST": "4"}, ("mg_preconditioner", "mg_coarsest", 4)),
    # with a coarse level at 4^2, so that 8^2 is smoothed
    ({"NSMOOTH": "2", "COARSEST": "4"}, ("mg_preconditioner", "n_smooth",
                                         2)),
    ({"RING": "2", "COARSEST": "4"}, ("mg_preconditioner", "patch_ring",
                                      2)),
    ({"CHEB": "2", "COARSEST": "4"}, ("mg_preconditioner", "cheb_degree",
                                      2)),
    ({"PCOLORS": "2", "COARSEST": "4"}, ("mg_preconditioner",
                                         "patch_colors", 2)),
    ({"MAXIT": "100"}, ("solve_level", "cg_params.max_iter", 100)),
    # the multigrid options (slice 10), with a coarse level at 4^2
    ({"MGTRANSFER": "cut", "COARSEST": "4"},
     ("mg_preconditioner", "mg_transfer", "cut")),
    ({"MGTRANSFER": "cut", "UNIFORM": "0", "COARSEST": "4"},
     ("mg_preconditioner", "mg_transfer", "cut")),
    ({"MGTRANSFER": "smoothed", "COARSEST": "4"},
     ("mg_preconditioner", "mg_transfer", "smoothed")),
    ({"DEFLATE": "2", "COARSEST": "4"}, ("mg_preconditioner", "mg_deflate",
                                         2)),
    ({"CHEBOPS": "mixed", "COARSEST": "4"},
     ("mg_preconditioner", "cheb_ops", "mixed")),
    ({"CHEBOPS": "uniform", "COARSEST": "4"},
     ("mg_preconditioner", "cheb_ops", "uniform")),
    ({"H1": "0"}, None),
    ({"NORTHSTAR": "0"}, None)]

# the keyword of solve_fictdom_structured each knob sets, for the line's
# "options"
KNOB_OPTIONS = {"PRECISION": None, "SEGMENT": ("cg_segment", int),
                "CGF64": ("cg_f64", bool), "UNIFORM": None,
                "LEAN": None, "PRECOND": ("precond", str),
                "GALERKIN": ("mg_galerkin", bool),
                "GAMMA": ("mg_gamma", int),
                "COARSEST": ("mg_coarsest", int),
                "NSMOOTH": ("n_smooth", int), "RING": ("patch_ring", int),
                "CHEB": ("cheb_degree", int),
                "PCOLORS": ("patch_colors", int),
                "MGTRANSFER": ("mg_transfer", str),
                "DEFLATE": ("mg_deflate", int),
                "CHEBOPS": ("cheb_ops", str)}


@pytest.mark.parametrize("knobs,reaches", KNOB_CASES,
                         ids=["-".join(f"{k}={v}" for k, v in c[0].items())
                              for c in KNOB_CASES])
def test_knob_reaches_solve(monkeypatch, capsys, knobs, reaches):
    """Each knob the port's bench now takes arrives at the port's library
    function with the keyword of the JAX bench's meaning (a spy on
    fs.classify_cells, lean_level, mg_preconditioner and solve_level), the
    line's "options" name the solve_fictdom_structured keyword, and the
    run at 8^2 on the CPU converges. H1=0 leaves h1_error null;
    NORTHSTAR=0 makes the stock form print the k=1 line alone."""
    for name in [k for k in os.environ if k.startswith("PROTON_BENCH_")]:
        monkeypatch.delenv(name)
    for knob, value in knobs.items():
        monkeypatch.setenv(f"PROTON_BENCH_{knob}", value)
    monkeypatch.setenv("PROTON_BENCH_TOL", "1e-9")
    calls = _spy(monkeypatch, ("classify_cells", "lean_level",
                               "mg_preconditioner", "solve_level"))
    if "NORTHSTAR" in knobs:
        monkeypatch.setenv("PROTON_BENCH_N", "8")
        assert bench.main(["--device", "cpu"]) == 0
        rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("{")]
        assert len(rows) == 1 and "k2" not in rows[0]
        result = rows[0]
    else:
        result = bench.run_bench(8, 1, device="cpu")
    assert result["cg_exit"] == cg.CONVERGED, result
    if reaches is not None:
        fn, path, value = reaches
        head, *rest = path.split(".")
        got = _timed_call(calls, fn)[head]
        for attr in rest:
            got = getattr(got, attr)
        if value == "CondensedCL":
            got = type(got).__name__
        assert got == value, (fn, path, got)
    for knob, value in knobs.items():
        if KNOB_OPTIONS.get(knob) is not None:
            key, kind = KNOB_OPTIONS[knob]
            assert result["options"][key] == (kind(int(value)) if kind is bool
                                              else kind(value))
    opts = result["options"]
    assert opts["fitted"] == ("full" if knobs.get("UNIFORM") == "0" else
                              "uniform" if knobs.get("LEAN") == "0" or
                              knobs.get("PRECISION") == "f64" else "lean")
    if knobs.get("H1") == "0":
        assert result["h1_error"] is None and result["h1_s"] == 0.0
    else:
        assert np.isfinite(result["h1_error"])


def test_precision_lines(monkeypatch):
    """The line of each precision mode at 8^2 k=1 on the CPU: the JAX
    bench's label, every key of the JAX bench's line, cut_splice_s > 0
    with mixed alone, the options of the mode (mixed: the float32 system
    in CG segments of 50; f64: the float32 V-cycle; f32: float32
    throughout), and convergence; the timed assembly assembles the cut
    class at k=1 in every mode (mixed: in float32, before the float64
    splice, as the JAX bench). f32 refuses k=2, an unknown precision
    raises ValueError."""
    keys, _ = _jax_bench_keys()
    for name in [k for k in os.environ if k.startswith("PROTON_BENCH_")]:
        monkeypatch.delenv(name)
    monkeypatch.setenv("PROTON_BENCH_TOL", "1e-9")
    calls = _spy(monkeypatch, ("assemble_level_cl",))
    for precision, label in (("mixed", "mixed(f32+f64-cut)"),
                             ("f64", "f64(f32-mg-precond)"),
                             ("f32", "float32")):
        monkeypatch.setenv("PROTON_BENCH_PRECISION", precision)
        result = bench.run_bench(8, 1, device="cpu")
        assert _timed_call(calls, "assemble_level_cl")["cut_class"]
        assert set(keys) <= set(result)
        assert result["precision"] == label
        assert result["cg_exit"] == cg.CONVERGED
        assert (result["cut_splice_s"] > 0.0) == (precision == "mixed")
        opts = result["options"]
        assert opts["mixed"] == (precision == "mixed")
        assert opts["cg_segment"] == (50 if precision == "mixed" else 0)
        assert opts["mg_f32"] == (precision == "f64")
        assert opts["dtype"] == ("float32" if precision == "f32"
                                 else "float64")
    with pytest.raises(ValueError, match="k <= 1"):
        bench.run_bench(8, 2, device="cpu")
    monkeypatch.setenv("PROTON_BENCH_PRECISION", "f16")
    with pytest.raises(ValueError, match="PRECISION"):
        bench.run_bench(8, 1, device="cpu")


def test_bench_without_device_raises_without_cuda(monkeypatch):
    """No --device and no CUDA: the entry point raises, and prints no
    line."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("PROTON_BENCH_N", "8")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.run_bench(8, 1)


@pytest.mark.parametrize("knobs", [
    {"CHEBOPS": "mixed", "UNIFORM": "0"},
    {"MGTRANSFER": "smoothed", "PRECOND": "block_jacobi"},
    {"DEFLATE": "2", "PRECOND": "block_jacobi"},
    {"MGTRANSFER": "injection"}, {"CHEBOPS": "fast"}],
    ids=lambda kn: "-".join(f"{k}={v}" for k, v in kn.items()))
def test_mg_knob_departures_raise(monkeypatch, knobs):
    """The multigrid knobs raise ValueError before any work where the JAX
    bench ignores them (a Chebyshev pair without the unit-cell stencil of
    the fine level, any of them without the V-cycle) or where their value
    is unknown. MGTRANSFER=cut with UNIFORM=0 runs (the coarse levels are
    lean), as in test_knob_reaches_solve's cases."""
    for name in [k for k in os.environ if k.startswith("PROTON_BENCH_")]:
        monkeypatch.delenv(name)
    for knob, value in knobs.items():
        monkeypatch.setenv(f"PROTON_BENCH_{knob}", value)
    with pytest.raises(ValueError):
        bench.solve_options(1)
