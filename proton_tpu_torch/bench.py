"""Benchmark: cutHHO fictitious-domain Poisson on the N x N cut mesh
(JAX counterpart: bench.py at the root of the repository; the
BASELINE.json metric: elements/s of the local assembly at k=1 and the
end-to-end solve time on the 1024^2 mesh).

    python -m proton_tpu_torch.bench [--device cpu]

Runs on CUDA unless ``--device`` is given; without CUDA and without
``--device`` it raises. With no PROTON_BENCH_K it runs k=1, prints and
flushes its JSON line, then runs k=2 in a subprocess and prints a last
line: the k=1 line with the k=2 fields under "k2". A failed or timed-out
k=2 run leaves {"error": ...} there and the process exits 1. With PROTON_BENCH_K it prints the one line of that
degree.

Environment knobs (the JAX bench's names, defaults and meanings):
  PROTON_BENCH_N        mesh cells per side (1024)
  PROTON_BENCH_K        method degree (1; unset: k=1, then k=2)
  PROTON_BENCH_TOL      CG relative tolerance (1e-6)
  PROTON_BENCH_K2_TIMEOUT seconds of the k=2 subprocess (3600)
  PROTON_BENCH_PRECISION
      unset: the port's default, float64 throughout (system, V-cycle and
          CG); the line says "f64". The JAX bench has no such mode (its
          default is mixed): this is the port's float64 north star;
      mixed: a float32 system with the O(N) cut class assembled and
          condensed in float64 and spliced in (its time is cut_splice_s,
          part of setup_s), coarse levels mixed at k >= 2, float32 CG in
          segments of PROTON_BENCH_SEGMENT (default 50) iterations;
      f64: the float64 system and CG with the float32 V-cycle;
      f32: float32 throughout, k <= 1 only (the float32 cut blocks round
          indefinite at k >= 2, so k=2 raises ValueError: set
          PROTON_BENCH_K=1 or PROTON_BENCH_NORTHSTAR=0).
  PROTON_BENCH_SEGMENT  CG segments of this many iterations (solve keyword
                        cg_segment; 0 = one CG run)
  PROTON_BENCH_CGF64    1: float64 CG around the float32 system (cg_f64)
  PROTON_BENCH_RECOMP   CG residual replacement every m iterations
                        (CGParams.recompute_every)
  PROTON_BENCH_UNIFORM  0: solve the timed assembly's full system
                        (fitted="full")
  PROTON_BENCH_LEAN     0: fitted="uniform" (the port builds the same
                        lean system); the f64 precision sets it, as JAX's
  PROTON_BENCH_PRECOND  mg | block_jacobi | jacobi (jacobi needs LEAN=0
                        or UNIFORM=0, as in the JAX bench)
  PROTON_BENCH_GALERKIN 1: the Galerkin coarse hierarchy (mg_galerkin);
                        the coarsest level then defaults to 32
  PROTON_BENCH_GAMMA    coarse visits per gap, with GALERKIN=1 (mg_gamma)
  PROTON_BENCH_COARSEST, NSMOOTH, RING, CHEB, PCOLORS: mg_coarsest (8),
                        n_smooth (1), patch_ring (1), cheb_degree (4),
                        patch_colors (1)
  PROTON_BENCH_MGTRANSFER uniform | smoothed | cut (mg_transfer: the
                        operator-smoothed or the cut-aware transfers; the
                        coarse levels are lean whatever UNIFORM, so cut
                        runs with UNIFORM=0 too, as in the JAX bench)
  PROTON_BENCH_DEFLATE  K > 0: the interface-band deflation of 2K+1 modes
                        (mg_deflate)
  PROTON_BENCH_CHEBOPS  exact | mixed | uniform (cheb_ops: the Chebyshev
                        smoother's operator pair; not with UNIFORM=0)
  PROTON_BENCH_MAXIT    CG iteration cap (50000)
  PROTON_BENCH_H1       0: no H1 error (h1_error null)
  PROTON_BENCH_NORTHSTAR 0: the stock form prints the k=1 line alone

The line's "options" are the solve_fictdom_structured keywords of the
library solve the run reproduces. The knobs of _NOT_PORTED raise
NotImplementedError when set to anything but the value there (ROADMAP.md,
"Not ported"), as does GAMMA > 1 without GALERKIN=1: the chunked solve
(a TPU fault workaround), W-cycles on the rediscretized hierarchy, and
assembly without kernel K1. MGTRANSFER, DEFLATE and CHEBOPS raise
ValueError where the JAX bench ignores them (PRECOND other than mg,
CHEBOPS with UNIFORM=0).

Phases, each ended by a device synchronize (the JAX bench's sync()
fetch barrier works around a deferring remote runtime):

- warmup_s: a 256 x 256 matmul on the device;
- setup_s: band classification, cell geometry, the closed-form dofmap
  and, with PRECISION=mixed, the float64 cut class (cut_splice_s, 0.0
  otherwise);
- assembly_s, the headline (value = cells / assembly_s): kernel K1 on
  every cell, the Nitsche cut operators over the cut class, the loads,
  and the static condensation, in the system's dtype. With
  PRECISION=mixed: as the JAX bench, K1 in float32 on every cell, the
  Nitsche cut operators in float32, the condensation, and the splice of
  the float64 cut class over them; at k >= 2 the float32 cut operators
  are left out (MIXED_CUT_CLASS_K), so that mode's value times less
  work than the JAX bench's and the float64 one's. It runs once untimed
  (K1's first-use build lands there), then once timed;
- system_s: the lean system that is solved (the timed assembly's system
  is returned to tests and not solved, as in the JAX bench's default;
  with UNIFORM=0 it is the one solved, and system_s is 0);
- mg_setup_s: the rediscretized coarse levels and the V-cycle (with
  MGTRANSFER=cut their reconstruction-map deviations, with DEFLATE the
  deflation space);
- solve_s: the face system (Dirichlet fold, rhs, operator), PCG and the
  cell recovery, after an untimed run of the same of two CG iterations
  (the first launch of each of their kernels lands there);
- h1_s: the H1 error against the manufactured solution.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

from .config import DEFAULT_DTYPE, resolve_device, synchronize
from .core import bases
from .core.geometry import cell_geometry
from .core.ops import HHODegreeInfo
from .cut import fictdom_structured as fs
from .methods import assembly, cells_last
from .solvers import cg

METRIC = ("elements/sec local assembly (k=1 cutHHO); end-to-end solve "
          "time, 1024^2 mesh")

# The fields of the k=2 run copied under "k2" of the stock line: the JAX
# bench's, then the port's own.
_K2_FIELDS = ("k", "dofs", "condensed_dofs", "cut_cells", "setup_s",
              "cut_splice_s", "assembly_s", "value", "system_s",
              "mg_setup_s", "solve_s", "h1_s", "end_to_end_s",
              "cg_iters", "cg_rel_residual", "cg_exit", "h1_error",
              "ms_per_iter", "peak_gb")

# Knobs of the JAX bench that the port leaves out: name -> (the accepted
# value, its type, what the knob selects): the chunked solve (the libtpu
# while_loop fault) and assembly without K1 (it always runs on the card;
# its plain version is for CPU tensors). GAMMA > 1 without GALERKIN
# (W-cycles on the rediscretized hierarchy, refuted) is refused in
# solve_options.
_NOT_PORTED = {
    "PROTON_BENCH_SEGSTYLE": ("loop", str, "the chunked solve"),
    "PROTON_BENCH_CHUNK": (5, int, "the chunked solve"),
    "PROTON_BENCH_PALLAS": (1, int, "assembly without kernel K1"),
}

# PROTON_BENCH_PRECISION -> the JAX bench's label of the mode in the line
# (bench.py:430-433); unset, the line says "f64".
PRECISIONS = {"mixed": "mixed(f32+f64-cut)", "f64": "f64(f32-mg-precond)",
              "f32": "float32"}

# The highest degree at which the mixed bench's timed assembly also
# assembles and condenses the cut class in float32 before the float64
# splice overwrites it, as the JAX bench does at every degree. At k=2
# torch's float32 Cholesky raises on sliver cut blocks (CPU, the 1024^2
# mixed classification: 2 of 2,868 cut cells; at 256^2 4 of 716; none at
# k=1).
MIXED_CUT_CLASS_K = 1

# The JAX bench's classification depth, CG divergence threshold and CG
# iteration cap.
INT_REFSTEPS = 4
DIVERGENCE = 1e8
MAX_ITER = 50000


def _check_unported_knobs() -> None:
    """NotImplementedError for a knob of _NOT_PORTED set to anything but
    its accepted value."""
    for name, (accepted, kind, what) in _NOT_PORTED.items():
        raw = os.environ.get(name)
        if raw is None:
            continue
        try:
            same = kind(raw) == accepted
        except ValueError:
            same = False
        if not same:
            raise NotImplementedError(
                f"{name}={raw!r}: {what} is not ported to the bench "
                "(ROADMAP.md, 'Not ported')")


def _knob(name: str, default):
    """PROTON_BENCH_<name> as the type of ``default``."""
    raw = os.environ.get(f"PROTON_BENCH_{name}")
    return default if raw is None else type(default)(raw)


def solve_options(k: int) -> dict:
    """The knobs as the keywords of solve_fictdom_structured that the
    bench's run stands for (``dtype`` included), after refusing the knobs
    that are not ported and the combinations the JAX bench cannot run."""
    _check_unported_knobs()
    precision = os.environ.get("PROTON_BENCH_PRECISION")
    if precision is not None and precision not in PRECISIONS:
        raise ValueError(f"PROTON_BENCH_PRECISION={precision!r}: expected "
                         f"one of {sorted(PRECISIONS)} or unset")
    if precision == "f32" and k > 1:
        raise ValueError("PROTON_BENCH_PRECISION=f32 runs k <= 1 only: the "
                         "float32 cut blocks round indefinite at k >= 2")
    galerkin = _knob("GALERKIN", 0) == 1
    gamma = _knob("GAMMA", 1)
    if gamma > 1 and not galerkin:
        raise NotImplementedError(
            f"PROTON_BENCH_GAMMA={gamma}: a W-style cycle on the "
            "rediscretized hierarchy is not ported (ROADMAP.md, 'Not "
            "ported'); set PROTON_BENCH_GALERKIN=1")
    lean = _knob("LEAN", 1) == 1 and precision != "f64"
    fitted = "full" if _knob("UNIFORM", 1) != 1 else \
        "lean" if lean else "uniform"
    precond = _knob("PRECOND", "mg")
    fs._check_precond(precond)
    if precond == "jacobi" and fitted == "lean":
        raise ValueError("PROTON_BENCH_PRECOND=jacobi needs "
                         "PROTON_BENCH_LEAN=0 or PROTON_BENCH_UNIFORM=0: "
                         "the lean system supports mg and block_jacobi "
                         "only, as in the JAX bench")
    mixed = precision == "mixed"
    mg_options = dict(mg_transfer=_knob("MGTRANSFER", "uniform"),
                      mg_deflate=_knob("DEFLATE", 0),
                      cheb_ops=_knob("CHEBOPS", "exact"))
    # the bench's coarse levels are lean whatever the fine level's form
    fs._check_mg_options(**mg_options, precond=precond, smoother="chebyshev",
                         fitted=fitted, coarse_fitted="lean")
    return dict(
        fitted=fitted, precond=precond, mixed=mixed,
        mg_f32=precision == "f64", cg_f64=_knob("CGF64", 0) == 1,
        cg_segment=_knob("SEGMENT", 50 if mixed else 0),
        mg_coarsest=_knob("COARSEST", 32 if galerkin else 8),
        n_smooth=_knob("NSMOOTH", 1), patch_ring=_knob("RING", 1),
        cheb_degree=_knob("CHEB", 4), patch_colors=_knob("PCOLORS", 1),
        mg_galerkin=galerkin, mg_gamma=gamma, **mg_options,
        dtype=torch.float32 if precision == "f32" else torch.float64)


def _progress(msg: str) -> None:
    """Phase heartbeat on stderr (the JSON lines go to stdout)."""
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def _card(device: torch.device):
    """(name, power limit in W) of the card, (None, None) on the CPU. The
    limit is nvidia-smi's; None where nvidia-smi is absent."""
    if device.type != "cuda":
        return None, None
    name = torch.cuda.get_device_name(device)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, check=True,
                             timeout=60).stdout.split()
    except (OSError, subprocess.SubprocessError):
        return name, None
    index = device.index or 0
    return name, float(out[index]) if index < len(out) else None


def _run_bench(N: int, k: int, device=None):
    """(the result dict, the local dofs [C, d], the timed assembly's
    condensed system) of one bench run; see run_bench."""
    opts = solve_options(k)
    device = resolve_device(device)
    precision = os.environ.get("PROTON_BENCH_PRECISION")
    mixed, dtype, precond = opts["mixed"], opts["dtype"], opts["precond"]
    tol = _knob("TOL", 1e-6)
    hdi = HHODegreeInfo(k + 1, k)
    cbs = bases.cell_basis_size(hdi.cell_degree)
    eta = fs.nitsche_eta(k)
    problem = fs.default_problem()
    cgp = cg.CGParams(convergence_threshold=tol,
                      divergence_threshold=DIVERGENCE,
                      max_iter=_knob("MAXIT", MAX_ITER),
                      apply_preconditioner=True,
                      recompute_every=_knob("RECOMP", 0))
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    # ---------------- warm-up probe ----------------
    _progress(f"start N={N} k={k} device={device} precision={precision}")
    t0 = time.perf_counter()
    a = torch.ones((256, 256), dtype=DEFAULT_DTYPE, device=device)
    b = a @ a
    synchronize(device)
    del a, b
    t_warmup = time.perf_counter() - t0

    # ---------------- setup: classification, geometry, dofmap -----------
    t0 = time.perf_counter()
    classified = fs.classify_cells(N, problem, INT_REFSTEPS, device=device,
                                   dtype=dtype, mixed=mixed)
    mesh, cutdata, cut_ids, cell_loc, batch, _ = classified
    geom = cell_geometry(mesh)
    dofmap = assembly.build_dofmap_structured(N, hdi, device=device)
    cut_sub, t_splice = None, 0.0
    if mixed:
        synchronize(device)
        t1 = time.perf_counter()
        cut_sub = fs.cut64_condensed(batch, hdi, problem, eta, with_rhs=True)
        synchronize(device)
        t_splice = time.perf_counter() - t1
    synchronize(device)
    t_setup = time.perf_counter() - t0
    _progress(f"setup {t_setup:.2f}s; assembly...")

    # ---------------- assembly + condensation (the headline) ------------
    def assemble_fine():
        lc_cl, f_cl = fs.assemble_level_cl(
            mesh, geom, cell_loc, batch, hdi, problem, eta, with_rhs=True,
            cut_class=not mixed or k <= MIXED_CUT_CLASS_K)
        cond = cells_last.condense_cl(lc_cl, f_cl, cbs)
        if mixed:
            cells_last.set_cells(cond, batch.ids, cut_sub)
        return cond

    cond = assemble_fine()
    synchronize(device)
    del cond
    t0 = time.perf_counter()
    cond = assemble_fine()
    synchronize(device)
    t_assembly = time.perf_counter() - t0
    C = mesh.num_cells
    _progress(f"assembly {t_assembly:.4f}s; system...")

    # ---------------- the solved system ----------------
    t0 = time.perf_counter()
    if opts["fitted"] == "full":
        level = fs.LevelData(mesh, cutdata, cut_ids, cond, batch, cell_loc)
    else:
        level = fs.lean_level(classified, geom, N, hdi, problem, eta,
                              mixed=mixed, cut_cond=cut_sub)
    synchronize(device)
    t_system = time.perf_counter() - t0
    _progress(f"system {t_system:.2f}s; mg setup...")

    # ---------------- multigrid hierarchy + V-cycle ----------------
    # lean coarse levels whatever the fine level's form, mixed at k >= 2
    # only, as in the JAX bench (bench.py:262-270)
    t0 = time.perf_counter()
    apply_mg = None
    if precond == "mg":
        apply_mg = fs.mg_preconditioner(
            level, N, hdi, problem, eta, INT_REFSTEPS, device=device,
            dtype=dtype, fitted="lean", mixed=mixed and k >= 2,
            mg_f32=opts["mg_f32"], mg_coarsest=opts["mg_coarsest"],
            mg_galerkin=opts["mg_galerkin"], mg_gamma=opts["mg_gamma"],
            n_smooth=opts["n_smooth"], patch_ring=opts["patch_ring"],
            cheb_degree=opts["cheb_degree"],
            patch_colors=opts["patch_colors"],
            mg_transfer=opts["mg_transfer"], mg_deflate=opts["mg_deflate"],
            cheb_ops=opts["cheb_ops"])
    t_mg_setup = time.perf_counter() - t0
    _progress(f"mg setup {t_mg_setup:.2f}s; solve...")

    # ---------------- face-grid PCG + recovery ----------------
    def solve(params, cg_segment):
        return fs.solve_level(level, N, hdi, problem, precond, params,
                              apply_mg=apply_mg, device=device,
                              cg_f64=opts["cg_f64"], cg_segment=cg_segment)

    solve(dataclasses.replace(cgp, max_iter=2), 0)  # warm-up, discarded
    t0 = time.perf_counter()
    local, res = solve(cgp, opts["cg_segment"])
    t_solve = time.perf_counter() - t0
    _progress(f"solve {t_solve:.2f}s ({res.iterations} iterations, exit "
              f"{res.exit_reason}); h1...")

    h1, t_h1 = None, 0.0
    if _knob("H1", 1) == 1:
        t0 = time.perf_counter()
        h1 = fs.fictdom_h1_error_chunked(mesh, geom, batch, cell_loc, hdi,
                                         local, problem.sol_grad)
        t_h1 = time.perf_counter() - t0

    end_to_end = (t_setup + t_assembly + t_system + t_mg_setup + t_solve +
                  t_h1)
    name, power = _card(device)
    result = {
        "metric": METRIC,
        "value": C / t_assembly,
        "unit": "elements/s",
        "vs_baseline": 1.0,
        "n": N,
        "k": k,
        "cells": int(C),
        "cut_cells": int(len(cut_ids)),
        "dofs": int(dofmap.n_dofs),
        "condensed_dofs": int(dofmap.n_dofs - dofmap.n_cells * dofmap.cbs),
        "warmup_s": t_warmup,
        "setup_s": t_setup,
        "cut_splice_s": t_splice,
        "assembly_s": t_assembly,
        "system_s": t_system,
        "mg_setup_s": t_mg_setup,
        "solve_s": t_solve,
        "h1_s": t_h1,
        "end_to_end_s": end_to_end,
        "cg_iters": int(res.iterations),
        "cg_rel_residual": float(res.rel_residual),
        "cg_exit": int(res.exit_reason),
        "h1_error": h1,
        "precond": precond,
        "backend": device.type,
        "precision": PRECISIONS.get(precision, "f64"),
        "options": {key: str(v).split(".")[-1] if key == "dtype" else v
                    for key, v in opts.items()},
        "ms_per_iter": 1e3 * t_solve / max(res.iterations, 1),
        "peak_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                    if on_card else None),
        "device": name,
        "power_limit_w": power,
    }
    return result, local, cond


def run_bench(N: int, k: int, device=None) -> dict:
    """One bench run at N x N cells and degree k on ``device`` (CUDA
    unless given), with the knobs of the module docstring: the result
    dict, the JAX bench's keys (the same meanings; "backend" is the torch
    device type, "precision" the JAX bench's label of the mode, "f64"
    with the knob unset) plus "options" (solve_options, the dtype by
    name), "ms_per_iter", "peak_gb" (the card's peak allocation, None on
    the CPU), "device" and "power_limit_w" (the card's name and
    nvidia-smi's power limit)."""
    return _run_bench(N, k, device)[0]


def _k2_run(device_arg, timeout: float) -> dict:
    """The k=2 run in a subprocess (this module with PROTON_BENCH_K=2 and
    the same --device): its _K2_FIELDS, or {"error": ...} if it fails, times
    out or prints no JSON line. Its stderr passes through."""
    env = dict(os.environ, PROTON_BENCH_K="2")
    root = str(Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-m", "proton_tpu_torch.bench"]
    if device_arg is not None:
        cmd += ["--device", device_arg]
    try:
        out = subprocess.run(cmd, env=env, stdout=subprocess.PIPE, text=True,
                             timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"error": f"the k=2 run exceeded {timeout} s"}
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    if out.returncode != 0 or not lines:
        return {"error": f"the k=2 run exited {out.returncode}: "
                         f"{out.stdout[-400:]}"}
    r2 = json.loads(lines[-1])
    return {f: r2[f] for f in _K2_FIELDS if f in r2}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="cutHHO fictdom benchmark (knobs: PROTON_BENCH_*)")
    ap.add_argument("--device", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    N = int(os.environ.get("PROTON_BENCH_N", "1024"))
    k_env = os.environ.get("PROTON_BENCH_K")
    result = run_bench(N, int(k_env or "1"), args.device)
    print(json.dumps(result), flush=True)
    if k_env is not None or _knob("NORTHSTAR", 1) != 1:
        return 0
    # the k=1 line is out; free the card for the k=2 process
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    result["k2"] = _k2_run(
        args.device, float(os.environ.get("PROTON_BENCH_K2_TIMEOUT", "3600")))
    print(json.dumps(result), flush=True)
    return 1 if "error" in result["k2"] else 0


if __name__ == "__main__":
    sys.exit(main())
