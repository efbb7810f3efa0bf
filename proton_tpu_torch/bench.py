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

Environment knobs (the JAX bench's names and defaults):
  PROTON_BENCH_N        mesh cells per side (1024)
  PROTON_BENCH_K        method degree (1; unset: k=1, then k=2)
  PROTON_BENCH_TOL      CG relative tolerance (1e-6)
  PROTON_BENCH_K2_TIMEOUT seconds of the k=2 subprocess (3600)

The bench runs the JAX bench's default path: the lean system (one
unit-cell operator, deviations on the cut and displaced cells), the
rediscretized multigrid V-cycle with its default smoother, CG to at most
50000 iterations, and the H1 error. Every other JAX knob raises
NotImplementedError when set to anything but the value in _NOT_PORTED
(ROADMAP.md, "Not ported"): those of the TPU's precision machinery and
of the experiments it measured as no gain, and those that select
another solve, which solve_fictdom_structured's keywords reach.

Phases, each ended by a device synchronize (the JAX bench's sync()
fetch barrier works around a deferring remote runtime):

- warmup_s: a 256 x 256 matmul on the device;
- setup_s: band classification, cell geometry and the closed-form
  dofmap. cut_splice_s is 0.0: the JAX bench's default precision splices
  an f64 cut class into an f32 system; the port assembles in f64
  throughout, so the cut class is part of the assembly phase;
- assembly_s, the headline (value = cells / assembly_s): kernel K1 on
  every cell, the Nitsche cut operators over the cut class, the loads,
  and the static condensation. It runs once untimed (K1's first-use
  build lands there), then once timed;
- system_s: the lean system that is solved (the timed assembly's system
  is returned to tests and not solved, as in the JAX bench's default);
- mg_setup_s: the rediscretized coarse levels and the V-cycle;
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
# value, its type, what the knob selects). The first group is the TPU's
# precision machinery and its workarounds (segmented and chunked CG,
# mixed-precision CG, residual replacement, the baked-in Pallas switch)
# and experiments the JAX package measured as no gain; the second
# selects another solve than the default one, which the bench does not
# run (solve_fictdom_structured's keywords select it).
_NOT_PORTED = {
    "PROTON_BENCH_PRECISION": ("f64", str, "a precision other than f64"),
    "PROTON_BENCH_SEGMENT": (0, int, "segmented CG"),
    "PROTON_BENCH_SEGSTYLE": ("loop", str, "the chunked solve"),
    "PROTON_BENCH_CHUNK": (5, int, "the chunked solve"),
    "PROTON_BENCH_CGF64": (0, int, "mixed-precision CG"),
    "PROTON_BENCH_RECOMP": (0, int, "CG residual replacement"),
    "PROTON_BENCH_MGTRANSFER": ("uniform", str, "a transfer other than the "
                                "uniform reconstruction one"),
    "PROTON_BENCH_DEFLATE": (0, int, "interface-band deflation"),
    "PROTON_BENCH_CHEBOPS": ("exact", str, "a Chebyshev operator pair "
                             "other than exact"),
    "PROTON_BENCH_PALLAS": (1, int, "assembly without kernel K1"),
    "PROTON_BENCH_UNIFORM": (1, int, "the full system's solve "
                             "(fitted='full')"),
    "PROTON_BENCH_LEAN": (1, int, "the uniform system (fitted='uniform')"),
    "PROTON_BENCH_PRECOND": ("mg", str, "a preconditioner other than "
                             "multigrid (precond=)"),
    "PROTON_BENCH_GALERKIN": (0, int, "the Galerkin coarse hierarchy "
                              "(mg_galerkin=True)"),
    "PROTON_BENCH_GAMMA": (1, int, "a W-style cycle (mg_gamma=)"),
    "PROTON_BENCH_COARSEST": (8, int, "another coarsest level "
                              "(mg_coarsest=)"),
    "PROTON_BENCH_NSMOOTH": (1, int, "more smoothing sweeps (n_smooth=)"),
    "PROTON_BENCH_RING": (1, int, "another patch ring (patch_ring=)"),
    "PROTON_BENCH_CHEB": (4, int, "another Chebyshev degree "
                          "(cheb_degree=)"),
    "PROTON_BENCH_PCOLORS": (1, int, "a colored patch smoother "
                             "(patch_colors=)"),
    "PROTON_BENCH_MAXIT": (50000, int, "another CG iteration cap"),
    "PROTON_BENCH_H1": (1, int, "a run without the H1 error"),
    "PROTON_BENCH_NORTHSTAR": (1, int, "the stock form without its k=2 "
                               "run (PROTON_BENCH_K=1 runs k=1 alone)"),
}

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
    _check_unported_knobs()
    device = resolve_device(device)
    tol = float(os.environ.get("PROTON_BENCH_TOL", "1e-6"))
    hdi = HHODegreeInfo(k + 1, k)
    cbs = bases.cell_basis_size(hdi.cell_degree)
    eta = fs.nitsche_eta(k)
    problem = fs.default_problem()
    cgp = cg.CGParams(convergence_threshold=tol,
                      divergence_threshold=DIVERGENCE, max_iter=MAX_ITER,
                      apply_preconditioner=True)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    # ---------------- warm-up probe ----------------
    _progress(f"start N={N} k={k} device={device}")
    t0 = time.perf_counter()
    a = torch.ones((256, 256), dtype=DEFAULT_DTYPE, device=device)
    b = a @ a
    synchronize(device)
    del a, b
    t_warmup = time.perf_counter() - t0

    # ---------------- setup: classification, geometry, dofmap -----------
    t0 = time.perf_counter()
    classified = fs.classify_cells(N, problem, INT_REFSTEPS, device=device)
    mesh, _, cut_ids, cell_loc, batch, _ = classified
    geom = cell_geometry(mesh)
    dofmap = assembly.build_dofmap_structured(N, hdi, device=device)
    synchronize(device)
    t_setup = time.perf_counter() - t0
    _progress(f"setup {t_setup:.2f}s; assembly...")

    # ---------------- assembly + condensation (the headline) ------------
    def assemble_fine():
        lc_cl, f_cl = fs.assemble_level_cl(mesh, geom, cell_loc, batch, hdi,
                                           problem, eta, with_rhs=True)
        return cells_last.condense_cl(lc_cl, f_cl, cbs)

    cond = assemble_fine()
    synchronize(device)
    del cond
    t0 = time.perf_counter()
    cond = assemble_fine()
    synchronize(device)
    t_assembly = time.perf_counter() - t0
    C = mesh.num_cells
    _progress(f"assembly {t_assembly:.4f}s; system...")

    # ---------------- the solved (lean) system ----------------
    t0 = time.perf_counter()
    level = fs.lean_level(classified, geom, N, hdi, problem, eta)
    synchronize(device)
    t_system = time.perf_counter() - t0
    _progress(f"system {t_system:.2f}s; mg setup...")

    # ---------------- multigrid hierarchy + V-cycle ----------------
    t0 = time.perf_counter()
    apply_mg = fs.mg_preconditioner(level, N, hdi, problem, eta,
                                    INT_REFSTEPS, device=device)
    t_mg_setup = time.perf_counter() - t0
    _progress(f"mg setup {t_mg_setup:.2f}s; solve...")

    # ---------------- face-grid PCG + recovery ----------------
    def solve(params):
        return fs.solve_level(level, N, hdi, problem, "mg", params,
                              apply_mg=apply_mg, device=device)

    solve(dataclasses.replace(cgp, max_iter=2))  # warm-up, discarded
    t0 = time.perf_counter()
    local, res = solve(cgp)
    t_solve = time.perf_counter() - t0
    _progress(f"solve {t_solve:.2f}s ({res.iterations} iterations, exit "
              f"{res.exit_reason}); h1...")

    t0 = time.perf_counter()
    h1 = fs.fictdom_h1_error_chunked(mesh, geom, batch, cell_loc, hdi, local,
                                     problem.sol_grad)
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
        "cut_splice_s": 0.0,
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
        "precond": "mg",
        "backend": device.type,
        "precision": "f64",
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
    device type, "precision" "f64") plus "ms_per_iter", "peak_gb" (the
    card's peak allocation, None on the CPU), "device" and
    "power_limit_w" (the card's name and nvidia-smi's power limit)."""
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
    if k_env is not None:
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
