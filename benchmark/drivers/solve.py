"""Driver ``solve``: one cutHHO fictitious-domain problem through
``proton_tpu_torch.cut.fictdom_structured.solve_fictdom_structured``, the
path of ``cuthho_square -f`` (classification, K1 and the Nitsche cut
operators, the lean condensed system, the multigrid V-cycle under CG,
recovery, H1 error), and its judgement by the plain reference.

The program is handed the problem (radius and centre, through its
``default_problem``) and the configuration's method parameters. What it
returns is judged after the window: its per-cell unknowns, moved to the
host when the problem ends, its CG exit and its H1 error.
"""

from __future__ import annotations

import gc
import importlib.util
from pathlib import Path
from typing import NamedTuple

import torch

from proton_tpu_torch.cut import fictdom_structured as fs
from proton_tpu_torch.solvers import cg

_REF = Path(__file__).resolve().parent.parent / "reference" / "cuthho.py"
_spec = importlib.util.spec_from_file_location("_bench_reference_cuthho",
                                               _REF)
reference = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(reference)

DTYPES = {"float64": torch.float64}
# the control's options to ``run`` (readings.py): the program's float32
# system around a float64 CG
CONTROL = {"mixed": True}


class Outcome(NamedTuple):
    local: torch.Tensor      # [N*N, d] on the host
    iterations: int
    exit_reason: int
    rel_residual: float
    h1_error: float
    timings: dict


def _solve(config: dict, params: dict, device, max_iter: int, **options):
    problem = fs.default_problem(params["radius"], tuple(params["center"]))
    return fs.solve_fictdom_structured(
        config["N"], config["degree"], problem,
        int_refsteps=config["int_refsteps"], precond=config["precond"],
        cg_params=cg.CGParams(convergence_threshold=config["cg_tol"],
                              divergence_threshold=1e8, max_iter=max_iter,
                              apply_preconditioner=True),
        compute_h1=True, fitted=config["fitted"], device=device,
        dtype=DTYPES[config["dtype"]], **options)


def warm(config: dict, device) -> dict:
    """The cell's shapes and kernels, by one problem of the reference's
    geometry with CG capped at 2 iterations. Returns its spans."""
    res = _solve(config, {"radius": 0.35, "center": [0.5, 0.5]}, device, 2)
    return dict(res.timings)


def run(config: dict, params: dict, device, max_iter: int = 0,
        **options) -> Outcome:
    """One problem, CG capped at ``max_iter`` iterations if given (the
    traced slice's problem); ``options`` go to the solve (the control's
    precision switch; the benchmark's runs pass none)."""
    res = _solve(config, params, device, max_iter or config["cg_max_iter"],
                 **options)
    return Outcome(res.local.to("cpu"), int(res.iterations),
                   int(res.exit_reason), float(res.rel_residual),
                   float(res.h1_error), dict(res.timings))


def describe(outcome: Outcome) -> str:
    return (f"iterations {outcome.iterations} exit {outcome.exit_reason} "
            f"rel_residual {outcome.rel_residual:.3e} "
            f"h1 {outcome.h1_error:.6e}")


def release(device) -> None:
    """Hand the allocator's free blocks back before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def judge(config: dict, params: dict, outcome: Outcome, device) -> dict:
    """The numbers compared for one problem:

    - ``cg_exit``: the program's CG exit code (0: converged below tol);
    - ``face_res``: the face residual of its unknowns in the reference's
      system over the condensed right-hand side;
    - ``cell_res``: the residual of its cell rows over |f_T|;
    - ``h1``: the reference's H1 error of its cell unknowns;
    - ``h1_gap``: |the program's H1 - the reference's| / the reference's.
    """
    j = reference.judge(config["N"], config["degree"], params["radius"],
                        params["center"], config["int_refsteps"],
                        config["nitsche_eta"], outcome.local, device)
    return {"cg_exit": float(outcome.exit_reason),
            "face_res": j.face_res, "cell_res": j.cell_res, "h1": j.h1,
            "h1_gap": abs(outcome.h1_error - j.h1) / j.h1}
