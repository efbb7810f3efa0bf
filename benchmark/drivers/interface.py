"""Driver ``interface``: one cutHHO elliptic interface problem through
``proton_tpu_torch.cut.interface_problem.run_interface``, the path of
``cuthho_square -i`` (the generated mesh and the generic classification,
the kappa-weighted fitted operator on every cell and the doubled
operator on the cut cells, the doubled-dof map, the condensed face
system, the uniform V-cycle plus cut-band Schwarz under CG, recovery,
H1 error over both sides), and its judgement by the plain reference of
the doubled-unknown system.

The program is handed the problem (radius and centre) and the
configuration's method parameters. What it returns is judged after the
window: its per-cell unknowns of each side, moved to the host when the
problem ends, its CG exit and its H1 error.
"""

from __future__ import annotations

import gc
from typing import NamedTuple

import torch

# the plain reference: a module of the checkout's benchmark package (its
# root is on the path of every run), since it imports its sibling
# reference/cuthho.py
from benchmark.reference import interface as reference
from proton_tpu_torch.cut import interface_problem as ip
from proton_tpu_torch.cut.methods import InterfaceParams
from proton_tpu_torch.solvers import cg

DTYPES = {"float64": torch.float64, "float32": torch.float32}
# the control's options to ``run`` (readings.py): the whole solve in
# float32 (run_interface's dtype), at the cell's tolerance and cap
CONTROL = {"dtype": "float32"}


class Outcome(NamedTuple):
    local_neg: torch.Tensor  # [N*N, d] on the host
    local_pos: torch.Tensor  # [N*N, d] on the host
    iterations: int
    exit_reason: int
    rel_residual: float
    h1_error: float
    timings: dict


def _solve(config: dict, params: dict, device, max_iter: int,
           dtype: str = ""):
    timings = {}
    res = ip.run_interface(
        config["N"], config["degree"], params["radius"],
        tuple(params["center"]), config["int_refsteps"],
        InterfaceParams(config["kappa_1"], config["kappa_2"],
                        config["nitsche_eta"]),
        device=device, dtype=DTYPES[dtype or config["dtype"]],
        timings=timings,
        cg_params=cg.CGParams(convergence_threshold=config["cg_tol"],
                              divergence_threshold=1e8, max_iter=max_iter,
                              apply_preconditioner=True),
        condensed=config["condensed"], precond_kind=config["precond_kind"])
    return res, timings


def warm(config: dict, device) -> dict:
    """The cell's shapes, by one problem of the reference's geometry
    with CG capped at 2 iterations. Returns its spans. Refuses at once a
    program whose result carries no CG residual, before any work."""
    if "rel_residual" not in ip.InterfaceResult._fields:
        raise RuntimeError("run_interface returns no rel_residual: this "
                           "program cannot run the interface cell")
    _, timings = _solve(config, {"radius": 0.35, "center": [0.5, 0.5]},
                        device, 2)
    return timings


def run(config: dict, params: dict, device, max_iter: int = 0,
        **options) -> Outcome:
    """One problem, CG capped at ``max_iter`` iterations if given (the
    traced slice's problem); ``options`` go to the solve (the control's
    ``dtype``; the benchmark's runs pass none)."""
    res, timings = _solve(config, params, device,
                          max_iter or config["cg_max_iter"], **options)
    return Outcome(res.local_neg.to("cpu"), res.local_pos.to("cpu"),
                   int(res.iterations), int(res.exit_reason),
                   float(res.rel_residual), float(res.h1_error), timings)


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
      doubled system over the condensed right-hand side;
    - ``cell_res``: the residual of its cell rows over |f_T|;
    - ``h1``: the reference's H1 error of its cell unknowns, both sides;
    - ``h1_gap``: |the program's H1 - the reference's| / the reference's.
    """
    j = reference.judge(config["N"], config["degree"], params["radius"],
                        params["center"], config["int_refsteps"],
                        config["kappa_1"], config["kappa_2"],
                        config["nitsche_eta"], outcome.local_neg,
                        outcome.local_pos, device)
    return {"cg_exit": float(outcome.exit_reason),
            "face_res": j.face_res, "cell_res": j.cell_res, "h1": j.h1,
            "h1_gap": abs(outcome.h1_error - j.h1) / j.h1}
