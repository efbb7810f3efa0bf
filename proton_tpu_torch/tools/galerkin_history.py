"""The CG residual history of the Galerkin multigrid solve against the
rediscretized one, capped, as the mesh grows.

    python3 -m proton_tpu_torch.tools.galerkin_history --device cpu \
        --sizes 64 128 [--degree 1] [--cap 1600] [--gamma 1] [--tol 1e-11]

For each N and hierarchy (``rediscretized``, ``galerkin``) this prints one
JSON line with the iterations, the exit code (2: the cap was reached), the
final relative residual, the relative residual after 10, 50, 100, 200,
... iterations, the H1 error, the device, and the seconds of the Galerkin
setup and of CG. chip_smoke.py's phase 23 runs the 1024^2 k=1 Galerkin
solve capped because of what this shows there: the residual stalls.
"""

from __future__ import annotations

import argparse
import json
import subprocess

from ..config import resolve_device
from ..cut import fictdom_structured as fs
from ..solvers import cg

CHECKPOINTS = (10, 50, 100, 200, 300, 400, 500, 700, 1000, 1300, 1600,
               2000, 3000, 5000)


def history(N: int, degree: int, galerkin: bool, gamma: int, cap: int,
            tol: float, device) -> dict:
    """One capped solve, with CG's residual history read at CHECKPOINTS."""
    params = cg.CGParams(convergence_threshold=tol, divergence_threshold=1e8,
                         max_iter=cap, apply_preconditioner=True,
                         record_history=True)
    r = fs.solve_fictdom_structured(N, degree, cg_params=params,
                                    mg_galerkin=galerkin,
                                    mg_gamma=gamma if galerkin else 1,
                                    device=device)
    h = r.history.cpu()
    return dict(
        N=N, degree=degree, hierarchy="galerkin" if galerkin else
        "rediscretized", gamma=gamma if galerkin else 1, cap=cap, tol=tol,
        iterations=r.iterations, exit=r.exit_reason, rel=r.rel_residual,
        h1=r.h1_error, device=str(device),
        galerkin_setup_s=r.timings.get("galerkin_setup_s"),
        cg_s=r.timings["cg_s"],
        history={i: float(h[i]) for i in CHECKPOINTS
                 if i <= r.iterations})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[64, 128])
    ap.add_argument("--degree", type=int, default=1)
    ap.add_argument("--cap", type=int, default=1600)
    ap.add_argument("--gamma", type=int, default=1)
    ap.add_argument("--tol", type=float, default=1e-11)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    for N in args.sizes:
        for galerkin in (False, True):
            print(json.dumps(history(N, args.degree, galerkin, args.gamma,
                                     args.cap, args.tol, device)),
                  flush=True)


if __name__ == "__main__":
    main()
