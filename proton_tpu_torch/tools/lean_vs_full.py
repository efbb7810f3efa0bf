"""How far the fully assembled system (fitted="full") is from the lean
one (fitted="lean"), by rounding alone, as the mesh grows.

    python3 -m proton_tpu_torch.tools.lean_vs_full --device cpu \
        --sizes 64 128 256 [--degree 1] [--tol 1e-11]

On the generated mesh every uncut, undisplaced cell has the same local
operator, the unit cell's. The full assembly computes it per cell from
coordinates of size 1 against cells of size 1/N, so each copy carries a
relative rounding error that grows with N, and the condensed system's
condition number (~N^2) carries it into the solution. For each N this
prints one JSON line with

- ``regular_dev``: max |S_full - S_u| / max |S_u| over the regular
  columns of the fully assembled Schur array;
- the multigrid-PCG iteration counts and H1 errors of both forms at CG
  tolerance ``--tol``, and the largest difference of their local dofs.

These are counts and rounding levels, the same on any device. The tool
exists for two tolerances of chip_smoke.py, which were loosened from
"equal" on its evidence and cite it: the fully assembled 1024^2 solution
against the lean one (local dofs 2e-7, H1 1%: phase 7) and the iteration
counts of full + multigrid against lean + multigrid at 512^2 (5%: phase
8). chip_smoke.py compares the two forms at those two sizes only; this
prints the trend over N that shows the gap is rounding.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..core.ops import HHODegreeInfo
from ..cut import fictdom_structured as fs
from ..solvers import cg


def compare(N: int, degree: int, tol: float, device) -> dict:
    hdi, problem = HHODegreeInfo(degree + 1, degree), fs.default_problem()
    full = fs.build_level(N, hdi, problem, fs.nitsche_eta(degree), 4,
                          device=device, fitted="full", with_rhs=False)
    S_u = fs._unit_cell_host(hdi, 1.0 / N, full.cond.S.device)[0]
    irregular = np.union1d(
        np.nonzero(full.cutdata.distorted.cpu().numpy())[0], full.cut_ids)
    regular = torch.as_tensor(np.setdiff1d(np.arange(N * N), irregular),
                              device=full.cond.S.device)
    dev = (full.cond.S[:, regular] - S_u.reshape(-1, 1)).abs().max() / \
        S_u.abs().max()
    del full
    params = cg.CGParams(convergence_threshold=tol, divergence_threshold=1e8,
                         max_iter=50000, apply_preconditioner=True)
    lean, full = (fs.solve_fictdom_structured(N, degree, fitted=fitted,
                                              cg_params=params, device=device)
                  for fitted in ("lean", "full"))
    return dict(N=N, degree=degree, tol=tol, regular_dev=float(dev),
                eps_N=float(torch.finfo(torch.float64).eps * N),
                iterations_lean=lean.iterations,
                iterations_full=full.iterations, h1_lean=lean.h1_error,
                h1_full=full.h1_error,
                max_abs_local_diff=float(
                    (lean.local - full.local).abs().max()))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sizes", type=int, nargs="+",
                        default=[64, 128, 256])
    parser.add_argument("--degree", type=int, default=1)
    parser.add_argument("--tol", type=float, default=1e-11)
    parser.add_argument("--device", default=None,
                        help="cuda unless given; 'cpu' to run on the host")
    args = parser.parse_args()
    for N in args.sizes:
        print(json.dumps(compare(N, args.degree, args.tol, args.device)),
              flush=True)


if __name__ == "__main__":
    main()
