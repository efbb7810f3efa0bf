"""Uncut HHO Poisson h/k-convergence study (JAX counterpart:
proton_tpu/apps/convergence_test.py; reference
apps/convergence_test/convergence_test.cpp).

Config: CLI flags or a JSON config file with the keys of the reference's
Lua config (deg_min, deg_max, min_N, steps, precond, direct, stab_hho;
convergence_test.cpp:355-361). Prints the observed orders
log2(e_prev/e_cur) of the L2, projection-L2 and energy errors
(:313-325) and writes the hho_history / cg_history files (:155-161,
:232-242). Runs on CUDA unless ``--device cpu`` is given.

Usage: python -m proton_tpu_torch.apps.convergence_test [config.json]
       [flags] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass
class ConvergenceTestParams:
    """convergence_test_params defaults (convergence_test.cpp:69-78)."""

    deg_min: int = 0
    deg_max: int = 6
    min_N: int = 4
    steps: int = 5
    precond: bool = True
    direct: bool = False
    stab_hho: bool = True


class ConvergenceRow(NamedTuple):
    """One mesh of the study: the three errors (the JAX package's row),
    then the CG iterations (0 on the direct path) and the seconds of the
    solve and the errors."""

    l2: float
    l2_proj: float
    energy: float
    iterations: int
    seconds: float


def _problem():
    pi = np.pi

    def sol_fun(p):
        return torch.sin(pi * p[..., 0]) * torch.sin(pi * p[..., 1])

    def rhs_fun(p):
        return 2.0 * pi ** 2 * sol_fun(p)

    def sol_grad(p):
        return torch.stack(
            [pi * torch.cos(pi * p[..., 0]) * torch.sin(pi * p[..., 1]),
             pi * torch.sin(pi * p[..., 0]) * torch.cos(pi * p[..., 1])],
            dim=-1)

    return rhs_fun, sol_fun, sol_grad


def _direct_solve(mesh, dofmap, hdi, stab, rhs_fun, sol_fun):
    """The reference's SparseLU branch (convergence_test.cpp:222-229):
    the assembled matrix, densified, solved by Cholesky."""
    from ..core.geometry import cell_geometry
    from ..core.ops import cell_rhs
    from ..methods import assembly, poisson
    from ..solvers.cg import solve_spd_dense

    geom = cell_geometry(mesh)
    oper, lc = poisson.assemble_local(mesh, geom, hdi, stab)
    f = cell_rhs(mesh, geom, hdi.cell_degree, rhs_fun)
    fd = assembly.dirichlet_face_data(mesh, hdi, sol_fun)
    g_loc = assembly.local_dirichlet_data(dofmap, mesh, fd)
    rhs = assembly.assemble_rhs(dofmap, f, lc, g_loc)
    x = solve_spd_dense(assembly.assemble_bcoo(dofmap, lc).to_dense(), rhs)
    local = assembly.take_local_data(dofmap, x, g_loc)
    return poisson.PoissonSolution(x, local, oper, 0, 0, 0.0, None)


def test_method_convergence(ctp: ConvergenceTestParams,
                            write_files: bool = True, device=None):
    """The study on ``device`` (CUDA by default). Returns {k: [rows]}."""
    from ..config import resolve_device
    from ..core.geometry import cell_diameters
    from ..core.mesh import make_quad_mesh
    from ..core.ops import HHODegreeInfo
    from ..methods import assembly, poisson
    from ..solvers import cg
    from ..utils.timing import TimeCounter

    device = resolve_device(device)
    rhs_fun, sol_fun, sol_grad = _problem()
    stab = "hho" if ctp.stab_hho else "naive"
    all_results = {}
    for k in range(ctp.deg_min, ctp.deg_max + 1):
        print(f"Testing degree {k}")
        hdi = HHODegreeInfo(k + 1, k)
        rows, hist_rows = [], []
        N = ctp.min_N
        for i in range(ctp.steps):
            mesh = make_quad_mesh(Nx=N, Ny=N, device=device)
            dofmap = assembly.build_dofmap(mesh, hdi)
            tc = TimeCounter().tic()
            if ctp.direct:
                sol = _direct_solve(mesh, dofmap, hdi, stab, rhs_fun,
                                    sol_fun)
            else:
                cgp = cg.CGParams(convergence_threshold=1e-12,
                                  divergence_threshold=1e8,
                                  max_iter=3 * dofmap.n_dofs,
                                  apply_preconditioner=ctp.precond,
                                  record_history=write_files)
                sol = poisson.solve_poisson(mesh, dofmap, hdi, rhs_fun,
                                            sol_fun, stab, cgp)
                if sol.exit_reason != cg.CONVERGED:
                    print("Warning! Solver didn't converge...")
            errs = poisson.compute_errors(mesh, hdi, sol, sol_fun, sol_grad)
            e = tuple(float(v) for v in errs)
            rows.append(ConvergenceRow(*e, sol.iterations,
                                       tc.toc(errs.energy)))

            if write_files and sol.history is not None:
                h = sol.history.cpu().numpy()
                np.savetxt(f"cg_history_precond_{N}_{k}.txt" if ctp.precond
                           else f"cg_history_{N}_{k}.txt", h[np.isfinite(h)])
            hist_rows.append((float(cell_diameters(mesh)[0]), e[0] ** 2,
                              e[1] ** 2))
            if i > 0:
                orders = [np.log2(p / c) for p, c in zip(rows[i - 1][:3], e)]
                print(f"{orders[0]:.6g}\t\t{orders[1]:.6g}\t\t"
                      f"{orders[2]:.6g}")
            N *= 2

        if write_files:
            name = (f"hho_history_precond_{k}.txt" if ctp.precond
                    else f"hho_history_{k}.txt")
            with open(name, "w") as fh:
                for row in hist_rows:
                    fh.write(" ".join(map(str, row)) + "\n")
        all_results[k] = rows
    return all_results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config", nargs="?", help="JSON config file")
    ap.add_argument("--deg-min", type=int)
    ap.add_argument("--deg-max", type=int)
    ap.add_argument("--min-N", type=int, dest="min_N")
    ap.add_argument("--steps", type=int)
    ap.add_argument("--no-precond", action="store_true")
    ap.add_argument("--direct", action="store_true")
    ap.add_argument("--stab-naive", action="store_true")
    ap.add_argument("--no-files", action="store_true")
    ap.add_argument("--device", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    ctp = ConvergenceTestParams()
    if args.config:
        with open(args.config) as fh:
            for key, val in json.load(fh).items():
                if hasattr(ctp, key):
                    setattr(ctp, key, val)
                else:
                    print(f"ignoring unknown config key '{key}'")
    for key in ("deg_min", "deg_max", "min_N", "steps"):
        if getattr(args, key) is not None:
            setattr(ctp, key, getattr(args, key))
    if args.no_precond:
        ctp.precond = False
    if args.direct:
        ctp.direct = True
    if args.stab_naive:
        ctp.stab_hho = False

    test_method_convergence(ctp, write_files=not args.no_files,
                            device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
