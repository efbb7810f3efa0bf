"""Where the mixed-precision system's error comes from, as the mesh grows.

    python3 -m proton_tpu_torch.tools.mixed_noise --device cpu \
        --sizes 32 64 128 [--degree 2] [--tol 1e-9] [--keys ...] \
        [--max-iter M]

solve_fictdom_structured(mixed=True) solves a float32 system: every
stored array of the lean level (the unit-cell Schur block S_u, the
deviations dS, the loads, the back-substitution operators) is rounded to
float32, and the float64 cut class is rounded too. The condensed system's
condition number (~N^2) carries that rounding into the solution. For
each N this prints one JSON line with the H1 error of the solves of the
same problem at CG tolerance ``--tol``, lean + multigrid:

- ``h1_f64``: float64 throughout (the port's default);
- ``h1_mixed``: mixed=True (float32 data, float32 operator and V-cycle,
  float64 CG);
- ``h1_f32_data``: the mixed level's data cast back to float64 and solved
  in float64: the data's rounding alone;
- ``h1_f32_su``: the float64 level with only S_u rounded to float32 (dS
  adjusted so the irregular cells keep their float64 operators);
- ``h1_f32_data_exact_su``: the mixed level's data with the float64 S_u;
- ``h1_cut_dropped``: a control, the mixed level with its cut class's
  operator dropped (dS = 0 on the cut cells, so that they take the
  regular cell's S_u; loads and back-substitution kept): the reading of
  a fault that loses the splice.

``--keys`` runs only the solves named (default: all). The first four are
rounding levels, the same on any device.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..core.geometry import cell_geometry
from ..core.ops import HHODegreeInfo
from ..cut import fictdom_structured as fs
from ..solvers import cg


def _h1(level, N: int, hdi, problem, eta: float, params, device) -> float:
    """H1 error of the lean + multigrid solve of ``level`` in its dtype,
    with float64 CG."""
    apply_mg = fs.mg_preconditioner(level, N, hdi, problem, eta, 4,
                                    device=device)
    local, _ = fs.solve_level(level, N, hdi, problem, "mg", params,
                              apply_mg=apply_mg, device=device, cg_f64=True)
    return fs.fictdom_h1_error_chunked(
        level.mesh, cell_geometry(level.mesh), level.batch, level.cell_loc,
        hdi, local, problem.sol_grad)


def _cut_dropped(level):
    """``level`` (lean) with dS = 0 on its cut cells."""
    pos = torch.as_tensor(np.searchsorted(level.irr_ids, level.cut_ids),
                          device=level.cond.dS.device)
    dS = level.cond.dS.clone()
    dS[:, pos] = 0
    return level._replace(cond=level.cond._replace(dS=dS))


KEYS = ("h1_f64", "h1_f32_data", "h1_f32_su", "h1_f32_data_exact_su",
        "h1_cut_dropped", "h1_mixed")


def compare(N: int, degree: int, tol: float, device, keys=KEYS,
            max_iter: int = 50000) -> dict:
    hdi, problem = HHODegreeInfo(degree + 1, degree), fs.default_problem()
    eta, f64 = fs.nitsche_eta(degree), torch.float64
    params = cg.CGParams(convergence_threshold=tol, divergence_threshold=1e8,
                         max_iter=max_iter, apply_preconditioner=True)
    ref = fs.build_level(N, hdi, problem, eta, 4, device=device,
                         fitted="lean")
    mixed = fs.build_level(N, hdi, problem, eta, 4, device=device,
                           fitted="lean", mixed=True)
    data64 = fs._cast(mixed.cond, f64)
    su32 = ref.S_u.float().to(f64)
    levels = {
        "h1_f64": ref,
        "h1_f32_data": mixed._replace(
            mesh=fs._cast(mixed.mesh, f64), cond=data64,
            S_u=mixed.S_u.to(f64), batch=fs._cast(mixed.batch, f64)),
        "h1_f32_su": ref._replace(S_u=su32, cond=ref.cond._replace(
            dS=ref.cond.dS + (ref.S_u - su32).reshape(-1, 1))),
        "h1_f32_data_exact_su": ref._replace(cond=data64._replace(
            dS=data64.dS + (mixed.S_u.to(f64) - ref.S_u).reshape(-1, 1))),
        "h1_cut_dropped": _cut_dropped(mixed),
    }
    out = dict(N=N, degree=degree, tol=tol)
    for key, level in levels.items():
        if key in keys:
            out[key] = _h1(level, N, hdi, problem, eta, params, device)
    if "h1_mixed" in keys:
        out["h1_mixed"] = fs.solve_fictdom_structured(
            N, degree, mixed=True, cg_params=params, device=device).h1_error
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", help="torch device (default: cuda)")
    ap.add_argument("--sizes", type=int, nargs="+", default=[32, 64, 128])
    ap.add_argument("--degree", type=int, default=2)
    ap.add_argument("--tol", type=float, default=1e-9)
    ap.add_argument("--keys", nargs="+", choices=KEYS, default=list(KEYS))
    ap.add_argument("--max-iter", type=int, default=50000)
    args = ap.parse_args(argv)
    from ..config import resolve_device

    device = resolve_device(args.device)
    for N in args.sizes:
        print(json.dumps(compare(N, args.degree, args.tol, device,
                                 args.keys, args.max_iter)), flush=True)


if __name__ == "__main__":
    main()
