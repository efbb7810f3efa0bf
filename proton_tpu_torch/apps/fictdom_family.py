"""Geometry families: the fictdom problem solved for a family of level
sets on one mesh (JAX counterpart: proton_tpu/apps/fictdom_family.py;
cut/batched.py, the BASELINE.md stretch configuration; the reference can
only loop `cuthho_square` one geometry at a time,
cuthho_square.cpp:2030-2031).

Usage:
  python -m proton_tpu_torch.apps.fictdom_family -N 256 -k 1 -B 64
  python -m proton_tpu_torch.apps.fictdom_family -N 64 -B 8 --geom-chunk 4
      [--device cpu]

Geometries: B shapes with radii linearly spaced in [r0, r1] and centers
on a small deterministic jitter circle around (0.5, 0.5), so that every
geometry cuts the mesh differently (ellipses: b = 0.8 r; flowers: 5
petals of amplitude 0.1 r). Prints one JSON line with the timings and
the per-geometry H1 errors and iterations. Runs on the device given by
--device (default: cuda; without CUDA and without --device the app
raises).

PROTON_TPU_X64 (read when the app runs, with the JAX package's meaning):
"0", "false" or "False" runs the family in float32 (kernel K1's float32
build on every cell of each geometry); anything else, or unset, in
float64. The JAX app sets it to "0" when it is unset, against a TPU
memory limit; the port's default stays float64.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# PROTON_TPU_X64 values that select float32 (proton_tpu/config.py)
X64_OFF = ("0", "false", "False")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-N", type=int, default=64, help="cells per side")
    ap.add_argument("-k", type=int, default=1, help="method degree")
    ap.add_argument("-B", type=int, default=8, help="number of geometries")
    ap.add_argument("--r0", type=float, default=0.25)
    ap.add_argument("--r1", type=float, default=0.42)
    ap.add_argument("--geom-chunk", type=int, default=None,
                    help="tile over geometries (accepted for the JAX "
                         "app's flags; changes no result)")
    ap.add_argument("--capacity", type=int, default=None,
                    help="padded cut-class capacity (default 6N)")
    ap.add_argument("--shape", choices=("circle", "ellipse", "flower"),
                    default="circle",
                    help="level-set family (cut/batched.py + "
                         "cut/levelset.py)")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--device", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    import torch

    from ..config import resolve_device, synchronize
    from ..cut import batched
    from ..solvers import cg

    device = resolve_device(args.device)
    dtype = torch.float32 if os.environ.get("PROTON_TPU_X64") in X64_OFF \
        else torch.float64
    B = args.B
    radii = np.linspace(args.r0, args.r1, B)
    rng = np.linspace(0.0, 2.0 * np.pi, B, endpoint=False)
    centers = 0.5 + 0.02 * np.stack([np.cos(rng), np.sin(rng)], axis=1)

    cgp = cg.CGParams(convergence_threshold=args.tol,
                      divergence_threshold=1e8, max_iter=50000,
                      apply_preconditioner=True)
    kw = dict(capacity=args.capacity, geom_chunk=args.geom_chunk,
              cg_params=cgp, device=device, dtype=dtype)

    t0 = time.perf_counter()
    if args.shape == "circle":
        res = batched.solve_fictdom_family(args.N, args.k, radii, centers,
                                           **kw)
    elif args.shape == "ellipse":
        res = batched.solve_fictdom_family_params(
            args.N, args.k, (radii, 0.8 * radii, centers[:, 0],
                             centers[:, 1]), batched.ellipse_family, **kw)
    else:
        res = batched.solve_fictdom_family_params(
            args.N, args.k, (radii, 0.1 * radii, centers[:, 0],
                             centers[:, 1]), batched.flower_family(5), **kw)
    synchronize(device)
    t_total = time.perf_counter() - t0

    out = {
        "N": args.N, "k": args.k, "B": B,
        "total_s": round(t_total, 3),
        "per_geometry_s": round(t_total / B, 3),
        "h1_errors": [round(float(h), 8) for h in res.h1_error],
        "iterations": [int(i) for i in res.iterations],
        "n_cut": [int(c) for c in res.n_cut],
        "all_converged": bool(np.all(res.exit_reason.numpy() == 0)),
        "overflow": int(res.n_cut_overflow.sum()),
        "shape": args.shape,
        "backend": device.type,
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
