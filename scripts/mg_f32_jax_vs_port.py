"""The float32 V-cycle (mg_f32=True: float64 system and CG, the V-cycle
built and applied in float32) of the JAX package against the PyTorch
port's, on the CPU: does the port's float32 V-cycle cost the same CG
iterations over the float64 one as JAX's, as the mesh grows?

Usage: python scripts/mg_f32_jax_vs_port.py [N ...] [--degree K]
           [--tol TOL] [--max-iter M]

For each N it runs proton_tpu's solve_fictdom_structured(N, K,
mixed=False, use_pallas=False, fitted="lean") and proton_tpu_torch's
solve_fictdom_structured(N, K, fitted="lean", device="cpu"), each with
mg_f32=False and mg_f32=True, at CG tol TOL (default 1e-11), and prints
one JSON line each: iterations, exit code, final relative residual, H1
error and seconds. Default N: 64 128, K 2.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import torch

from proton_tpu.cut import fictdom_structured as jfs
from proton_tpu.solvers import cg as jcg
from proton_tpu_torch.cut import fictdom_structured as tfs
from proton_tpu_torch.solvers import cg as tcg


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sizes", type=int, nargs="*", default=[64, 128])
    ap.add_argument("--degree", type=int, default=2)
    ap.add_argument("--tol", type=float, default=1e-11)
    ap.add_argument("--max-iter", type=int, default=5000)
    args = ap.parse_args()
    for N in args.sizes:
        for package, fs, cg, extra in (
                ("proton_tpu", jfs, jcg, dict(mixed=False, use_pallas=False)),
                ("proton_tpu_torch", tfs, tcg,
                 dict(device="cpu", dtype=torch.float64))):
            for mg_f32 in (False, True):
                params = cg.CGParams(convergence_threshold=args.tol,
                                     divergence_threshold=1e8,
                                     max_iter=args.max_iter,
                                     apply_preconditioner=True)
                t0 = time.perf_counter()
                r = fs.solve_fictdom_structured(
                    N, args.degree, fitted="lean", mg_f32=mg_f32,
                    cg_params=params, **extra)
                print(json.dumps(dict(
                    package=package, N=N, degree=args.degree, tol=args.tol,
                    mg_f32=mg_f32, iterations=int(r.iterations),
                    exit=int(r.exit_reason), rel=float(r.rel_residual),
                    h1=float(r.h1_error),
                    seconds=time.perf_counter() - t0)), flush=True)


if __name__ == "__main__":
    main()
