"""The multigrid options the JAX package keeps off by default (cheb_ops
'mixed' and 'uniform', mg_transfer 'smoothed' and 'cut', mg_deflate=4)
in the JAX package and in the PyTorch port, on the CPU, each beside the
uniform default: does an option cost the port the same CG iterations as
it costs JAX, as the mesh grows?

Usage: python scripts/mg_options_jax_vs_port.py [N ...] [--degree K]
           [--tol TOL] [--max-iter M] [--package jax|torch|both]
           [--options NAME ...] [--history M]

For each N it runs proton_tpu's solve_fictdom_structured(N, K,
mixed=False, use_pallas=False, fitted="lean", **option) and
proton_tpu_torch's solve_fictdom_structured(N, K, fitted="lean",
device="cpu", **option) at CG tol TOL (default 1e-11), and prints one
JSON line each: the option, iterations, exit code, final relative
residual, H1 error and seconds. Default N: 64 128, K 1, every option
of OPTIONS. A long JAX process can die in XLA's CPU code generator
("Unable to allocate section memory"); one process per size and option
avoids it, e.g. `128 --package jax --options cut`. With --history M the
port's lines also carry the last M relative residuals of its CG
(CGParams.record_history), e.g. to see a count set by a plateau at the
tolerance.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OPTIONS = {"uniform": {}, "cheb_mixed": dict(cheb_ops="mixed"),
           "cheb_uniform": dict(cheb_ops="uniform"),
           "smoothed": dict(mg_transfer="smoothed"),
           "cut": dict(mg_transfer="cut"), "deflate4": dict(mg_deflate=4)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sizes", type=int, nargs="*", default=[64, 128])
    ap.add_argument("--degree", type=int, default=1)
    ap.add_argument("--tol", type=float, default=1e-11)
    ap.add_argument("--max-iter", type=int, default=5000)
    ap.add_argument("--package", choices=("jax", "torch", "both"),
                    default="both")
    ap.add_argument("--options", nargs="+", choices=list(OPTIONS),
                    default=list(OPTIONS))
    ap.add_argument("--history", type=int, default=0)
    args = ap.parse_args()
    packages = []
    if args.package in ("jax", "both"):
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        from proton_tpu.cut import fictdom_structured as jfs
        from proton_tpu.solvers import cg as jcg

        packages.append(("proton_tpu", jfs, jcg,
                         dict(mixed=False, use_pallas=False)))
    if args.package in ("torch", "both"):
        import torch

        from proton_tpu_torch.cut import fictdom_structured as tfs
        from proton_tpu_torch.solvers import cg as tcg

        packages.append(("proton_tpu_torch", tfs, tcg,
                         dict(device="cpu", dtype=torch.float64)))
    history = args.history > 0
    for N in args.sizes:
        for package, fs, cg, extra in packages:
            for name in args.options:
                option = OPTIONS[name]
                on_port = package == "proton_tpu_torch"
                params = cg.CGParams(convergence_threshold=args.tol,
                                     divergence_threshold=1e8,
                                     max_iter=args.max_iter,
                                     apply_preconditioner=True,
                                     record_history=history and on_port)
                t0 = time.perf_counter()
                r = fs.solve_fictdom_structured(
                    N, args.degree, fitted="lean", cg_params=params,
                    **option, **extra)
                print(json.dumps(dict(
                    package=package, N=N, degree=args.degree, tol=args.tol,
                    option=name, iterations=int(r.iterations),
                    exit=int(r.exit_reason), rel=float(r.rel_residual),
                    h1=float(r.h1_error),
                    seconds=time.perf_counter() - t0,
                    **({"history": [float(h) for h in r.history[
                        :int(r.iterations) + 1][-args.history:]]}
                       if history and on_port else {}))), flush=True)


if __name__ == "__main__":
    main()
