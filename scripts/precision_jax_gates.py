"""The JAX package's precision modes on the CPU at 16^2: the reference
numbers that tests/test_torch_precision.py and chip_smoke.py's phase 26
hold the PyTorch port's solves to. The test file runs the mixed k=2
solve live as well, and each other case's pieces (a live JAX solve
costs 60-90 s of compilation on one CPU core, more than the test file
may take for each).

Usage: python scripts/precision_jax_gates.py

Each case runs proton_tpu's solve_fictdom_structured(16, k, ...,
use_pallas=False) at the CG tolerance named, divergence 1e8, max_iter
50000, in float64 (x64) on the CPU backend, and prints one line
`name: (iterations, exit code, H1 error)`; the last line is the dict
PRECISION_GATES as the test file and chip_smoke.py store it.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from proton_tpu.cut import fictdom_structured as jfs  # noqa: E402
from proton_tpu.solvers import cg as jcg  # noqa: E402

# name -> (degree, CG tolerance, keywords of solve_fictdom_structured)
CASES = {
    "mixed_k1": (1, 1e-9, dict(mixed=True, fitted="lean")),
    "mixed_k2": (2, 1e-9, dict(mixed=True, fitted="lean")),
    "mixed_full_k2": (2, 1e-9, dict(mixed=True, fitted="full")),
    "mixed_cg32_k1": (1, 1e-7, dict(mixed=True, fitted="lean",
                                    cg_f64=False)),
    "mg_f32_k2": (2, 1e-11, dict(mixed=False, fitted="lean", mg_f32=True)),
    "segment4_k1": (1, 1e-10, dict(mixed=False, fitted="lean",
                                   cg_segment=4)),
}


def main() -> None:
    gates = {}
    for name, (k, tol, kw) in CASES.items():
        t0 = time.perf_counter()
        r = jfs.solve_fictdom_structured(
            16, k, use_pallas=False,
            cg_params=jcg.CGParams(convergence_threshold=tol,
                                   divergence_threshold=1e8,
                                   max_iter=50000,
                                   apply_preconditioner=True), **kw)
        gates[name] = (int(r.iterations), int(r.exit_reason),
                       float(r.h1_error))
        print(f"{name}: {gates[name]} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    print("PRECISION_GATES = {")
    for name, v in gates.items():
        print(f"    {name!r}: {v},")
    print("}")


if __name__ == "__main__":
    main()
