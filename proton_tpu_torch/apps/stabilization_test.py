"""Convergence order of the HHO stabilization form alone (JAX
counterpart: proton_tpu/apps/stabilization_test.py; reference
apps/stabilization_test/stabilization_test.cpp): for each k,
sqrt(proj . S proj) on the first cell for N = 2, 4, ..., 32, printing the
observed orders log2(e_prev/e_cur) (:80-94). Runs on CUDA unless
``--device cpu`` is given.

Usage: python -m proton_tpu_torch.apps.stabilization_test [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def test_stabilization(N: int, k: int, device=None) -> float:
    """stabilization_test.cpp:38-75 (first cell only, equal-order hdi)."""
    from ..core import ops
    from ..core.geometry import cell_geometry
    from ..core.mesh import make_quad_mesh
    from ..methods import hho

    hdi = ops.HHODegreeInfo(k, k)
    mesh = make_quad_mesh(Nx=N, Ny=N, device=device)
    geom = cell_geometry(mesh)
    pi = np.pi

    def rhs_fun(p):
        return 2.0 * pi ** 2 * torch.sin(2 * pi * p[..., 0]) * \
            torch.sin(2 * pi * p[..., 1])

    oper, _ = hho.hho_laplacian(mesh, geom, hdi)
    S = hho.fancy_stabilization(mesh, geom, hdi, oper)
    proj = ops.project_function(mesh, geom, hdi, rhs_fun)
    return float(np.sqrt(float(proj[0] @ S[0] @ proj[0])))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    from ..config import resolve_device

    device = resolve_device(args.device)
    for k in range(0, 6):
        errors = []
        N = 2
        while N < 64:
            errors.append(test_stabilization(N, k, device))
            N *= 2
        orders = [np.log(errors[i - 1] / errors[i]) / np.log(2.0)
                  for i in range(1, len(errors))]
        print("  ".join(f"{o:.2g}" for o in orders))
    return 0


if __name__ == "__main__":
    sys.exit(main())
