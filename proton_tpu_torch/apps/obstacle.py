"""HHO obstacle problem app (JAX counterpart: proton_tpu/apps/obstacle.py;
reference apps/obstacle/obstacle.cpp).

Flags mirror the reference getopt (-k degree in {0,1}, -N subdivisions,
obstacle.cpp:243-266); field dumps go to VTK instead of SILO.
``--checkpoint FILE`` writes a restartable snapshot of the active-set
state after every iteration, ``--resume FILE`` starts from one. Runs on
CUDA unless ``--device cpu`` is given.

Usage: python -m proton_tpu_torch.apps.obstacle -k 1 -N 32 [--dump]
       [--device cpu]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-k", type=int, default=0, help="degree (0 or 1)")
    ap.add_argument("-N", type=int, default=5, help="cells per direction")
    ap.add_argument("--dump", action="store_true",
                    help="write VTK field dumps")
    ap.add_argument("--dump-iterations", action="store_true",
                    help="write obstacle_cycle_<i>.vtk per active-set "
                         "iteration (the reference's per-cycle SILO dumps)")
    ap.add_argument("--checkpoint", metavar="FILE",
                    help="write the active-set state after every iteration")
    ap.add_argument("--resume", metavar="FILE",
                    help="start from a state written by --checkpoint")
    ap.add_argument("--device", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from ..config import resolve_device
    from ..core.mesh import MeshInitParams, make_quad_mesh
    from ..io.vtk import VtkWriter
    from ..methods import obstacle
    from ..utils import checkpoint
    from ..utils.timing import TimeCounter, bold, green, magenta

    device = resolve_device(args.device)
    mesh = make_quad_mesh(MeshInitParams(min_x=-1.0, min_y=-1.0, Nx=args.N,
                                         Ny=args.N), device=device)

    def callback(i, fields):
        if args.dump_iterations:
            w = VtkWriter(mesh)
            w.add_variable("alpha", fields["alpha"], "zonal")
            w.add_variable("beta", fields["beta"], "zonal")
            w.add_variable("active", fields["active"].double(), "zonal")
            w.write_vtk(f"obstacle_cycle_{i - 1}.vtk")
        if args.checkpoint:
            checkpoint.obstacle_checkpoint(args.checkpoint, fields["alpha"],
                                           fields["beta"], i)

    initial_state = None
    if args.resume:
        alpha_cells, beta, it = checkpoint.obstacle_resume(args.resume)
        initial_state = (alpha_cells, beta)
        print(f"resuming from {args.resume} (iteration {it})")

    tc = TimeCounter().tic()
    res = obstacle.run_obstacle(
        args.N, args.k, device=device, initial_state=initial_state,
        iteration_callback=callback if (args.dump_iterations or
                                        args.checkpoint) else None)
    tc.toc(res.alpha)
    print(green(f"Active-set solve ({res.iterations} iterations): ")
          + bold(f"{tc} seconds"))
    print(bold(magenta(f"Error: {float(res.energy_error)}")))

    if args.dump:
        w = VtkWriter(mesh)
        w.add_variable("alpha", res.alpha[:mesh.num_cells], "zonal")
        w.add_variable("beta", res.beta, "zonal")
        w.write_vtk("obstacle_solution.vtk")
        w.write_npz("obstacle_solution.npz")
        print("wrote obstacle_solution.{vtk,npz}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
