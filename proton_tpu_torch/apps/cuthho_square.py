"""cutHHO on a unit-square mesh cut by a circle level set (JAX
counterpart: proton_tpu/apps/cuthho_square.py; reference
apps/cuthho/cuthho_square.cpp:1940-2135).

Flags mirror the reference getopt string "k:M:N:r:ifDAd" (:1971):
  -k degree, -M/-N cells per direction, -r interface refinement steps,
  -i solve the interface problem, -f solve the fictitious-domain problem,
  -D node displacement for bad cuts (the default), -A agglomeration
  detection (classification only, then the solves on that mesh),
  -d dump debug data (VTK / npz mesh info, the fictdom point clouds and,
  with matplotlib, the mesh and triangulation plots);
plus --device (default: cuda; without CUDA and without --device the app
raises).

Usage: python -m proton_tpu_torch.apps.cuthho_square -f -i -N 16 -M 16 -k 1
       [--device cpu]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-k", type=int, default=0, help="method degree")
    ap.add_argument("-M", type=int, default=5, help="cells in x")
    ap.add_argument("-N", type=int, default=5, help="cells in y")
    ap.add_argument("-r", type=int, default=4,
                    help="interface refinement steps")
    ap.add_argument("-i", action="store_true",
                    help="solve interface problem")
    ap.add_argument("-f", action="store_true",
                    help="solve fictitious-domain problem")
    ap.add_argument("-D", action="store_true",
                    help="node displacement for bad cuts (default)")
    ap.add_argument("-A", action="store_true",
                    help="agglomeration detection for bad cuts")
    ap.add_argument("-d", action="store_true", help="dump debug data")
    ap.add_argument("--device", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from ..core.mesh import make_poly_mesh
    from ..cut import classify, fictdom, interface_problem
    from ..cut.fictdom_structured import default_problem
    from ..utils.timing import TimeCounter, bold, green, yellow

    tc = TimeCounter().tic()
    mesh = make_poly_mesh(Nx=args.M, Ny=args.N, device=args.device)
    tc.toc(mesh.points)
    print(bold(yellow(f"Mesh generation: {tc} seconds")))

    p = default_problem(0.35, (0.5, 0.5))
    tc.tic()
    mesh, cutdata = classify.cut_preprocess(mesh, p.ls, levels=args.r,
                                            agglomeration=args.A)
    tc.toc(cutdata.cell_loc)
    print(bold(yellow(f"cutHHO-specific mesh preprocessing: {tc} seconds")))

    if args.d:
        from ..io.vtk import output_mesh_info
        output_mesh_info(mesh, cutdata, p.ls)
        try:
            from ..io.debug_plots import dump_mesh, plot_triangulation
            dump_mesh(mesh, cutdata)
            plot_triangulation(mesh, cutdata, classify.LOC_NEG)
        except ImportError:
            print("matplotlib unavailable; skipped debug plots")
        print("wrote cuthho_meshinfo.{vtk,npz}")

    if args.i:
        tc.tic()
        res = interface_problem.solve_interface(
            mesh, cutdata, p.ls, args.k, p.rhs_fun, p.sol_fun, p.sol_grad)
        tc.toc(res.x)
        print(bold(yellow(f"Interface solve: {tc} seconds "
                          f"({res.iterations} CG iterations)")))
        print(bold(green("Energy-norm absolute error:           "
                         f"{res.h1_error}")))

    if args.f:
        tc.tic()
        res = fictdom.solve_fictdom(
            mesh, cutdata, p.ls, args.k, p.rhs_fun, p.sol_fun, p.sol_grad)
        tc.toc(res.x)
        print(bold(yellow(f"Fictdom solve: {tc} seconds "
                          f"({res.iterations} CG iterations)")))
        print(bold(green("Energy-norm absolute error:           "
                         f"{res.h1_error}")))

        if args.d:
            # point-cloud postprocess outputs (fictdom_uT.dat etc.,
            # cuthho_square.cpp:939-942, 1066-1070)
            from ..io.gnuplot import GnuplotOutput, PostprocessOutput
            pts, uT, Ru, diff = fictdom.fictdom_fields(
                mesh, cutdata, p.ls, args.k, res, p.sol_fun)
            post = PostprocessOutput()
            for name, vals in (("fictdom_uT.dat", uT),
                               ("fictdom_Ru.dat", Ru),
                               ("fictdom_diff.dat", diff)):
                gp = GnuplotOutput(name)
                gp.add_data(pts, vals)
                post.add_object(gp)
            post.write()
            print("wrote fictdom_{uT,Ru,diff}.dat")
    return 0


if __name__ == "__main__":
    sys.exit(main())
