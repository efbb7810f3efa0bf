"""mg_setup_s.interface: the program's mg_setup_s span in the interface
preconditioner (the copy maps between the doubled face dofs and the face
grids, the unit cell of every level, the uniform V-cycle's levels and,
on the card, its CUDA graph), mean per problem."""


def read(run):
    v = [p.outcome.timings["mg_setup_s"] for p in run.problems
         if "mg_setup_s" in p.outcome.timings]
    return sum(v) / len(v) if v else None
