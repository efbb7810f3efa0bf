"""assemble_s.interface: the program's assemble_s span (the doubled-dof
map on the host, the kappa-weighted fitted operator and naive
stabilization of every cell, the doubled cut-cell operators and the
loads), mean per problem."""


def read(run):
    v = [p.outcome.timings["assemble_s"] for p in run.problems
         if "assemble_s" in p.outcome.timings]
    return sum(v) / len(v) if v else None
