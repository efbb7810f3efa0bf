"""mg_setup_s.solve: the program's assemble_coarse_s + mg_setup_s spans
(the coarse levels and the V-cycle's set-up), mean per problem."""


def read(run):
    v = [p.outcome.timings["assemble_coarse_s"] +
         p.outcome.timings["mg_setup_s"] for p in run.problems
         if "mg_setup_s" in p.outcome.timings]
    return sum(v) / len(v) if v else None
