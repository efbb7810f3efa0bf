"""condense_s.interface: the program's condense_s span (the static
condensation of both cell classes, the Dirichlet fold, the condensed
right-hand side and operator), mean per problem."""


def read(run):
    v = [p.outcome.timings["condense_s"] for p in run.problems
         if "condense_s" in p.outcome.timings]
    return sum(v) / len(v) if v else None
