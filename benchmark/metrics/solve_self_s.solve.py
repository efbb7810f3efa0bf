"""solve_self_s.solve: the self time of the program's solve span (a
problem's seconds outside every phase span), mean per problem."""


def read(run):
    v = [p.outcome.timings["solve_self_s"] for p in run.problems
         if "solve_self_s" in p.outcome.timings]
    return sum(v) / len(v) if v else None
