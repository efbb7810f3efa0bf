"""classify_s.solve: the program's classify_s span (band classification
and the cut batch), mean per problem."""


def read(run):
    v = [p.outcome.timings["classify_s"] for p in run.problems
         if "classify_s" in p.outcome.timings]
    return sum(v) / len(v) if v else None
