"""face_system_s.solve: the program's setup_s span (the face system of
the fine level: the Dirichlet fold, the condensed load and operator),
mean per problem."""


def read(run):
    v = [p.outcome.timings["setup_s"] for p in run.problems
         if "setup_s" in p.outcome.timings]
    return sum(v) / len(v) if v else None
