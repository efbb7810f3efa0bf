"""cg_iters.solve: CG iterations per problem, mean."""


def read(run):
    v = [p.outcome.iterations for p in run.problems]
    return sum(v) / len(v) if v else None
