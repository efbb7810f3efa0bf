"""cg_iter_ms.solve: the program's cg_s spans summed over the window's
problems, over their CG iterations summed, in ms."""


def read(run):
    its = sum(p.outcome.iterations for p in run.problems)
    s = sum(p.outcome.timings.get("cg_s", 0.0) for p in run.problems)
    return 1e3 * s / its if its and s else None
