"""cg_vector_ms.solve: the self time of the program's cg span (CG less
its operator applies, preconditioner calls and exit-test waits: the dot
products, axpys and tests) summed over the window's problems, over their
CG iterations summed, in ms."""


def read(run):
    out = [p.outcome for p in run.problems if "cg_self_s" in p.outcome.timings]
    its = sum(o.iterations for o in out)
    return 1e3 * sum(o.timings["cg_self_s"] for o in out) / its \
        if its else None
