"""vcycle_ms.solve: the program's cg_precond spans (the host enqueueing
one V-cycle) summed over the window's problems, over their calls summed,
in ms."""


def read(run):
    t = [p.outcome.timings for p in run.problems
         if "cg_precond_calls" in p.outcome.timings]
    calls = sum(x["cg_precond_calls"] for x in t)
    return 1e3 * sum(x["cg_precond_s"] for x in t) / calls if calls else None
