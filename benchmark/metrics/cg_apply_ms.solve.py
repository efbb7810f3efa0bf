"""cg_apply_ms.solve: the program's cg_apply spans (the host enqueueing
the fine face operator's apply in CG) summed over the window's problems,
over their calls summed, in ms."""


def read(run):
    t = [p.outcome.timings for p in run.problems
         if "cg_apply_calls" in p.outcome.timings]
    calls = sum(x["cg_apply_calls"] for x in t)
    return 1e3 * sum(x["cg_apply_s"] for x in t) / calls if calls else None
