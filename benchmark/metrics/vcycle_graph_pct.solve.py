"""vcycle_graph_pct.solve: the share of the window's V-cycle calls that
replayed the program's CUDA graph of the V-cycle: its mg_graph_replay
counts over its cg_precond counts, each summed over the window's
problems, in %. Nothing where no problem counted a replay (a program
without the graph)."""


def read(run):
    t = [p.outcome.timings for p in run.problems
         if "cg_precond_calls" in p.outcome.timings]
    if not any("mg_graph_replay_calls" in x for x in t):
        return None
    calls = sum(x["cg_precond_calls"] for x in t)
    replays = sum(x.get("mg_graph_replay_calls", 0) for x in t)
    return 100.0 * replays / calls if calls else None
