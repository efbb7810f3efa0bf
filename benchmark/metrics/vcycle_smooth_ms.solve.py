"""vcycle_smooth_ms.solve: the program's mg_smooth_n<n> spans (pre- and
post-smoothing, every level) summed over the window's problems, over
their cg_precond calls summed, in ms."""

import re

SMOOTH = re.compile(r"mg_smooth_n\d+_s$")


def read(run):
    seconds = calls = 0
    for p in run.problems:
        t = p.outcome.timings
        if "cg_precond_calls" not in t:
            continue
        seconds += sum(v for k, v in t.items() if SMOOTH.match(k))
        calls += t["cg_precond_calls"]
    return 1e3 * seconds / calls if calls else None
