"""vcycle_fine_ms.solve: the program's V-cycle stage spans at the finest
level (mg_<stage>_n<N>_s at the largest N of the problem) summed over the
window's problems, over their cg_precond calls summed, in ms."""

import re

STAGE = re.compile(r"mg_[a-z]+_n(\d+)_s$")


def read(run):
    seconds = calls = 0
    for p in run.problems:
        t = p.outcome.timings
        stages = [(int(m.group(1)), v) for k, v in t.items()
                  if (m := STAGE.match(k))]
        if not stages or "cg_precond_calls" not in t:
            continue
        fine = max(n for n, _ in stages)
        seconds += sum(v for n, v in stages if n == fine)
        calls += t["cg_precond_calls"]
    return 1e3 * seconds / calls if calls else None
