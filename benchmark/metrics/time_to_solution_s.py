"""time_to_solution_s: the window's wall time over the problems completed
in it (host clock; each problem ends in a device synchronize)."""


def read(run):
    return run.window_s / len(run.problems) if run.problems else None
