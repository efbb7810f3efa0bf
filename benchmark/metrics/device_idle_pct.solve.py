"""device_idle_pct.solve: 100 (1 - busy / slice) over the traced slice of
the first problem's CG (the union of the device's kernel intervals in
it, torch.profiler)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
