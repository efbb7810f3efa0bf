"""cg_wait_ms.solve: the program's cg_wait spans (the host blocked in CG's
exit test until the device has run the iteration's work) summed over the
window's problems, over their CG iterations summed, in ms."""


def read(run):
    out = [p.outcome for p in run.problems if "cg_wait_s" in p.outcome.timings]
    its = sum(o.iterations for o in out)
    return 1e3 * sum(o.timings["cg_wait_s"] for o in out) / its \
        if its else None
