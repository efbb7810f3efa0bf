"""copy_sentinel_writes.interface: the program's iface_copy_sentinel_writes
counter (the entries of the interface preconditioner's copy map P that
name a sentinel slot instead of a face-grid value), mean per problem; left
out, without raising, where the program does not count it."""


def read(run):
    v = [p.outcome.timings["iface_copy_sentinel_writes"]
         for p in run.problems
         if "iface_copy_sentinel_writes" in p.outcome.timings]
    return sum(v) / len(v) if v else None
