"""band_setup_s.interface: the program's band_setup_s span (the cut-band
Schwarz patch maps, blocks and their inverses), mean per problem."""


def read(run):
    v = [p.outcome.timings["band_setup_s"] for p in run.problems
         if "band_setup_s" in p.outcome.timings]
    return sum(v) / len(v) if v else None
