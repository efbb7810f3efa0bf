"""assembly_s.solve: the program's assembly_s span (K1 on the unit and
displaced cells, the Nitsche cut operators, the lean condensation), with
condense_s where the path has it, mean per problem."""


def read(run):
    v = [p.outcome.timings["assembly_s"] + p.outcome.timings.get(
        "condense_s", 0.0) for p in run.problems
        if "assembly_s" in p.outcome.timings]
    return sum(v) / len(v) if v else None
