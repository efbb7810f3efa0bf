"""face_dofs.interface: the program's iface_face_dofs counter (the size
of the condensed doubled face system), mean per problem."""


def read(run):
    v = [p.outcome.timings["iface_face_dofs"] for p in run.problems
         if "iface_face_dofs" in p.outcome.timings]
    return sum(v) / len(v) if v else None
