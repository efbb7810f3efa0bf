"""A polygonal "brick" mesh of the unit square in load_poly_mesh's text
format: ``ny`` rows of ``nx`` rectangles of size (1/nx) x (1/ny), every
other row shifted by half a brick (half bricks close those rows at both
ends). The corners of one row sit at the edge midpoints of the rows above
and below, so an interior brick is a hexagon (its six vertices include two
edge midpoints), the bricks of the bottom and top rows are pentagons, and
the half bricks are quadrilaterals.

    python3 -m proton_tpu_torch.tools.brick_mesh OUT.txt NX NY
"""

from __future__ import annotations

import sys

import numpy as np


def brick_mesh_arrays(nx: int, ny: int):
    """(points [P, 2], cells: list of CCW point-id lists, boundary edges
    [B, 2]). Points lie on the lines y = j/ny at x = m/(2 nx)."""
    def row_corners(j):
        """Corner positions m (units of half a brick) of row j."""
        if j % 2 == 0:
            return list(range(0, 2 * nx + 1, 2))
        return [0] + list(range(1, 2 * nx, 2)) + [2 * nx]

    lines = []
    for j in range(ny + 1):
        if j == 0:
            ms = row_corners(0)
        elif j == ny:
            ms = row_corners(ny - 1)
        else:
            ms = list(range(2 * nx + 1))
        lines.append(ms)
    pid, points = {}, []
    for j, ms in enumerate(lines):
        for m in ms:
            pid[(j, m)] = len(points)
            points.append((m / (2.0 * nx), j / ny))

    cells = []
    for j in range(ny):
        corners = row_corners(j)
        for a, b in zip(corners[:-1], corners[1:]):
            span = range(a, b + 1)
            bottom = [pid[(j, m)] for m in span if (j, m) in pid]
            top = [pid[(j + 1, m)] for m in span if (j + 1, m) in pid]
            cells.append(bottom + top[::-1])

    bnd = []
    for j in (0, ny):
        ids = [pid[(j, m)] for m in lines[j]]
        bnd += list(zip(ids[:-1], ids[1:]))
    for m in (0, 2 * nx):
        bnd += [(pid[(j, m)], pid[(j + 1, m)]) for j in range(ny)]
    return np.array(points), cells, np.array(bnd)


def write_brick_mesh(path, nx: int, ny: int) -> None:
    """Write the nx x ny brick mesh to ``path`` (basic_mesh.hpp:405-475
    format: #points, x y per point, #cells, npts domain ids per cell,
    #boundary faces, domain p0 p1 per face)."""
    points, cells, bnd = brick_mesh_arrays(nx, ny)
    out = [str(len(points))]
    out += [f"{float(x)!r} {float(y)!r}" for x, y in points]
    out.append(str(len(cells)))
    out += [f"{len(c)} 1 " + " ".join(map(str, c)) for c in cells]
    out.append(str(len(bnd)))
    out += [f"1 {a} {b}" for a, b in bnd]
    with open(path, "w") as fh:
        fh.write("\n".join(out) + "\n")


if __name__ == "__main__":
    write_brick_mesh(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
