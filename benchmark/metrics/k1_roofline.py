"""Frozen arithmetic of kernel K1 (``csrc/fused_assembly.cu``, the fused
HHO local operator of every quad cell): its operations and bytes from
the shapes alone, and the least time the card could take, against the
published peaks of the cards it runs on (copied from ``chip_smoke.py``,
``PEAKS``, ``k1_flops_per_cell`` and ``kernel_row``).

K1 reads 40 values per cell (4 corners, barycentre, diameter, area, 4
normals, 4 x 5 face data) and writes d x d, d = cbs + 4 fbs: every input
byte read once and every output byte written once. A share of the
roofline is ``bound_ms(...) / measured ms``.

This is not a reader: the cells that launch K1 over every cell (a family
of geometries, Open questions in PERF.md) will read it through a
``k1_roofline_pct`` reader of their own.
"""

from __future__ import annotations

# (name fragment, bytes/s, float64 FLOP/s, float32 FLOP/s); NVIDIA's data
# sheets, dense rates, full power limit. First match wins.
PEAKS = (("H100 PCIe", 2.0e12, 25.6e12, 51.2e12),
         ("H100 NVL", 3.9e12, 30.0e12, 60.0e12),
         ("H200", 4.8e12, 34.0e12, 67.0e12),
         ("H100", 3.35e12, 34.0e12, 67.0e12))


def peaks(kind: str):
    """(bytes/s, float64 FLOP/s, float32 FLOP/s) of the card ``kind``
    (torch.cuda.get_device_name)."""
    for key, bw, f64, f32 in PEAKS:
        if key in kind:
            return bw, f64, f32
    raise ValueError(f"no peak rates known for {kind!r}")


def local_size(cell_degree: int, face_degree: int) -> int:
    cbs = (cell_degree + 1) * (cell_degree + 2) // 2
    return cbs + 4 * (face_degree + 1)


def flops_per_cell(cd: int, fd: int) -> int:
    """Operations of K1 for one cell, counted from the algorithm: cell
    quadrature, face quadrature, stabilization solves, reconstruction
    solve, the d x d product."""
    rec = fd + 1
    rbs = (rec + 1) * (rec + 2) // 2
    cbs = (cd + 1) * (cd + 2) // 2
    fbs = fd + 1
    d, nr = cbs + 4 * fbs, rbs - 1
    cell_q = (rec + 1) ** 2 * (40 + 6 * rbs + 2 * nr * (nr + 1))
    face_q = 4 * (fd + 1) * (30 + 9 * rbs + 2 * nr * (fbs + cbs) +
                             fbs * (fbs + 1) + 2 * fbs * cbs)
    stab = 4 * (fbs ** 3 // 3 + 2 * fbs * fbs * cbs + 2 * fbs * cbs * cbs)
    recon = nr ** 3 // 3 + nr * nr * d + 2 * nr * d * d
    return cell_q + face_q + stab + recon + 2 * d * d


def bytes_moved(cells: int, cd: int, fd: int, value_bytes: int = 8) -> int:
    d = local_size(cd, fd)
    return (40 + d * d) * value_bytes * cells


def bound_ms(cells: int, cd: int, fd: int, kind: str = "H100",
             value_bytes: int = 8):
    """(least ms, "bytes" or "operations") of one K1 launch on ``cells``
    cells."""
    bw, f64, f32 = peaks(kind)
    by_bytes = bytes_moved(cells, cd, fd, value_bytes) / bw * 1e3
    by_ops = flops_per_cell(cd, fd) * cells / \
        (f64 if value_bytes == 8 else f32) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")
