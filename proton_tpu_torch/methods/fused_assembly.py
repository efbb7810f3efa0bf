"""Kernel K1: fused fitted-HHO local assembly on quadrilateral cells
(JAX counterpart: proton_tpu/methods/pallas_assembly.py, whose
``fused_local_operator`` reaches ``pl.pallas_call`` at :340).

For every quad cell, lc = reconstruction data + naive stabilization, in
the cells-last layout [d*d, C] with d = cbs + 4*fbs:

- ``fused_local_operator`` launches the CUDA kernel
  (csrc/fused_assembly.cu) for CUDA tensors, and takes the plain version
  only for CPU tensors;
- ``fitted_local_operator_plain`` is the same function as batched tensor
  math (the algorithm of proton_tpu/methods/hho.py: hho_laplacian +
  naive_stabilization); ``reconstruction_and_operator_plain`` is the
  same computation returning the reconstruction operator as well, which
  the multigrid transfers need for one cell and the kernel does not
  write;
- ``fitted_local_operator`` is the mesh-level wrapper (JAX :383).

Both the kernel and the plain version take the quadrature nodes and the
basis exponent order from this package's ``gauss_legendre`` and
``_exponent_tables``.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from .. import native
from ..core import bases
from ..core.bases import _exponent_tables
from ..core.geometry import cell_points
from ..core.ops import HHODegreeInfo, cho_solve_batched
from ..core.quadrature import gauss_legendre

_KERNEL_SOURCE = "fused_assembly"

# Launch geometry of each compiled instantiation, (dtype, cell degree, face
# degree) -> (cells per tile, warps per block, dynamic shared-memory bytes).
# The launcher checks each value against its compile-time constants and
# refuses a launch that differs (csrc/fused_assembly.cu, code -3).
LAUNCH_GEOMETRY = {
    (torch.float64, 1, 0): (32, 4, 18944),
    (torch.float64, 2, 1): (32, 5, 48896),
    (torch.float64, 3, 2): (32, 8, 113152),
    (torch.float64, 1, 1): (32, 5, 38912),
    (torch.float32, 1, 0): (32, 4, 9472),
    (torch.float32, 2, 1): (32, 5, 24448),
    (torch.float32, 3, 2): (32, 8, 56576),
    (torch.float32, 1, 1): (32, 5, 19456),
}


def pack_inputs(mesh, geom):
    """Mesh/geometry in the kernel's cells-last layout (JAX :354):
    corners [4, 2, C], bar [2, C], diam [1, C], meas [1, C],
    normals [4, 2, C], fgeo [4, 5, C] (face barycenter x/y, face-basis
    base vector x/y, face length). The CUDA kernel masks the ragged last
    block itself, so unlike the TPU's 256-cell blocks no padding cells
    are added."""
    cp = cell_points(mesh)[:, :4, :]
    fbar = geom.face_bar[:, :4]
    fbase = fbar - geom.face_pts[:, :4, 0, :]
    fgeo = torch.cat([fbar, fbase, geom.face_h[:, :4, None]], dim=2)
    return (cp.permute(1, 2, 0).contiguous(),
            geom.bar.T.contiguous(),
            geom.diam[None, :].contiguous(),
            geom.meas[None, :].contiguous(),
            geom.normals[:, :4].permute(1, 2, 0).contiguous(),
            fgeo.permute(1, 2, 0).contiguous())


def _sizes(cell_degree: int, face_degree: int):
    rbs = bases.cell_basis_size(face_degree + 1)
    cbs = bases.cell_basis_size(cell_degree)
    fbs = bases.face_basis_size(face_degree)
    return rbs, cbs, fbs, cbs + 4 * fbs


def shared_rows(cell_degree: int, face_degree: int) -> int:
    """Rows of one block's shared memory, one value per cell of the tile
    each: the 40 packed inputs, the cell moments (degree <= 2 recdeg - 2),
    K's packed lower triangle, gr [d, nr], and per face the packed factor
    of the face mass and the solved trace."""
    rbs, cbs, fbs, d = _sizes(cell_degree, face_degree)
    recdeg, nr = face_degree + 1, rbs - 1
    tri = lambda n: n * (n + 1) // 2
    return (40 + tri(2 * recdeg - 1) + tri(nr) + nr * d + 4 * tri(fbs) +
            4 * fbs * cbs)


def reconstruction_and_operator_plain(corners, bar, diam, meas, normals,
                                      fgeo, cell_degree: int,
                                      face_degree: int):
    """(oper [C, rbs-1, d], lc [C, d, d]) as batched tensor math on the
    packed inputs: the gradient-reconstruction operator (hho_laplacian's
    first result, which the kernel does not write) and the local operator
    the kernel computes."""
    recdeg = face_degree + 1
    rbs, cbs, fbs, d = _sizes(cell_degree, face_degree)
    C = corners.shape[-1]
    dt, dev = corners.dtype, corners.device
    pts4 = corners.permute(2, 0, 1)                    # [C, 4, 2]
    barc = bar.T                                       # [C, 2]
    h = diam[0]

    # cell stiffness on the tensor GL rule (hho.hpp:55-64)
    x, w = gauss_legendre(2 * recdeg)
    xi = torch.as_tensor(np.tile(x, len(x)), dtype=dt, device=dev)
    eta = torch.as_tensor(np.repeat(x, len(x)), dtype=dt, device=dev)
    ww = torch.as_tensor(np.repeat(w, len(w)) * np.tile(w, len(w)),
                         dtype=dt, device=dev)
    s = torch.stack([(1 - xi) * (1 - eta), (1 + xi) * (1 - eta),
                     (1 + xi) * (1 + eta), (1 - xi) * (1 + eta)])  # [4, Q]
    pts = 0.25 * torch.einsum("kq,ckx->cqx", s, pts4)
    p0, p1, p2, p3 = (pts4[:, i, None, :] for i in range(4))
    j11 = 0.25 * ((p1 - p0)[..., 0] * (1 - eta) + (p2 - p3)[..., 0] * (1 + eta))
    j12 = 0.25 * ((p1 - p0)[..., 1] * (1 - eta) + (p2 - p3)[..., 1] * (1 + eta))
    j21 = 0.25 * ((p3 - p0)[..., 0] * (1 - xi) + (p2 - p1)[..., 0] * (1 + xi))
    j22 = 0.25 * ((p3 - p0)[..., 1] * (1 - xi) + (p2 - p1)[..., 1] * (1 + xi))
    wq = ww * torch.abs(j11 * j22 - j12 * j21)         # [C, Q]
    dphi = bases.eval_cell_gradients(pts, barc[:, None, :], h[:, None],
                                     recdeg)
    stiff = torch.einsum("cq,cqix,cqjx->cij", wq, dphi, dphi)
    del dphi

    # face quadrature on local edges e0 = corner f, e1 = corner f+1
    e0 = pts4
    e1 = torch.roll(pts4, shifts=-1, dims=1)
    t, fw = gauss_legendre(2 * face_degree)
    t = torch.as_tensor(t, dtype=dt, device=dev)
    fw = torch.as_tensor(fw, dtype=dt, device=dev)
    fpts = (0.5 * (1 - t)[:, None] * e0[:, :, None, :] +
            0.5 * (1 + t)[:, None] * e1[:, :, None, :])   # [C, 4, Qf, 2]
    seg = torch.linalg.vector_norm(e1 - e0, dim=-1)
    wf = 0.5 * seg[..., None] * fw                        # [C, 4, Qf]
    cphi = bases.eval_cell_basis(fpts, barc[:, None, None, :],
                                 h[:, None, None], recdeg)
    cdphi = bases.eval_cell_gradients(fpts, barc[:, None, None, :],
                                      h[:, None, None], recdeg)
    g = fgeo.permute(2, 0, 1)                             # [C, 4, 5]
    fphi = bases.eval_face_basis(fpts, g[:, :, None, 0:2], g[:, :, None, 2:4],
                                 g[:, :, None, 4], face_degree)
    nrm = normals.permute(2, 0, 1)                        # [C, 4, 2]

    # gradient reconstruction (hho.hpp:66-93)
    dn = torch.einsum("cfqrx,cfx->cfqr", cdphi[..., 1:, :], nrm)
    face_blocks = torch.einsum("cfq,cfqr,cfqb->cfrb", wf, dn, fphi)
    cell_corr = torch.einsum("cfq,cfqr,cfqk->crk", wf, dn, cphi[..., :cbs])
    gr = torch.cat([stiff[:, 1:, :cbs] - cell_corr,
                    face_blocks.permute(0, 2, 1, 3).reshape(C, rbs - 1,
                                                            4 * fbs)], dim=2)
    oper = cho_solve_batched(stiff[:, 1:, 1:], gr)
    lc = torch.einsum("crm,crn->cmn", gr, oper)

    # naive stabilization (hho.hpp:99-148), h = cell area
    mass = torch.einsum("cfq,cfqi,cfqj->cfij", wf, fphi, fphi)
    trace = torch.einsum("cfq,cfqi,cfqk->cfik", wf, fphi, cphi[..., :cbs])
    ratio = cho_solve_batched(mass, trace)
    neg_eyes = torch.zeros((4, fbs, 4 * fbs), dtype=dt, device=dev)
    for f in range(4):
        neg_eyes[f, :, f * fbs:(f + 1) * fbs] = -torch.eye(fbs, dtype=dt,
                                                           device=dev)
    oper_s = torch.cat([ratio, neg_eyes.expand(C, 4, fbs, 4 * fbs)], dim=3)
    mo = torch.einsum("cfij,cfjs->cfis", mass, oper_s)
    lc += torch.einsum("cfir,cfis->crs", oper_s, mo) / meas[0][:, None, None]
    return oper, lc


def fitted_local_operator_plain(corners, bar, diam, meas, normals, fgeo,
                                cell_degree: int, face_degree: int):
    """lc [d*d, C] as batched tensor math: the same function as the
    kernel, on the same packed inputs."""
    lc = reconstruction_and_operator_plain(corners, bar, diam, meas, normals,
                                           fgeo, cell_degree, face_degree)[1]
    d = lc.shape[1]
    return lc.permute(1, 2, 0).reshape(d * d, -1)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = native.load(_KERNEL_SOURCE)
    vp = ctypes.c_void_p
    lib.fused_assembly_launch.argtypes = (
        [ctypes.c_int] * 3 + [vp] * 7 +
        [ctypes.c_longlong, vp, vp, ctypes.c_int, vp, vp, ctypes.c_int, vp,
         vp, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
         vp])
    lib.fused_assembly_launch.restype = ctypes.c_int
    lib.fused_assembly_occupancy.argtypes = [ctypes.c_int] * 3 + [vp]
    lib.fused_assembly_occupancy.restype = ctypes.c_int
    lib.fused_assembly_error_string.argtypes = [ctypes.c_int]
    lib.fused_assembly_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"fused_assembly {what} failed: " +
                           lib.fused_assembly_error_string(code).decode())


def _launch(inputs, out, cell_degree: int, face_degree: int,
            geometry=None) -> None:
    """Launch the kernel on ``out``'s stream at ``geometry`` (cells per
    tile, warps, shared-memory bytes; LAUNCH_GEOMETRY's row by default)."""
    lib = _library()
    if geometry is None:
        geometry = LAUNCH_GEOMETRY[(out.dtype, cell_degree, face_degree)]
    recdeg = face_degree + 1
    gx, gw = (np.ascontiguousarray(a, np.float64)
              for a in gauss_legendre(2 * recdeg))
    fx, fw = (np.ascontiguousarray(a, np.float64)
              for a in gauss_legendre(2 * face_degree))
    px, py = (np.ascontiguousarray(a, np.int32)
              for a in _exponent_tables(recdeg))
    stream = torch.cuda.current_stream(out.device).cuda_stream
    code = lib.fused_assembly_launch(
        int(out.dtype == torch.float64), cell_degree, face_degree,
        *(a.data_ptr() for a in inputs), out.data_ptr(), out.shape[1],
        gx.ctypes.data, gw.ctypes.data, len(gx), fx.ctypes.data,
        fw.ctypes.data, len(fx), px.ctypes.data, py.ctypes.data, len(px),
        *geometry, stream)
    _check(lib, code, "kernel launch")


def blocks_per_sm(cell_degree: int, face_degree: int, dtype) -> int:
    """Resident blocks per SM of one instantiation at its launch geometry
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor, on the current card)."""
    lib = _library()
    n = ctypes.c_int(0)
    _check(lib, lib.fused_assembly_occupancy(
        int(dtype == torch.float64), cell_degree, face_degree,
        ctypes.addressof(n)), "occupancy query")
    return n.value


def fused_local_operator(corners, bar, diam, meas, normals, fgeo,
                         cell_degree: int, face_degree: int):
    """lc [d*d, C] for packed cells-last inputs (see pack_inputs). CUDA
    tensors launch the kernel (and count the launch in
    ``fused_local_operator.launches``, with its cell count appended to
    ``fused_local_operator.launch_cells`` and its dtype to
    ``fused_local_operator.launch_dtypes``, which keep the last 64); CPU
    tensors take the plain version."""
    inputs = (corners, bar, diam, meas, normals, fgeo)
    C = corners.shape[-1]
    shapes = ((4, 2, C), (2, C), (1, C), (1, C), (4, 2, C), (4, 5, C))
    for a, shape in zip(inputs, shapes):
        if tuple(a.shape) != shape:
            raise ValueError(f"fused assembly input of shape "
                             f"{tuple(a.shape)}, expected {shape}")
        if a.dtype != corners.dtype or a.device != corners.device:
            raise ValueError("fused assembly inputs must share one dtype "
                             "and one device")
    if corners.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"fused assembly takes float32 or float64, "
                         f"not {corners.dtype}")
    if corners.device.type == "cpu":
        return fitted_local_operator_plain(*inputs, cell_degree, face_degree)
    if corners.device.type != "cuda":
        raise ValueError(f"no fused assembly kernel for {corners.device}")
    if not all(a.is_contiguous() for a in inputs):
        raise ValueError("fused assembly inputs must be contiguous")
    d = _sizes(cell_degree, face_degree)[3]
    out = torch.empty((d * d, C), dtype=corners.dtype, device=corners.device)
    _launch(inputs, out, cell_degree, face_degree)
    fused_local_operator.launches += 1
    fused_local_operator.launch_cells.append(C)
    fused_local_operator.launch_dtypes.append(corners.dtype)
    return out


fused_local_operator.launches = 0
fused_local_operator.launch_cells = collections.deque(maxlen=64)
fused_local_operator.launch_dtypes = collections.deque(maxlen=64)


def reset_launch_counts() -> None:
    """Set fused_local_operator's launch count to 0 and empty its lists of
    cell counts and dtypes."""
    fused_local_operator.launches = 0
    fused_local_operator.launch_cells.clear()
    fused_local_operator.launch_dtypes.clear()


def fitted_local_operator(mesh, geom, hdi: HHODegreeInfo,
                          cells_last: bool = False):
    """Fitted local operators of an all-quad mesh: [C, d, d], or the
    kernel's native [d*d, C] with ``cells_last`` (JAX :383)."""
    if not (mesh.kind == "quad" or mesh.all_quads):
        raise ValueError("fused kernel requires quadrilateral cells")
    lc = fused_local_operator(*pack_inputs(mesh, geom), hdi.cell_degree,
                              hdi.face_degree)
    if cells_last:
        return lc
    d = int(round(lc.shape[0] ** 0.5))
    return lc.reshape(d, d, -1).permute(2, 0, 1)
