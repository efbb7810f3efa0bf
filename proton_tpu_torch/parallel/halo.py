"""Row-halo variant of the structured face-grid solve on torch.distributed
(JAX counterpart: proton_tpu/parallel/halo.py).

The condensed Schur operator of the generated mesh is a stencil on the
H/V face grids (methods/structured.py). Across ranks it splits by cell
rows: each rank owns a slab of ``Ny / world_size`` cell rows, their
condensed blocks and the face rows beneath them. The only coupling
between slabs is one H row, a 1-deep halo: one ``batch_isend_irecv``
pair per direction and apply, the next rank's first H row down for the
gather and this rank's last partial top row up for the scatter. CG's dot
products are completed by ``all_reduce``. One rank has no neighbour and
exchanges nothing.

The global top H row (index Ny) is Dirichlet-frozen on the generated box
(basic_mesh.hpp:293-297), so the iterate drops it: both grids then have
Ny rows and split evenly. A rank's H slab holds the bottom faces of its
cells; the top faces of its last cell row are the next rank's first row,
or the dropped frozen row on the last rank.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from ..core.ops import cho_solve_batched
from ..methods import structured
from ..methods.condensation import CondensedSystem
from ..solvers import cg
from .sharding import DeviceMesh, _slab


class HaloGridVec(NamedTuple):
    """Face-grid iterate without the frozen top H row, coefficient axis
    last; on a rank, its slab of rows."""

    H: torch.Tensor   # [Ny, Nx, fbs]   bottom faces of each cell row
    V: torch.Tensor   # [Ny, Nx+1, fbs]


def to_halo(x: structured.GridVec) -> HaloGridVec:
    """Drop the frozen top H row (zero in a masked iterate)."""
    return HaloGridVec(x.H[:-1], x.V)


def from_halo(x: HaloGridVec) -> structured.GridVec:
    """Append the frozen top H row as zeros."""
    return structured.GridVec(torch.cat([x.H, torch.zeros_like(x.H[:1])]),
                              x.V)


def _halo_masks(dmesh: DeviceMesh, sys: structured.StructuredFaceSystem):
    """This rank's rows of freeH (without the top row) and freeV."""
    rows = _slab(dmesh, sys.Ny)
    return (sys.freeH[:-1][rows].to(dmesh.device),
            sys.freeV[rows].to(dmesh.device))


def _local_blocks(dmesh: DeviceMesh, sys: structured.StructuredFaceSystem,
                  S):
    """This rank's cell blocks of S: S is either every cell's [Nx*Ny, nfd,
    nfd], row-major (j * Nx + i), or already the rank's slab."""
    if S.shape[0] == sys.Nx * sys.Ny:
        rows = _slab(dmesh, sys.Ny)
        S = S[rows.start * sys.Nx:rows.stop * sys.Nx]
    elif S.shape[0] * dmesh.world_size != sys.Nx * sys.Ny:
        raise ValueError(f"S has {S.shape[0]} cells: neither the grid's "
                         f"{sys.Nx * sys.Ny} nor one rank's share")
    return S.to(dmesh.device)


def shard_system(dmesh: DeviceMesh, sys: structured.StructuredFaceSystem,
                 S, x: HaloGridVec):
    """(this rank's blocks of S [C, nfd, nfd], its rows of x) on its
    device. Cells are row-major, so a slab of cells is a slab of rows."""
    rows = _slab(dmesh, sys.Ny)
    return (_local_blocks(dmesh, sys, S),
            HaloGridVec(x.H[rows].to(dmesh.device),
                        x.V[rows].to(dmesh.device)))


def _shift(dmesh: DeviceMesh, t, step: int):
    """The ``t`` of rank r - step, arriving at rank r (one send and one
    receive in one batch_isend_irecv); zeros where no rank sends."""
    t = t.contiguous()
    out = torch.zeros_like(t)
    dst, src = dmesh.rank + step, dmesh.rank - step
    ops = []
    if 0 <= dst < dmesh.world_size:
        ops.append(dist.P2POp(dist.isend, t, dst))
    if 0 <= src < dmesh.world_size:
        ops.append(dist.P2POp(dist.irecv, out, src))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def _scatter_rows(dmesh: DeviceMesh, c):
    """Face grids of this rank's slab from per-cell slot values c [Nb, Nx,
    4, B]: bottom values on their own row, top values one row up, the
    last row's to the next rank's first row."""
    H = c[:, :, 0].clone()
    H[1:] += c[:-1, :, 2]
    H[0] += _shift(dmesh, c[-1, :, 2], 1)
    Nb, Nx = c.shape[0], c.shape[1]
    V = c.new_zeros((Nb, Nx + 1) + tuple(c.shape[3:]))
    V[:, :-1] = c[:, :, 3]
    V[:, 1:] += c[:, :, 1]
    return H, V


def make_halo_operator(dmesh: DeviceMesh,
                       sys: structured.StructuredFaceSystem, S):
    """x -> A x on this rank's rows of a HaloGridVec, the halo exchanged
    inside. S: every cell's blocks or this rank's (shard_system)."""
    if sys.Ny % dmesh.world_size:
        raise ValueError(f"Ny={sys.Ny} does not split over "
                         f"{dmesh.world_size} ranks")
    Sb = _local_blocks(dmesh, sys, S)
    fH, fV = (m[..., None] for m in _halo_masks(dmesh, sys))
    nfd = 4 * sys.fbs

    def apply_S(x: HaloGridVec) -> HaloGridVec:
        xH, xV = x.H * fH, x.V * fV
        # the top faces of the last cell row: the next rank's first row
        top = torch.cat([xH[1:], _shift(dmesh, xH[0], -1)[None]])
        loc = torch.stack([xH, xV[:, 1:], top, xV[:, :-1]], dim=2)
        Nb, Nx = loc.shape[0], loc.shape[1]
        c = torch.bmm(Sb, loc.reshape(Nb * Nx, nfd, 1))
        H, V = _scatter_rows(dmesh, c.reshape(Nb, Nx, 4, sys.fbs))
        # masks, and the identity on frozen faces (keeps A SPD)
        return HaloGridVec(torch.where(fH, H, x.H), torch.where(fV, V, x.V))

    return apply_S


def halo_diagonal(dmesh: DeviceMesh, sys: structured.StructuredFaceSystem,
                  S) -> HaloGridVec:
    """This rank's rows of the Jacobi diagonal (structured_diagonal); the
    one row shared with the previous rank is summed through the halo."""
    Sb = _local_blocks(dmesh, sys, S)
    fH, fV = (m[..., None] for m in _halo_masks(dmesh, sys))
    dl = torch.diagonal(Sb, dim1=1, dim2=2)
    H, V = _scatter_rows(dmesh, dl.reshape(fH.shape[0], sys.Nx, 4, sys.fbs))
    one = torch.ones((), dtype=H.dtype, device=H.device)
    return HaloGridVec(torch.where(fH, H, one), torch.where(fV, V, one))


def _all_vdot(dmesh: DeviceMesh):
    """CG's inner product over the ranks' slabs: local sums, then one
    all_reduce."""
    def vdot(a, b):
        s = sum(torch.sum(x * y) for x, y in zip(a, b)).reshape(1)
        dist.all_reduce(s)
        return s[0]
    return vdot


def _all_rows(dmesh: DeviceMesh, t):
    """Every rank's rows of t, stacked in rank order, on every rank."""
    if dmesh.world_size == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(dmesh.world_size)]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts)


def solve_condensed_halo(dmesh: DeviceMesh,
                         sys: structured.StructuredFaceSystem,
                         cond: CondensedSystem, g_loc=None,
                         cbs: Optional[int] = None,
                         cg_params: cg.CGParams = structured.DEFAULT_CG
                         ) -> Tuple[torch.Tensor, cg.CGResult]:
    """Row-sharded twin of structured.solve_condensed_structured on the
    condensed system ``cond`` (every rank passes the whole of it): the
    same Jacobi PCG, the operator's stencil exchanged through the halo.
    Returns (local [C, d], CGResult with x the whole HaloGridVec), the
    same on every rank."""
    rhs = to_halo(structured.structured_rhs(sys, cond, g_loc, cbs))
    S, rhs = shard_system(dmesh, sys, cond.S, rhs)
    res = cg.conjugated_gradient(make_halo_operator(dmesh, sys, S), rhs,
                                 halo_diagonal(dmesh, sys, S), cg_params,
                                 vdot=_all_vdot(dmesh))
    x = HaloGridVec(_all_rows(dmesh, res.x.H), _all_rows(dmesh, res.x.V))
    xm = HaloGridVec(x.H * sys.freeH[:-1, :, None].to(x.H.device),
                     x.V * sys.freeV[..., None].to(x.V.device))
    uF = structured.grid_gather(sys, from_halo(xm))
    if g_loc is not None:
        uF = uF + g_loc[:, cbs:].to(uF.device)
    rhs_T = cond.fT.to(uF.device) - torch.bmm(cond.ATF.to(uF.device),
                                              uF[..., None])[..., 0]
    uT = cho_solve_batched(cond.ATT.to(uF.device), rhs_T[..., None])[..., 0]
    return torch.cat([uT, uF], dim=1), res._replace(x=x)
