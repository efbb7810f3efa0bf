"""Face-grid layout of the condensed system on the generated mesh (JAX
counterpart: proton_tpu/methods/structured.py).

Face unknowns are renumbered as grids, H [Ny+1, Nx] horizontal faces and
V [Ny, Nx+1] vertical faces, so gathering a cell's faces is slicing. Cell
local edge order is (bottom, right, top, left): slot0 = H[j, i],
slot1 = V[j, i+1], slot2 = H[j+1, i], slot3 = V[j, i]. Dirichlet faces
stay in the grids, frozen (masked, unit diagonal).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class StructuredFaceSystem(NamedTuple):
    Nx: int
    Ny: int
    fbs: int
    freeH: torch.Tensor   # [Ny+1, Nx] bool, False on Dirichlet faces
    freeV: torch.Tensor   # [Ny, Nx+1] bool


def make_structured_system(Nx: int, Ny: int, fbs: int, *,
                           device) -> StructuredFaceSystem:
    """Boundary faces of the generated box are Dirichlet
    (basic_mesh.hpp:293-297): first/last H rows and V columns."""
    freeH = torch.ones((Ny + 1, Nx), dtype=torch.bool, device=device)
    freeH[0, :] = False
    freeH[Ny, :] = False
    freeV = torch.ones((Ny, Nx + 1), dtype=torch.bool, device=device)
    freeV[:, 0] = False
    freeV[:, Nx] = False
    return StructuredFaceSystem(Nx, Ny, fbs, freeH, freeV)
