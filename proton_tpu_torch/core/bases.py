"""Batched scaled-monomial bases (JAX counterpart:
proton_tpu/core/bases.py; reference bases.hpp:70-291).

Cell basis: monomials ordered by total degree k then i,
phi_(k,i) = bx^(k-i) * by^i with b = (p - barycenter) / (h/2). The ordering
is hierarchical: the first size(celdeg) entries of a reconstruction-degree
basis are the cell-degree basis.

Face basis: 1D monomials in ep = 4 (v . (p - face_bar)) / h^2 with
v = face_bar - p0.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


def cell_basis_size(degree: int) -> int:
    """(deg+1)(deg+2)/2 (bases.hpp:90,191-194)."""
    return (degree + 1) * (degree + 2) // 2


def face_basis_size(degree: int) -> int:
    """deg + 1 (bases.hpp:258,287-290)."""
    return degree + 1


@lru_cache(maxsize=None)
def _exponent_tables(degree: int) -> Tuple[np.ndarray, np.ndarray]:
    """PX[b], PY[b]: x/y exponents of basis entry b, ordered by total
    degree (bases.hpp:114-127)."""
    px, py = [], []
    for k in range(degree + 1):
        for i in range(k + 1):
            px.append(k - i)
            py.append(i)
    return np.array(px, dtype=np.int32), np.array(py, dtype=np.int32)


def _powers(x: torch.Tensor, max_pow: int) -> torch.Tensor:
    """[..., max_pow+1] tensor of x^0 .. x^max_pow via cumulative product."""
    ones = torch.ones_like(x[..., None])
    if max_pow == 0:
        return ones
    reps = torch.cumprod(x[..., None].expand(*x.shape, max_pow), dim=-1)
    return torch.cat([ones, reps], dim=-1)


def _index(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(a.astype(np.int64), device=device)


def eval_cell_basis(pts, bar, h, degree: int) -> torch.Tensor:
    """phi [..., B] at pts [..., 2]; bar [..., 2] and h [...] broadcast
    against the leading dims of pts (bases.hpp:93-133)."""
    px, py = _exponent_tables(degree)
    b = (pts - bar) / (0.5 * h[..., None])
    powx = _powers(b[..., 0], degree)
    powy = _powers(b[..., 1], degree)
    return powx[..., _index(px, pts.device)] * powy[..., _index(py, pts.device)]


def eval_cell_gradients(pts, bar, h, degree: int) -> torch.Tensor:
    """dphi [..., B, 2] (bases.hpp:135-184)."""
    px, py = _exponent_tables(degree)
    dev = pts.device
    b = (pts - bar) / (0.5 * h[..., None])
    ih = 2.0 / h
    powx = _powers(b[..., 0], degree)
    powy = _powers(b[..., 1], degree)
    fx = powx[..., _index(px, dev)]
    fy = powy[..., _index(py, dev)]
    pxm1 = _index(np.maximum(px - 1, 0), dev)
    pym1 = _index(np.maximum(py - 1, 0), dev)
    fpx = torch.as_tensor(px, dtype=pts.dtype, device=dev)
    fpy = torch.as_tensor(py, dtype=pts.dtype, device=dev)
    zero = torch.zeros((), dtype=pts.dtype, device=dev)
    dx = torch.where(fpx > 0, fpx * powx[..., pxm1], zero) * ih[..., None]
    dy = torch.where(fpy > 0, fpy * powy[..., pym1], zero) * ih[..., None]
    return torch.stack([dx * fy, fx * dy], dim=-1)


def eval_face_basis(pts, face_bar, face_base, face_h, degree: int):
    """phi [..., deg+1] at pts [..., 2] on faces described by barycenter,
    base vector (bar - p0) and length (bases.hpp:264-280)."""
    t = pts - face_bar
    dot = torch.sum(face_base * t, dim=-1)
    ep = 4.0 * dot / (face_h * face_h)
    return _powers(ep, degree)
