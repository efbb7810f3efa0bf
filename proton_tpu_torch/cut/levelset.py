"""Level-set functions (JAX counterpart: proton_tpu/cut/levelset.py;
reference circle_level_set, cuthho_square.cpp:56-89).

A level set is a callable pts [..., 2] -> phi [...] on tensors. Without an
analytic gradient the normal comes from ``torch.func.vmap(torch.func.grad)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class LevelSet:
    """phi(pts) with gradient/normal evaluation; ``grad_fn`` is an
    optional analytic gradient pts [..., 2] -> [..., 2]."""

    fn: Callable
    grad_fn: Optional[Callable] = None

    def __call__(self, pts):
        return self.fn(pts)

    def gradient(self, pts):
        if self.grad_fn is not None:
            return self.grad_fn(pts)
        flat = pts.reshape(-1, 2)
        g = torch.func.vmap(torch.func.grad(self.fn))(flat)
        return g.reshape(pts.shape)

    def normal(self, pts):
        """Unit outward (negative -> positive) normal, grad/|grad|
        (cuthho_square.cpp:81-88)."""
        g = self.gradient(pts)
        return g / torch.linalg.vector_norm(g, dim=-1, keepdim=True)


def circle_level_set(radius: float, alpha: float, beta: float) -> LevelSet:
    """(x-a)^2 + (y-b)^2 - r^2 (cuthho_square.cpp:56-89): negative
    inside."""

    def fn(pts):
        x = pts[..., 0] - alpha
        y = pts[..., 1] - beta
        return x * x + y * y - radius * radius

    def grad_fn(pts):
        c = torch.tensor([alpha, beta], dtype=pts.dtype, device=pts.device)
        return 2.0 * (pts - c)

    return LevelSet(fn, grad_fn)
