"""Level-set functions (JAX counterpart: proton_tpu/cut/levelset.py;
reference circle_level_set / line_level_set, cuthho_square.cpp:56-124).

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


def line_level_set(cut_y: float) -> LevelSet:
    """y - cut_y (cuthho_square.cpp:91-124): negative below the line."""

    def fn(pts):
        return pts[..., 1] - cut_y

    def grad_fn(pts):
        g = torch.zeros_like(pts)
        g[..., 1] = 1.0
        return g

    return LevelSet(fn, grad_fn)


def ellipse_level_set(a: float, b: float, alpha: float,
                      beta: float) -> LevelSet:
    """((x-alpha)/a)^2 + ((y-beta)/b)^2 - 1: negative inside."""

    def fn(pts):
        x = (pts[..., 0] - alpha) / a
        y = (pts[..., 1] - beta) / b
        return x * x + y * y - 1.0

    def grad_fn(pts):
        return torch.stack([2.0 * (pts[..., 0] - alpha) / (a * a),
                            2.0 * (pts[..., 1] - beta) / (b * b)], dim=-1)

    return LevelSet(fn, grad_fn)


def flower_level_set(r0: float, amp: float, k: int, alpha: float,
                     beta: float) -> LevelSet:
    """r - (r0 + amp cos(k theta)): a k-petaled flower, negative inside
    (a smooth non-convex shape); its normal comes from autodiff."""

    def fn(pts):
        x = pts[..., 0] - alpha
        y = pts[..., 1] - beta
        r = torch.sqrt(x * x + y * y)
        th = torch.atan2(y, x)
        return r - (r0 + amp * torch.cos(k * th))

    return LevelSet(fn)
