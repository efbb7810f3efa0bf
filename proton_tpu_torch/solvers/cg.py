"""Preconditioned conjugate gradient (JAX counterpart:
proton_tpu/solvers/cg.py; reference conjugated_gradient,
solver_cg.hpp:44-144).

The JAX ``lax.while_loop`` becomes a Python loop with the same
recurrences, the same exit tests in the same order (``rel < tol``, then
``it > max_iter``, then divergence) and the same returned iteration
count. The exit test reads the residual norm on the host once per
iteration; the optional residual history (the reference's per-iteration
histfile, solver_cg.hpp:102-103) is written on the device and adds no
read.

Spans (utils/timing.py), into the caller's sink: ``cg_apply`` around
each operator apply, ``cg_precond`` around each preconditioner call (the
first included, so there are as many as iterations), ``cg_wait`` around
the exit test's read, the one place an iteration waits for the device.

Vectors may be a tensor or a NamedTuple of tensors (the face grids);
inner products reduce over all members.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from ..utils.timing import span

CONVERGED = 0
DIVERGED = 1
MAX_ITER_REACHED = 2


@dataclasses.dataclass(frozen=True)
class CGParams:
    """cg_params defaults mirrored from solver_cg.hpp:54-60."""

    convergence_threshold: float = 1e-9
    divergence_threshold: float = 100.0
    max_iter: int = 1000
    apply_preconditioner: bool = False
    record_history: bool = False
    # the reference's progress line every 100 iterations
    # (solver_cg.hpp:96-100), printed from the norm the exit test reads
    verbose: bool = False
    # residual replacement (van der Vorst and Ye): every m iterations the
    # recurred residual is replaced by the true residual b - A x, at the
    # cost of one operator apply. In float32 the recurred residual drifts
    # from the true one on the cond ~ N^2 system and CG stagnates.
    recompute_every: int = 0


class CGResult(NamedTuple):
    x: object
    exit_reason: int
    iterations: int
    rel_residual: float
    # [max_iter + 2] of nr/nr0 on the device, entry i after i iterations,
    # NaN-padded; None unless CGParams.record_history
    history: Optional[torch.Tensor] = None


def _map(fn, *trees):
    if isinstance(trees[0], torch.Tensor):
        return fn(*trees)
    return type(trees[0])(*(fn(*leaves) for leaves in zip(*trees)))


def _leaves(tree):
    return (tree,) if isinstance(tree, torch.Tensor) else tuple(tree)


def _vdot(a, b):
    parts = [torch.sum(x * y) for x, y in zip(_leaves(a), _leaves(b))]
    return sum(parts[1:], parts[0])


def _axpy(alpha, x, y):
    return _map(lambda xa, ya: alpha * xa + ya, x, y)


def conjugated_gradient(apply_A: Callable, b, diag=None,
                        params: CGParams = CGParams(),
                        precond: Optional[Callable] = None,
                        vdot: Optional[Callable] = None, x0=None,
                        nr0=None) -> CGResult:
    """PCG (solver_cg.hpp:63-144), from x0 = 0 unless ``x0`` is given.
    With ``apply_preconditioner`` and no explicit ``precond``, the Jacobi
    preconditioner 1/diag is used (``diag`` required). ``vdot``: the
    inner product, by default the sum over all members; a solve whose
    vectors are split over processes passes one that completes the sum
    across them.

    ``x0``/``nr0`` run one segment of a segmented solve: the first
    residual is the true residual b - A x0, and the exit tests divide by
    the caller's ``nr0`` (a scalar tensor or float, the norm of the whole
    solve's first residual) instead of this segment's."""
    vdot = _vdot if vdot is None else vdot
    if precond is None:
        if params.apply_preconditioner:
            if diag is None:
                raise ValueError("Jacobi preconditioning requires diag(A)")
            inv_diag = _map(lambda dd: 1.0 / dd, diag)

            def precond(r):
                return _map(torch.mul, r, inv_diag)
        else:
            def precond(r):
                return r

    def true_residual(x):
        with span("cg_apply"):
            y = apply_A(x)
        return _map(torch.sub, b, y)

    if x0 is None:
        x, r = _map(torch.zeros_like, b), b
    else:
        x = x0
        r = true_residual(x)
    with span("cg_precond"):
        d = precond(r)
    rho = vdot(r, d)
    nr_init = torch.sqrt(vdot(r, r))
    if nr0 is None:
        nr0 = nr_init
    # the host's copy of nr/nr0, read once per iteration by the exit test
    rel = 1.0 if x0 is None and nr0 is nr_init else None
    hist = None
    if params.record_history:
        hist = torch.full((params.max_iter + 2,), float("nan"),
                          dtype=nr_init.dtype, device=nr_init.device)
        hist[0] = nr_init / nr0
    it, exit_code = 0, -1
    m = params.recompute_every
    while exit_code < 0:
        if params.verbose and it % 100 == 0:
            if rel is None:
                rel = float(nr_init / nr0)
            print(f" -> Iteration {it}, rr = {rel}", flush=True)
        with span("cg_apply"):
            y = apply_A(d)
        alpha = rho / vdot(d, y)
        x = _axpy(alpha, d, x)
        r = _axpy(-alpha, y, r)
        if m and (it + 1) % m == 0:
            r = true_residual(x)
        rel_t = torch.sqrt(vdot(r, r)) / nr0
        if hist is not None:
            hist[min(it + 1, len(hist) - 1)] = rel_t
        with span("cg_wait"):
            rel = float(rel_t)
        if rel < params.convergence_threshold:
            exit_code = CONVERGED
        elif it > params.max_iter:
            exit_code = MAX_ITER_REACHED
        elif rel > params.divergence_threshold:
            exit_code = DIVERGED
        else:
            with span("cg_precond"):
                z = precond(r)
            rho_new = vdot(r, z)
            d = _axpy(rho_new / rho, d, z)
            rho = rho_new
        it += 1
    return CGResult(x, exit_code, it, rel, hist)


def solve_spd_dense(A_dense, b):
    """Small dense SPD direct solve by Cholesky: the stand-in for the
    reference's Eigen::SparseLU path (e.g. cuthho_square.cpp:915-919) on
    problems small enough to densify."""
    L = torch.linalg.cholesky(A_dense)
    if b.ndim == 1:
        return torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.cholesky_solve(b, L)
