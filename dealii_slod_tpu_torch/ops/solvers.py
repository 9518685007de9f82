"""Preconditioned CG with deal.II ``ReductionControl`` semantics
(counterpart of ``dealii_slod_tpu/ops/solvers.py: cg``)."""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class CGResult(NamedTuple):
    x: torch.Tensor
    n_iter: torch.Tensor
    residual: torch.Tensor
    initial_residual: torch.Tensor
    converged: torch.Tensor


def _dot(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), c.reshape(-1))


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return torch.where(den != 0, num / torch.where(den == 0, 1.0, den), 0.0)


def cg(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       max_steps: int = 1000, tolerance: float = 1e-10, reduce: float = 1e-2,
       precond: Optional[Callable] = None, check_every: int = 8) -> CGResult:
    """Stop when the residual norm falls below ``tolerance`` OR below
    ``reduce * initial_residual`` OR after ``max_steps`` iterations.

    The host reads the stopping state only every ``check_every``
    iterations (one device sync per chunk).  Inside a chunk every
    iteration carries a convergence latch, and once the residual passes
    the threshold the remaining iterations are masked no-ops — so ``x``,
    the exact deal.II iteration count ``n_iter`` and ``converged`` are
    those of a per-iteration stop."""
    x = torch.zeros_like(b) if x0 is None else x0
    if precond is None:
        precond = lambda r: r                                    # noqa: E731
    r = b - matvec(x)
    z = precond(r)
    rz = _dot(r, z)
    res0 = torch.sqrt(_dot(r, r))
    threshold = torch.clamp(reduce * res0, min=tolerance)
    thr2 = threshold * threshold
    p = z
    n_it = torch.zeros((), dtype=torch.int64, device=b.device)
    done = res0 <= threshold
    k = max(1, check_every)
    for _ in range(-(-max_steps // k)):
        if bool(done | (n_it >= max_steps)):
            break
        for _ in range(k):
            active = (~done) & (n_it < max_steps)
            Ap = matvec(p)
            alpha = _safe_div(rz, _dot(p, Ap)) * active.to(b.dtype)
            x = x + alpha * p
            r = r - alpha * Ap
            z = precond(r)
            rz_new = _dot(r, z)
            beta = _safe_div(rz_new, rz)
            p = torch.where(active, z + beta * p, p)
            rz = torch.where(active, rz_new, rz)
            n_it = n_it + active.to(n_it.dtype)
            done = done | (_dot(r, r) <= thr2)
    return CGResult(x, n_it, torch.sqrt(_dot(r, r)), res0, done)
