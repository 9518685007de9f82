"""Preconditioned CG with deal.II ``ReductionControl`` semantics and dense
SPD direct solves (counterpart of ``dealii_slod_tpu/ops/solvers.py``).
The direct solves are Cholesky solves, also where the reference calls a
general solve on a matrix that is SPD (``dense_dirichlet_solve``)."""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from dealii_slod_tpu_torch.utils.timers import count


class CGResult(NamedTuple):
    x: torch.Tensor
    n_iter: torch.Tensor
    residual: torch.Tensor
    initial_residual: torch.Tensor
    converged: torch.Tensor


def _dot(a: torch.Tensor, c: torch.Tensor, group=None) -> torch.Tensor:
    """a . c, summed over the ranks of ``group`` when one is given (each
    rank holds its rows of a and c)."""
    d = torch.dot(a.reshape(-1), c.reshape(-1))
    if group is not None:
        dist.all_reduce(d, group=group)
    return d


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return torch.where(den != 0, num / torch.where(den == 0, 1.0, den), 0.0)


def cg(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       max_steps: int = 1000, tolerance: float = 1e-10, reduce: float = 1e-2,
       precond: Optional[Callable] = None, check_every: int = 8,
       group=None) -> CGResult:
    """Stop when the residual norm falls below ``tolerance`` OR below
    ``reduce * initial_residual`` OR after ``max_steps`` iterations.

    The host reads the stopping state only every ``check_every``
    iterations (one device sync per chunk).  Inside a chunk every
    iteration carries a convergence latch, and once the residual passes
    the threshold the remaining iterations are masked no-ops — so ``x``,
    the exact deal.II iteration count ``n_iter`` and ``converged`` are
    those of a per-iteration stop.

    ``group`` (a ``torch.distributed`` process group; the counterpart of
    the reference's ``psum_axis``): ``b``, ``x`` and the vectors are the
    rank's rows, ``matvec`` maps the rank's rows to the rank's rows (it
    gathers what it needs itself), and every dot product is summed over
    the group.  The host's stop test reads only those sums, so every rank
    leaves the loop at the same chunk and none waits in a collective.

    Under a profiler (``utils/timers``) a call counts ``cg.iterations``
    (``n_iter``, the device scalar), ``cg.enqueued`` (iterations issued,
    the masked no-ops included) and ``host_syncs`` (its stop tests)."""
    x = torch.zeros_like(b) if x0 is None else x0
    if precond is None:
        precond = lambda r: r                                    # noqa: E731
    r = b - matvec(x)
    z = precond(r)
    rz = _dot(r, z, group)
    res0 = torch.sqrt(_dot(r, r, group))
    threshold = torch.clamp(reduce * res0, min=tolerance)
    thr2 = threshold * threshold
    p = z
    n_it = torch.zeros((), dtype=torch.int64, device=b.device)
    done = res0 <= threshold
    k = max(1, check_every)
    enqueued = syncs = 0
    for _ in range(-(-max_steps // k)):
        syncs += 1
        if bool(done | (n_it >= max_steps)):
            break
        enqueued += k
        for _ in range(k):
            active = (~done) & (n_it < max_steps)
            Ap = matvec(p)
            alpha = _safe_div(rz, _dot(p, Ap, group)) * active.to(b.dtype)
            x = x + alpha * p
            r = r - alpha * Ap
            z = precond(r)
            rz_new = _dot(r, z, group)
            beta = _safe_div(rz_new, rz)
            p = torch.where(active, z + beta * p, p)
            rz = torch.where(active, rz_new, rz)
            n_it = n_it + active.to(n_it.dtype)
            done = done | (_dot(r, r, group) <= thr2)
    count("cg.iterations", n_it)
    count("cg.enqueued", enqueued)
    count("host_syncs", syncs)
    return CGResult(x, n_it, torch.sqrt(_dot(r, r, group)), res0, done)


def cholesky_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve A X = B given the Cholesky factor L of A (batched, multi-RHS):
    (..., n, n) x (..., n, k) -> (..., n, k)."""
    Y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.mT, Y, upper=True)


def spd_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Direct SPD solve (batched, multi-RHS)."""
    return cholesky_solve(torch.linalg.cholesky(A), B)


def dense_dirichlet_solve(A: torch.Tensor, b: torch.Tensor,
                          constrained: torch.Tensor,
                          values: torch.Tensor) -> torch.Tensor:
    """Solve a dense system with Dirichlet constraints by row / column
    projection: the constrained dofs' rows and columns become identity and
    their values are lifted into the right-hand side (the coarse-FEM
    comparison solve, reference SolverDirect).  The projected matrix is
    SPD, so the solve is a Cholesky solve."""
    mask = constrained.to(A.dtype)
    keep = 1.0 - mask
    A_bc = A * (keep[:, None] * keep[None, :]) + torch.diag(mask)
    b_bc = keep * (b - (A * mask[None, :]) @ values) + mask * values
    return spd_solve(A_bc, b_bc[:, None])[:, 0]
