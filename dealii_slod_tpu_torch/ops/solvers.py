"""Preconditioned CG with deal.II ``ReductionControl`` semantics and dense
SPD direct solves (counterpart of ``dealii_slod_tpu/ops/solvers.py``).
The direct solves are Cholesky solves, also where the reference calls a
general solve on a matrix that is SPD (``dense_dirichlet_solve``).
On the card a caller that solves with one operator again and again can
have CG replay CUDA graphs of its prologue and chunk (``CGGraph``,
engaged by the operator-reuse rule ``GraphPlans``)."""

from __future__ import annotations

import contextlib
import weakref
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


class _CGState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    n_it: torch.Tensor
    done: torch.Tensor
    res0: torch.Tensor
    thr2: torch.Tensor


def _cg_start(matvec, precond, b, x0, tolerance, reduce, group):
    """r = b - A x0, z, rz, the initial residual and the stop threshold."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = precond(r)
    rz = _dot(r, z, group)
    res0 = torch.sqrt(_dot(r, r, group))
    threshold = torch.clamp(reduce * res0, min=tolerance)
    n_it = torch.zeros((), dtype=torch.int64, device=b.device)
    return _CGState(x, r, z, rz, n_it, res0 <= threshold, res0,
                    threshold * threshold)


def _cg_chunk(matvec, precond, st: _CGState, k: int, max_steps: int,
              group) -> _CGState:
    """``k`` latched iterations: once the residual passes the threshold
    (or ``max_steps`` is reached) the rest are masked no-ops."""
    x, r, p, rz, n_it, done, _, thr2 = st
    for _ in range(k):
        active = (~done) & (n_it < max_steps)
        Ap = matvec(p)
        alpha = _safe_div(rz, _dot(p, Ap, group)) * active.to(x.dtype)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = _dot(r, z, group)
        beta = _safe_div(rz_new, rz)
        p = torch.where(active, z + beta * p, p)
        rz = torch.where(active, rz_new, rz)
        n_it = n_it + active.to(n_it.dtype)
        done = done | (_dot(r, r, group) <= thr2)
    return st._replace(x=x, r=r, p=p, rz=rz, n_it=n_it, done=done)


@contextlib.contextmanager
def _side_stream(device):
    """Run the block on a new stream that waits for the current one, and
    make the current one wait for it after."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        yield
    torch.cuda.current_stream(device).wait_stream(side)


def _graph_of(fn: Callable, pool=None):
    """The kernels ``fn()`` enqueues, captured as a CUDA graph (under
    capture nothing runs; ``replay()`` runs them)."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, pool=pool):
        fn()
    return g


class CGGraph:
    """A caller-owned plan that runs ``cg`` as two CUDA graphs: the
    prologue and one chunk of ``check_every`` latched iterations, each
    the same kernels in the same order as the eager code, with the
    results copied into static buffers of the CG state.  The first
    ``cg`` call given the plan captures both graphs; every call replays
    them.  The graphs read the tensors ``matvec`` and ``precond`` held at
    capture at their addresses, and the plan keeps those closures alive:
    the caller gives the plan only to calls on the same operator
    (``GraphPlans``)."""

    def __init__(self):
        self._graphs = None

    @property
    def captured(self) -> bool:
        return self._graphs is not None

    def start(self, start: Callable, chunk: Callable,
              b: torch.Tensor) -> _CGState:
        """The prologue's state for ``b`` (captured on first use)."""
        if self._graphs is None:
            self._capture(start, chunk, b)
        if b.shape != self._b.shape or b.dtype != self._b.dtype:
            raise ValueError("CGGraph: right-hand side of another shape")
        self._b.copy_(b)
        self._graphs[0].replay()
        return self._state

    def chunk(self, st: _CGState) -> _CGState:
        """One chunk, replayed on the static state in place."""
        self._graphs[1].replay()
        return self._state

    def _capture(self, start, chunk, b):
        # the static buffers: the input and a copy of the state, none
        # sharing storage (the prologue's p is its z)
        self._b = b.clone()
        self._state = _CGState(*(t.clone() for t in start(self._b)))
        # a warm-up outside capture, where libraries' workspaces and lazy
        # set-up happen, on a side stream as capture wants
        with _side_stream(b.device):
            chunk(start(self._b))

        def write(out):
            for s, o in zip(self._state, out):
                if o is not s:
                    s.copy_(o)

        pro = _graph_of(lambda: write(start(self._b)))
        body = _graph_of(lambda: write(chunk(self._state)), pro.pool())
        self._graphs = (pro, body)
        self._keep = (start, chunk)


class GraphPlans:
    """The operator-reuse rule for ``CGGraph``: ``plan(op, *extra)`` is
    None at the first sight of an operator (the call runs eagerly and the
    operator is remembered), a new plan at the second (``cg`` captures),
    and that same plan at every later sight (``cg`` replays).  An
    operator is the same tensor object at the same storage, version
    (``_version``: an in-place change makes a new operator), shape,
    strides, dtype and device, with the same ``extra``.  Only the newest
    operator's plan is kept; once captured, it keeps that operator alive
    until another operator replaces it."""

    def __init__(self):
        self._op = self._key = self._plan = None

    def plan(self, op: torch.Tensor, *extra) -> Optional[CGGraph]:
        key = (op.data_ptr(), op._version, tuple(op.shape), op.stride(),
               op.dtype, op.device, extra)
        if self._op is None or self._op() is not op or self._key != key:
            self._op, self._key, self._plan = weakref.ref(op), key, None
            return None
        if self._plan is None:
            self._plan = CGGraph()
        return self._plan


def cg(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       max_steps: int = 1000, tolerance: float = 1e-10, reduce: float = 1e-2,
       precond: Optional[Callable] = None, check_every: int = 8,
       group=None, graph: Optional[CGGraph] = None) -> CGResult:
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

    ``graph`` (a ``CGGraph``, CUDA tensors, no ``group``): the prologue
    and each chunk are replays of its graphs, captured at its first use
    with this call's ``matvec`` and ``precond``; the stop test between
    chunks is the same.  The result's tensors are copies, never the
    plan's buffers.

    Under a profiler (``utils/timers``) a call counts ``cg.iterations``
    (``n_iter``, the device scalar), ``cg.enqueued`` (iterations issued,
    the masked no-ops included), ``cg.graph_iterations`` (those issued
    through a graph's replay, where a plan is given) and ``host_syncs``
    (its stop tests)."""
    if precond is None:
        precond = lambda r: r                                    # noqa: E731
    k = max(1, check_every)

    def start(b):
        return _cg_start(matvec, precond, b, x0, tolerance, reduce, group)

    def chunk(st):
        return _cg_chunk(matvec, precond, st, k, max_steps, group)

    if graph is None:
        st = start(b)
    else:
        if group is not None or x0 is not None:
            raise ValueError("cg: a graph plan takes no group and no x0")
        st, chunk = graph.start(start, chunk, b), graph.chunk
    enqueued = syncs = 0
    for _ in range(-(-max_steps // k)):
        syncs += 1
        if bool(st.done | (st.n_it >= max_steps)):
            break
        enqueued += k
        st = chunk(st)
    if graph is not None:
        st = _CGState(*(t.clone() for t in st))
        count("cg.graph_iterations", enqueued)
    count("cg.iterations", st.n_it)
    count("cg.enqueued", enqueued)
    count("host_syncs", syncs)
    return CGResult(st.x, st.n_it, torch.sqrt(_dot(st.r, st.r, group)),
                    st.res0, st.done)


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
