"""The coarse CG's CUDA-graph plan (``ops/solvers.py: CGGraph``,
``GraphPlans``; ``models/coarse.py: CoarseSystem.plan``) on the CPU: the
operator-reuse rule that decides when a plan engages, the coarse system's
rule (the card's single-rank stencil route only), a CPU solve that never
captures and equals the eager CG, the stencil tables uploaded once, and
the plan's static buffers driven through stand-in graphs that run the
captured code on each replay (the card's own capture:
``tests/test_torch_cuda.py``).  Tiny 2D configurations; ~5 s on one
worker."""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import dealii_slod_tpu_torch as pt
from dealii_slod_tpu_torch.models.coarse import CoarseSystem
from dealii_slod_tpu_torch.ops import solvers
from dealii_slod_tpu_torch.ops.solvers import CGGraph, GraphPlans, cg
from dealii_slod_tpu_torch.utils import timers

torch.set_num_threads(2)

CUDA = torch.device("cuda")


@contextlib.contextmanager
def traced():
    timers.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        yield


@pytest.fixture(scope="module")
def stencil_solver():
    """2D refine-2 l=2, float64, on the stencil-matvec route
    (``coarse_dense_cap`` below the 16 coarse dofs), its basis and coarse
    operator built."""
    cfg = pt.SLODConfig(dim=2, n_global_refinements=2, oversampling=2,
                        lod_stabilization=True, constant_coefficients=False,
                        coef_seed=3, patch_chunk=16, eig_solver="smallk",
                        coarse_dense_cap=8,
                        coarse_solver=pt.ReductionControl(500, 1e-10, 1e-10))
    s = pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device="cpu",
                     verbose=False)
    s.assemble_fine_rhs()
    s.compute_basis()
    s.assemble_coarse_operator()
    return s


def eager(s, A_st, b):
    """The coarse CG as ``CoarseSystem.cg`` runs it, without a plan."""
    diag = torch.einsum("pdd->pd", A_st[:, s.center_offset_idx])
    rc = s.cfg.coarse_solver
    return cg(CoarseSystem(s, A_st).matvec, b, max_steps=rc.max_steps,
              tolerance=rc.tolerance, reduce=rc.reduce,
              precond=lambda r: r / diag)


def test_plan_key_rule():
    """First sight of an operator: None (eager); second: a plan (capture);
    later: the same plan (replay).  A new tensor, another tensor object on
    the same storage, an in-place change (``_version``) or other ``extra``
    is a first sight, and drops the old plan."""
    plans = GraphPlans()
    A = torch.ones(4, 3)
    assert plans.plan(A) is None
    p = plans.plan(A)
    assert isinstance(p, CGGraph) and not p.captured
    assert plans.plan(A) is p and plans.plan(A) is p
    A.add_(0.0)                                     # in place: _version
    assert plans.plan(A) is None
    p2 = plans.plan(A)
    assert p2 is not None and p2 is not p
    for other in (A.clone(), A.view_as(A)):
        assert plans.plan(other) is None
        assert plans.plan(A) is None                # the other was newest
        assert plans.plan(A) is not None
    assert plans.plan(A, (0, 2)) is None            # other rows
    assert plans.plan(A, (0, 2)) is not None
    assert plans.plan(A.to(torch.float64)) is None  # other dtype


def test_solver_rule_engages_only_on_the_cards_single_rank_stencil_route(
        stencil_solver, monkeypatch):
    """``CoarseSystem.plan``: the key rule on the card's single-rank
    stencil route, the stopping rule part of the key; None on the CPU,
    under a process group and on the dense route."""
    s = stencil_solver
    A = s.A_stencil.clone()
    s._graph_plans = GraphPlans()
    cpu = CoarseSystem(s, A)
    monkeypatch.setattr(s, "device", CUDA)
    ranks = CoarseSystem(s, A, group=object())
    for _ in range(3):
        assert not cpu.graphs and cpu.plan() is None
        assert not ranks.graphs and ranks.plan() is None
    card = CoarseSystem(s, A)
    assert card.graphs and card.plan() is None
    plan = card.plan()
    assert plan is not None and CoarseSystem(s, A).plan() is plan
    rc = s.cfg.coarse_solver                        # another stopping rule
    s.cfg.coarse_solver = pt.ReductionControl(500, 1e-8, 1e-8)
    try:
        assert card.plan() is None
        assert card.plan() is not None
    finally:
        s.cfg.coarse_solver = rc
    assert card.plan() is None
    cap = s.cfg.coarse_dense_cap
    s.cfg.coarse_dense_cap = 8192                   # the dense route
    try:
        dense = CoarseSystem(s, A)
        assert not dense.graphs and dense.plan() is None
    finally:
        s.cfg.coarse_dense_cap = cap
        s._graph_plans = GraphPlans()


def test_cpu_solves_never_capture_and_equal_eager(stencil_solver):
    """Three coarse solves on one operator on the CPU: no plan is made, no
    iteration counts as a graph's, and each answer equals the eager CG's
    bit for bit."""
    s = stencil_solver
    rng = np.random.default_rng(0)
    A = s.A_stencil
    for _ in range(3):
        b = torch.from_numpy(rng.standard_normal((s.topo.n_patches, s.C)))
        with traced():
            res = CoarseSystem(s, A).cg(b)
        assert "cg.graph_iterations" not in timers.counters()
        ref = eager(s, A, b)
        assert torch.equal(res.x, ref.x)
        assert int(res.n_iter) == int(ref.n_iter) > 0
    assert s._graph_plans._plan is None
    timers.clear()


def test_stencil_tables_upload_once(stencil_solver):
    """Two coarse solves on the stencil route, each by its own coarse
    system, count the tables' bytes in ``h2d_bytes`` once; the tables are
    kept on the solver."""
    s = stencil_solver
    s._gather = None
    b = CoarseSystem(s, s.A_stencil).rhs(s.Phi, s.fem_rhs)
    with traced():
        CoarseSystem(s, s.A_stencil).cg(b)
        CoarseSystem(s, s.A_stencil).cg(b)
    nbytes = (s.stencil_nbr_np.astype(np.int64).nbytes
              + s.stencil_valid_np.astype(bool).nbytes)
    assert timers.counters()["h2d_bytes"] == {"cg": nbytes}
    nbr, valid = s._gather
    assert nbr.dtype == torch.int64 and valid.dtype == torch.bool
    assert np.array_equal(nbr.numpy(), s.stencil_nbr_np)
    timers.clear()


class ReplayedCode:
    """A stand-in for a captured graph: capture runs nothing, each replay
    runs the captured code again."""

    def __init__(self, fn, pool=None):
        self.fn = fn

    def replay(self):
        self.fn()

    def pool(self):
        return None


@pytest.fixture
def stand_in_graphs(monkeypatch):
    monkeypatch.setattr(solvers, "_graph_of", ReplayedCode)
    monkeypatch.setattr(solvers, "_side_stream",
                        lambda device: contextlib.nullcontext())


@pytest.mark.parametrize("jacobi", [True, False])
def test_plan_buffers_through_stand_in_graphs(stand_in_graphs, jacobi):
    """``cg`` with a plan, the graphs replaced by code run on each replay:
    the first call captures, every answer equals the eager CG's bit for
    bit, answers are copies (distinct from each other and from the plan's
    buffers), and each call counts its chunks' iterations as a graph's.
    Without a preconditioner the prologue's p is its r, which the static
    buffers must not share."""
    rng = np.random.default_rng(1)
    M = rng.standard_normal((40, 40))
    A = torch.from_numpy(M @ M.T / 40 + np.eye(40))
    d = torch.diagonal(A).clone()
    kw = dict(max_steps=200, tolerance=1e-12, reduce=1e-12,
              precond=(lambda r: r / d) if jacobi else None)
    mv = lambda u: A @ u                                     # noqa: E731
    plan = CGGraph()
    out = []
    for i in range(3):
        b = torch.from_numpy(rng.standard_normal(40))
        with traced():
            res = cg(mv, b, graph=plan, **kw)
        c = timers.counters()
        ref = cg(mv, b, **kw)
        assert plan.captured
        assert torch.equal(res.x, ref.x)
        assert torch.equal(res.n_iter, ref.n_iter) and int(res.n_iter) > 8
        assert torch.equal(res.residual, ref.residual)
        assert torch.equal(res.initial_residual, ref.initial_residual)
        assert bool(res.converged)
        assert sum(c["cg.graph_iterations"].values()) == sum(
            c["cg.enqueued"].values()) == 8 * -(-int(ref.n_iter) // 8)
        statics = {t.data_ptr() for t in plan._state}
        assert len(statics) == len(plan._state)
        assert not statics & {t.data_ptr() for t in res}
        out.append(res.x)
    assert len({x.data_ptr() for x in out}) == 3
    assert not torch.equal(out[0], out[1])
    timers.clear()


def test_plan_refuses_another_shape_group_or_start(stand_in_graphs):
    """A plan serves one right-hand side's shape, no process group and no
    start vector."""
    A = torch.eye(6, dtype=torch.float64) * 2
    mv = lambda u: A @ u                                     # noqa: E731
    plan = CGGraph()
    cg(mv, torch.ones(6, dtype=torch.float64), graph=plan)
    with pytest.raises(ValueError):
        cg(mv, torch.ones(5, dtype=torch.float64), graph=plan)
    with pytest.raises(ValueError):
        cg(mv, torch.ones(6, dtype=torch.float64), graph=plan,
           group=object())
    with pytest.raises(ValueError):
        cg(mv, torch.ones(6, dtype=torch.float64), graph=plan,
           x0=torch.zeros(6, dtype=torch.float64))
