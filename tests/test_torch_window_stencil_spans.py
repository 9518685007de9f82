"""The spans and counters of the per-chunk coefficient windows and of the
chunked stencil builds (``dealii_slod_tpu_torch/utils/timers.py``), on the
CPU under a ``torch.profiler`` session: ``windows`` nests under
``assemble`` on the per-chunk window route only and ``window_bytes``
counts the windows cut; each chunk of the cells build and each pair of
plane ranges of the planes build is one ``stencil_chunk`` span under
``coarse_op`` and one ``stencil.chunks`` count, as many as the byte rule's
plan gives; without a profiler nothing is recorded and the answers are
bitwise those of a traced step.  Tiny 2D configurations; ~5 s on one
worker."""

import pytest
import torch
from test_torch_trace import traced, tree

import dealii_slod_tpu_torch as pt
from dealii_slod_tpu_torch.models import basis, stencil
from dealii_slod_tpu_torch.utils import timers

torch.set_num_threads(2)


def solver(**kw):
    """2D, 8 x 8 coarse cells, l = 2, chunks of 16 patches (two x-rows)."""
    cfg = pt.SLODConfig(**{**dict(
        dim=2, n_global_refinements=3, oversampling=2,
        lod_stabilization=True, constant_coefficients=False, coef_seed=5,
        patch_chunk=16, eig_solver="smallk",
        coarse_solver=pt.ReductionControl(500, 1e-10, 1e-10)), **kw})
    s = pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device="cpu",
                     verbose=False)
    s.assemble_fine_rhs()
    return s


def n_chunks(s):
    return s.topo.n_patches // s.cfg.patch_chunk


def test_windows_span_on_the_chunk_route():
    """``window_chunk="on"``: the lattice build and each chunk's cut are
    ``windows`` spans inside ``assemble``, and ``window_bytes`` is the
    bytes of every patch's window, which the whole-window route would
    have cut at once."""
    s = solver(window_chunk="on")
    with traced():
        s.compute_basis(s.coef_q)
    t = tree(timers.records())
    assert t["basis/assemble/windows"] == 1 + n_chunks(s)
    assert not any(k.endswith("windows") and k != "basis/assemble/windows"
                   for k in t)
    whole = basis.coef_windows(s.cfg, s.grid, s.coef_q["alpha"])
    assert timers.counters()["window_bytes"] == {"windows": whole.nbytes}
    timers.clear()


def test_no_windows_span_on_the_whole_window_route():
    """``window_chunk="off"`` (and "auto" at this size): the whole windows
    are cut once in ``assemble``; no ``windows`` span, no count."""
    for mode in ("off", "auto"):
        s = solver(window_chunk=mode)
        with traced():
            s.compute_basis(s.coef_q)
        assert not any(r.name == "windows" for r in timers.records())
        assert "window_bytes" not in timers.counters()
        assert any(r.name == "assemble" for r in timers.records())
    timers.clear()


def expected_chunks(s, plan):
    """The chunks the build runs for ``plan``: K-chunks of ceil(K / n)
    phi slots (cells), or pairs of slot z-plane ranges (planes)."""
    kappa = 2 * s.cfg.oversampling + 1
    if plan[0] == "cells":
        K = kappa ** s.cfg.dim
        return -(-K // -(-K // plan[1]))
    zk, zm = plan[1:]
    return -(-kappa // zk) * -(-(kappa + 1) // zm)


def built(plan_or_budget, monkeypatch, **kw):
    """A solver whose stencil build takes the cells build at ``("cells",
    n)`` (the plan patched) or, at an int, the planes build under that
    many MiB of side-table budget; -> (solver, the plan it runs)."""
    if isinstance(plan_or_budget, tuple):
        monkeypatch.setattr(stencil, "stencil_plan",
                            lambda *a: plan_or_budget)
        s = solver(**kw)
    else:
        s = solver(stencil_side_budget_mb=plan_or_budget, **kw)
    plan = stencil.stencil_plan(s.cfg, s.topo.n_patches, s.C,
                                torch.finfo(s.dtype).bits // 8)
    return s, plan


@pytest.mark.parametrize("route", [("cells", 1), ("cells", 3), ("cells", 4),
                                   0])
def test_stencil_chunks_follow_the_plan(route, monkeypatch):
    """Each chunk of the build is one ``stencil_chunk`` span under
    ``coarse_op`` and one ``stencil.chunks`` count, as many as the plan
    gives (budget 0 MiB: the planes build, one slot plane a range)."""
    s, plan = built(route, monkeypatch)
    assert plan[0] == ("cells" if isinstance(route, tuple) else "planes")
    s.compute_basis(s.coef_q)
    with traced():
        s.assemble_coarse_operator()
    n = expected_chunks(s, plan)
    assert n > 1 or plan == ("cells", 1)
    assert tree(timers.records()) == {"coarse_op": 1,
                                      "coarse_op/stencil_chunk": n}
    assert timers.counters() == {"stencil.chunks": {"stencil_chunk": n}}
    timers.clear()


@pytest.mark.parametrize("route", [("cells", 4), 0])
def test_nothing_recorded_and_answers_bitwise_without_a_profiler(
        route, monkeypatch):
    """The per-chunk window route and a chunked stencil build: a step with
    no profiler records nothing, and its answers equal a traced step's
    bit for bit."""
    s, _ = built(route, monkeypatch, window_chunk="on")
    step = s.build_step()
    timers.clear()
    x0, A0 = (v.clone() for v in step(s.coef_q, s.fem_rhs))
    phi0 = s.Phi.clone()
    assert timers.records() == [] and timers.counters() == {}
    with traced():
        x1, A1 = step(s.coef_q, s.fem_rhs)
    names = {r.name for r in timers.records()}
    assert {"windows", "stencil_chunk"} <= names
    timers.clear()
    assert torch.equal(phi0, s.Phi)
    assert torch.equal(A0, A1) and torch.equal(x0, x1)
