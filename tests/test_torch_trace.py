"""The port's spans and counters (``dealii_slod_tpu_torch/utils/timers.py``)
on the CPU: nothing is recorded without a profiler, the span tree of a
step, a coarse solve and a load-case serve under one, the chunk stages
tiling the basis build, the profiler's trace holding every span, and the
counters of the coarse CG (iterations, host syncs, uploaded bytes).
Tiny 2D configurations; ~10 s on one worker."""

import collections
import contextlib
import json
import math
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import dealii_slod_tpu_torch as pt
from dealii_slod_tpu_torch.models.coarse import CoarseSystem
from dealii_slod_tpu_torch.utils import kernels, timers

torch.set_num_threads(2)

STAGES = {"assemble", "patch_solve", "stabilize", "canvas"}
NAMES = STAGES | {"step", "basis", "coarse_op", "coarse_solve", "coarse_rhs",
                  "cg", "direct", "prolong", "launch", "windows",
                  "stencil_chunk"}


def solver(**kw):
    cfg = pt.SLODConfig(**{**dict(
        dim=2, n_global_refinements=3, oversampling=2,
        lod_stabilization=True, constant_coefficients=False, coef_seed=3,
        patch_chunk=16, eig_solver="smallk",
        coarse_solver=pt.ReductionControl(500, 1e-10, 1e-10)), **kw})
    s = pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device="cpu",
                     verbose=False)
    s.assemble_fine_rhs()
    return s


@pytest.fixture(scope="module")
def slod():
    """A solver whose step has run once (its tables built)."""
    s = solver()
    s.build_step()(s.coef_q, s.fem_rhs)
    return s


@contextlib.contextmanager
def traced(path=None):
    """A CPU profiler session with an empty buffer; the chrome trace
    exported to ``path`` where given."""
    timers.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        yield
    if path is not None:
        prof.export_chrome_trace(str(path))


def tree(recs):
    """{span path "a/b/c": occurrences} of the records."""
    by = {r.id: r for r in recs}

    def path(r):
        out = []
        while r is not None:
            out.append(r.name)
            r = by.get(r.parent)
        return "/".join(reversed(out))

    return collections.Counter(path(r) for r in recs)


def host_ms(recs, name):
    return sum(r.t1_ns - r.t0_ns for r in recs if r.name == name) / 1e6


def test_profiler_gate_follows_the_session():
    """The gate the tracer reads is on inside ``torch.profiler.profile``
    and off outside it, so a torch that changes it fails here."""
    assert not torch.autograd._profiler_enabled()
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd._profiler_enabled()
    assert not torch.autograd._profiler_enabled()
    assert timers._enabled is torch.autograd._profiler_enabled


def test_nothing_recorded_without_a_profiler(slod, monkeypatch):
    """No profiler: a step, a ``solve_coarse`` and a serve record nothing,
    open no ``record_function`` and ``span`` is one shared null object."""
    calls = []
    real = torch.profiler.record_function

    def counting(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    timers.clear()
    slod.build_step()(slod.coef_q, slod.fem_rhs)
    slod.solve_coarse()
    slod.load_server("cg")(slod.fem_rhs)
    slod.prolong_lod_solution()
    assert calls == []
    assert timers.records() == [] and timers.counters() == {}
    assert timers.span("basis") is timers.span("launch", kernel="K1")
    timers.count("host_syncs", 1)
    assert timers.counters() == {}


def test_step_span_tree(slod):
    """Under a profiler the step's spans form the stage tree: ``step`` over
    ``basis`` (tiled by the four chunk stages), ``coarse_op`` (its one
    ``stencil_chunk``: this grid builds A_st whole) and ``coarse_solve``
    (``coarse_rhs``, then ``cg``); ``prolong`` a root of its own; every
    span of the step carries the step's id as its root."""
    with traced():
        slod.build_step()(slod.coef_q, slod.fem_rhs)
        slod.prolong_lod_solution()
    recs = timers.records()
    n_chunks = math.ceil(slod.topo.n_patches / slod.cfg.patch_chunk)
    assert tree(recs) == {
        "step": 1, "step/basis": 1,
        # the whole windows once, then each chunk's slice and its prep
        "step/basis/assemble": 1 + 2 * n_chunks,
        "step/basis/patch_solve": n_chunks,
        "step/basis/stabilize": n_chunks, "step/basis/canvas": n_chunks,
        "step/coarse_op": 1, "step/coarse_op/stencil_chunk": 1,
        "step/coarse_solve": 1,
        "step/coarse_solve/coarse_rhs": 1, "step/coarse_solve/cg": 1,
        "prolong": 1}
    step = next(r for r in recs if r.name == "step")
    assert {r.root for r in recs if r.name != "prolong"} == {step.id}
    assert step.parent is None
    assert all(r.t0_ns <= r.t1_ns for r in recs)
    ids = [r.id for r in recs]
    assert ids == sorted(ids)


def test_chunk_stages_tile_the_basis(slod):
    """The four chunk stages' host times add up to at least 90% of the
    ``basis`` span's, and never to more."""
    with traced():
        slod.compute_basis(slod.coef_q)
    recs = timers.records()
    stages = sum(host_ms(recs, n) for n in STAGES)
    assert 0.9 * host_ms(recs, "basis") <= stages <= host_ms(recs, "basis")


def test_solve_coarse_and_serve_spans(slod, monkeypatch):
    """``solve_coarse`` and both serve routes are ``coarse_solve`` spans
    over ``coarse_rhs`` and ``cg`` or ``direct``; ``solve_coarse`` with
    ``verbose=False`` reads no norm."""
    def no_norm(*a, **kw):
        raise AssertionError("solve_coarse read a norm with verbose=False")

    direct = solver(coarse_solve="direct", n_global_refinements=2)
    direct.compute_basis()
    direct.assemble_coarse_operator()
    serve_direct = direct.load_server("direct")
    serve_cg = slod.load_server("cg")
    with traced():
        with monkeypatch.context() as m:
            m.setattr(torch.linalg, "norm", no_norm)
            slod.solve_coarse()
        serve_cg(slod.fem_rhs)
        serve_direct(direct.fem_rhs)
    assert tree(timers.records()) == {
        "coarse_solve": 3, "coarse_solve/coarse_rhs": 3,
        "coarse_solve/cg": 2, "coarse_solve/direct": 1}
    # the served answer is the solver's own coarse solve
    serve_x = serve_direct(direct.fem_rhs)
    torch.testing.assert_close(serve_x, direct.solve_coarse(),
                               rtol=1e-12, atol=0)


def test_run_sections_are_spans():
    """``run()``'s ``StageTimer`` sections are spans too, over the stage
    spans they time, and the timer keeps its totals."""
    s = pt.LODSolver(pt.SLODConfig(), pt.DiffusionProblem(pt.SLODConfig()),
                     device="cpu", verbose=False)
    with traced():
        s.run()
    t = tree(timers.records())
    assert t["2: compute basis functions/basis"] == 1
    assert t["4: solve coarse LOD/coarse_solve/cg"] == 1
    assert t["5: prolong + compare/prolong"] == 1
    assert s.timer.counts["4: solve coarse LOD"] == 1


def test_chrome_trace_holds_every_span(slod, tmp_path):
    """Each in-memory span is one ``record_function`` range of the same
    name in the exported trace, in the same order and nested the same
    way."""
    path = tmp_path / "trace.json"
    with traced(path):
        slod.build_step()(slod.coef_q, slod.fem_rhs)
        slod.prolong_lod_solution()
    recs = timers.records()
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and e["name"] in NAMES]
    events.sort(key=lambda e: (e["ts"], -e["dur"]))
    assert [e["name"] for e in events] == [r.name for r in recs]
    ev = {r.id: e for r, e in zip(recs, events)}
    for r in recs:
        if r.parent is not None:
            p, c = ev[r.parent], ev[r.id]
            assert p["ts"] <= c["ts"]
            assert c["ts"] + c["dur"] <= p["ts"] + p["dur"]
        # the range encloses the host span: its length is at least the
        # span's, to the trace's microsecond
        assert ev[r.id]["dur"] >= (r.t1_ns - r.t0_ns) / 1e3 - 1


@pytest.mark.parametrize("tol", [1e-3, 1e-6, 1e-10])
def test_cg_counters(slod, tol):
    """A coarse CG of n iterations counts ``cg.iterations`` = n (the
    solver's ``n_iter``), ``cg.enqueued`` = 8 ceil(n / 8) and
    ``host_syncs`` = ceil(n / 8) + 1, all under the ``cg`` span."""
    A_st = slod.assemble_coarse_operator()
    system = CoarseSystem(slod, A_st)
    rhs = system.rhs(slod.Phi, slod.fem_rhs)
    saved = slod.cfg.coarse_solver
    slod.cfg.coarse_solver = pt.ReductionControl(500, tol, tol)
    try:
        with traced():
            res = system.cg(rhs)
    finally:
        slod.cfg.coarse_solver = saved
    n = int(res.n_iter)
    assert 0 < n < 500
    assert timers.counters() == {"cg.iterations": {"cg": n},
                                 "cg.enqueued": {"cg": 8 * -(-n // 8)},
                                 "host_syncs": {"cg": -(-n // 8) + 1}}


def test_h2d_bytes_of_the_stencil_matvec():
    """On the stencil-matvec route (``coarse_dense_cap`` below the coarse
    dofs) the solver uploads the stencil neighbour tables at its first
    coarse solve and keeps them: over two steps ``h2d_bytes`` under
    ``cg`` is their bytes once, and a third step uploads nothing."""
    s = solver(n_global_refinements=2, coarse_dense_cap=8)
    step = s.build_step()
    with traced():
        step(s.coef_q, s.fem_rhs)
        step(s.coef_q, s.fem_rhs)
    nbytes = (s.stencil_nbr_np.astype(np.int64).nbytes
              + s.stencil_valid_np.astype(bool).nbytes)
    assert timers.counters()["h2d_bytes"]["cg"] == nbytes
    with traced():
        step(s.coef_q, s.fem_rhs)
    assert "h2d_bytes" not in timers.counters()


def test_launch_is_a_leaf_under_its_stage(monkeypatch):
    """``kernels.launch`` is a ``launch`` span under the stage that called
    it, its kernel's name as the ``kernel`` attribute; it still counts
    the launch."""
    lib = types.SimpleNamespace(slod_probe_f32=lambda *a: 0)
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    before = kernels.launches["K0 probe"]
    with traced():
        with timers.span("stabilize"):
            kernels.launch("K0 probe", "slod_probe", torch.float32,
                           torch.device("cpu"))
    stage, launch = timers.records()
    assert (launch.name, launch.parent, launch.root) == ("launch", stage.id,
                                                        stage.id)
    assert launch.attrs == {"kernel": "K0 probe"}
    assert kernels.launches["K0 probe"] == before + 1


def test_counts_keep_device_scalars_and_the_buffer_is_bounded():
    """A count keeps a tensor as it is until ``counters()`` reads it; a
    count outside any span sits under None; ``clear()`` empties the
    buffer, which keeps the newest ``MAX_RECORDS`` entries."""
    n = torch.tensor(5)
    with traced():
        timers.count("cg.iterations", n)
        with timers.span("cg"):
            timers.count("cg.iterations", torch.tensor(2))
            timers.count("cg.iterations", 1)
    assert timers._counts[0][2] is n
    assert timers.counters() == {"cg.iterations": {None: 5, "cg": 3}}
    timers.clear()
    assert timers.records() == [] and timers.counters() == {}
    assert timers._spans.maxlen == timers._counts.maxlen == \
        timers.MAX_RECORDS
