"""The readers of the 32768-patch cell's layers (``basis.windows.host_ms``,
``coarse_op.chunks``, ``coarse_op_roofline``, ``coarse_solve_roofline``)
and their work counts (``roofline_coarse.py``): each reader reads its
value on a synthetic buffer and trace, None on an empty buffer and on a
port without the tracer; the counts equal a count node by node at small
sizes, and the supports they count are where the port's canvases are
nonzero; the cell resolves and runs small on the CPU, correct."""

import numpy as np
import pytest
import torch

import harness
import roofline
import roofline_coarse as rc
from dealii_slod_tpu_torch.utils import timers
from tiny import tiny

CELL = "diffusion-3d-32768.samples"
NEW = ("basis.windows.host_ms", "coarse_op.chunks", "coarse_op_roofline",
       "coarse_solve_roofline")
R = timers.Record
MS = 1_000_000                          # ns

# two solves: basis (an assemble with the lattice's windows span, then one
# a chunk of two), coarse op (four chunks), coarse solve (rhs, cg)
SPANS = [
    R(1, None, 1, "basis", 0, 60 * MS, {}),
    R(2, 1, 1, "assemble", 0, 4 * MS, {}),
    R(3, 2, 1, "windows", 0, 3 * MS, {}),
    R(4, 1, 1, "assemble", 10 * MS, 12 * MS, {}),
    R(5, 4, 1, "windows", 10 * MS, 11 * MS, {}),
    R(6, 1, 1, "assemble", 30 * MS, 33 * MS, {}),
    R(7, 6, 1, "windows", 30 * MS, 32 * MS, {}),
    R(8, None, 8, "coarse_op", 60 * MS, 80 * MS, {}),
] + [R(9 + i, 8, 8, "stencil_chunk", (60 + 5 * i) * MS, (65 + 5 * i) * MS,
       {}) for i in range(4)] + [
    R(13, None, 13, "coarse_solve", 80 * MS, 100 * MS, {}),
    R(14, 13, 13, "coarse_rhs", 80 * MS, 81 * MS, {}),
    R(15, 13, 13, "cg", 81 * MS, 100 * MS, {}),
]
SPANS = SPANS + [r._replace(id=r.id + 100, parent=r.parent and r.parent + 100,
                            root=r.root + 100) for r in SPANS]
COUNTS = {"stencil.chunks": {"stencil_chunk": 8},
          "window_bytes": {"windows": 2 ** 20},
          "cg.iterations": {"cg": 100}, "cg.enqueued": {"cg": 112}}
CONF = harness.resolve(CELL)["config"]
# the benchmark's synced spans and the device time inside them
TRACE = {"busy_in": {"coarse_op": 0.050, "coarse_solve": 0.030}}
CTX = {"solves": 2, "conf": CONF, "trace": TRACE,
       "spans": {"coarse_op": [0.03, 0.03], "coarse_solve": [0.02, 0.02]}}


def least_ms(work):
    return roofline.by(*work, roofline.PEAK_FLOPS_BY_ITEMSIZE[4])[0]


EXPECTED = {
    "basis.windows.host_ms": 6.0,
    "coarse_op.chunks": 4.0,
    "coarse_op_roofline": 100.0 * least_ms(rc.coarse_op_work(
        3, 32, 2, 2, 1)) / 25.0,
    "coarse_solve_roofline": 100.0 * least_ms(rc.coarse_solve_work(
        3, 32, 2, 2, 1, iterations=56)) / 15.0,
}


def reader(name):
    return harness.metric_reader(harness.HERE, name)


def buffer(monkeypatch, spans, counts):
    monkeypatch.setattr(timers, "records", lambda: list(spans))
    monkeypatch.setattr(timers, "counters", lambda: dict(counts))


def test_entries_list_the_new_cell_alone():
    m = {m["name"]: m for m in harness.manifest()["per_layer"]}
    for name in NEW:
        assert m[name]["workloads"] == [CELL]
        assert m[name]["moves"] == "solves_per_s"
    assert m["coarse_op_roofline"]["unit"] == "%"
    assert m["coarse_solve_roofline"]["layer"] == "coarse solve"
    cell = next(w for w in harness.manifest()["workloads"]
                if w["name"] == CELL)
    assert cell["chips"] == 1 and cell["config"] == "diffusion-3d-32768"
    assert {m["name"] for m in harness.resolve(CELL)["per_layer"]} == \
        set(NEW)


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_the_buffer(name, monkeypatch):
    buffer(monkeypatch, SPANS, COUNTS)
    assert reader(name)(CTX) == pytest.approx(EXPECTED[name], rel=1e-12)


def test_rooflines_are_small_at_the_cell_size():
    """At the trace's 25 ms and 15 ms of device time a solve, both shares
    are a few percent: the stencil build is bound by its bytes (phi, A phi
    and A_st, ~0.33 GB), the solve by A_st read each iteration."""
    assert 0.1 < EXPECTED["coarse_op_roofline"] < 1.0
    assert 5.0 < EXPECTED["coarse_solve_roofline"] < 20.0
    _, what = roofline.by(*rc.coarse_op_work(3, 32, 2, 2, 1))
    assert what == "bytes"


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_none_on_an_empty_buffer(name, monkeypatch):
    buffer(monkeypatch, [], {})
    ctx = dict(CTX, trace={"busy_in": {}}, spans={})
    assert reader(name)(ctx) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_none_without_the_tracer(name, monkeypatch):
    """A port whose ``utils/timers`` has no buffer, and a benchmark trace
    with no coarse spans: nothing to read, nothing raises."""
    monkeypatch.delattr(timers, "records")
    monkeypatch.delattr(timers, "counters")
    ctx = dict(CTX, trace={"busy_in": {}}, spans={})
    assert reader(name)(ctx) is None


@pytest.mark.parametrize("name", ["basis.windows.host_ms",
                                  "coarse_op.chunks"])
def test_port_without_the_new_spans(name, monkeypatch):
    """The port before these spans (its other spans and counts recorded):
    the two readers of the new span and counter read None."""
    old = [r for r in SPANS if r.name not in ("windows", "stencil_chunk")]
    counts = {k: v for k, v in COUNTS.items()
              if k not in ("stencil.chunks", "window_bytes")}
    buffer(monkeypatch, old, counts)
    assert reader(name)(CTX) is None


def supports_by_node(dim, N, s, ell):
    """phi's and A phi's node sets of every patch, counted node by node:
    a patch's window (its coarse cells within ell, clipped), phi on the
    window's interior, A phi on its nodes off the domain boundary."""
    n = N * s
    out = []
    for q in np.ndindex(*([N] * dim)):
        lo = [max(0, c - ell) * s for c in q]
        hi = [(min(N - 1, c + ell) + 1) * s for c in q]
        nodes = np.stack(np.meshgrid(*[np.arange(a, b + 1)
                                       for a, b in zip(lo, hi)],
                                     indexing="ij"), -1).reshape(-1, dim)
        inner = ((nodes > lo) & (nodes < hi)).all(-1)
        dom = ((nodes > 0) & (nodes < n)).all(-1)
        key = [tuple(x) for x in nodes]
        out.append((q, {k for k, i in zip(key, inner) if i},
                    {k for k, d in zip(key, dom) if d}))
    return out


@pytest.mark.parametrize("dim,N,s,ell", [(2, 6, 2, 1), (2, 7, 2, 2),
                                         (3, 4, 2, 2), (2, 5, 3, 1)])
def test_counts_match_a_count_node_by_node(dim, N, s, ell):
    sup = supports_by_node(dim, N, s, ell)
    overlap = sum(len(pq & ap)
                  for q, pq, _ in sup for p, _, ap in sup
                  if max(abs(a - b) for a, b in zip(q, p)) <= 2 * ell)
    phi = sum(len(pq) for _, pq, _ in sup)
    aphi = sum(len(ap) for _, _, ap in sup)
    P, S = N ** dim, (4 * ell + 1) ** dim
    for C in (1, dim):
        flops, nbytes = rc.coarse_op_work(dim, N, s, ell, C, 4)
        assert flops == 2 * C ** 3 * overlap
        assert nbytes == 4 * (C * C * (phi + aphi) + P * S * C * C)
        f2, b2 = rc.coarse_solve_work(dim, N, s, ell, C, 3, 8)
        assert f2 == 2 * C * C * phi + 3 * 2 * P * S * C * C
        assert b2 == 8 * (C * C * phi + C * phi + P * C
                          + 3 * (P * S * C * C + 8 * P * C))


def test_supports_are_where_the_port_is_nonzero():
    """On a small grid of the cell's configuration, the port's canvases
    are nonzero exactly on the supports counted: phi on each window's
    interior, A phi on its nodes inside the domain."""
    conf = tiny(CONF, dim=2, refine=3, dtype="float64")
    solver = harness.make_solver(conf, "cpu")
    inputs = harness.Inputs(conf, 4, "cpu", torch.float64)
    solver.compute_basis(inputs.field(0))
    st = conf["settings"]
    N, s, ell = 2 ** st["n_global_refinements"], st["n_subdivisions"], \
        st["oversampling"]
    sm = rc.axis_sums(N, s, ell)
    nz_phi = int((solver.Phi != 0).sum())
    nz_aphi = int((solver.APhi != 0).sum())
    assert nz_phi == sm["phi"] ** 2
    assert nz_aphi == sm["aphi"] ** 2


def test_cell_runs_small_on_the_cpu():
    """The cell, cut to 3D refine-2 with its routes (chunks of 16 patches
    cut from the lattice, the stencil-matvec CG), runs traced on the CPU
    and is correct; the span and counter readers read the port's own
    buffer, the device shares nothing on a CPU."""
    conf = tiny(CONF, dim=3, refine=2)
    conf["settings"].update(patch_chunk=16, window_chunk="on",
                            coarse_dense_cap=32)
    out = harness.run(CELL, 2 ** 33 + 5, 0.3, True, device="cpu",
                      conf=conf)
    assert out["correct"] and out["failed"] == 0, out["compared"]
    m = out["metrics"]
    assert m["coarse_op.chunks"]["value"] == 1.0
    assert m["basis.windows.host_ms"]["value"] > 0
    assert "coarse_op_roofline" not in m
    assert "coarse_solve_roofline" not in m
    timers.clear()
