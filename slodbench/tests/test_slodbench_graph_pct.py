"""The reader of ``coarse_solve.graph_pct``: the share of the coarse CG's
issued iterations that ran as replays of a captured CUDA graph, read from
the port's counters (``cg.graph_iterations`` over ``cg.enqueued``)."""

import pytest

import harness
from dealii_slod_tpu_torch.utils import timers

NAME = "coarse_solve.graph_pct"
R = timers.Record
MS = 1_000_000                          # ns

# two solves, each a coarse solve (rhs, cg); durations in ms
SPANS = [
    R(1, None, 1, "coarse_solve", 0, 20 * MS, {}),
    R(2, 1, 1, "coarse_rhs", 0, 1 * MS, {}),
    R(3, 1, 1, "cg", 1 * MS, 20 * MS, {}),
]
SPANS = SPANS + [r._replace(id=r.id + 100, parent=r.parent and r.parent + 100,
                            root=r.root + 100) for r in SPANS]
CG = {"cg.iterations": {"cg": 46}, "cg.enqueued": {"cg": 48},
      "host_syncs": {"cg": 8}}
CTX = {"solves": 2}


def reader():
    return harness.metric_reader(harness.HERE, NAME)


def buffer(monkeypatch, spans, counts):
    monkeypatch.setattr(timers, "records", lambda: list(spans))
    monkeypatch.setattr(timers, "counters", lambda: dict(counts))


def test_reader_is_in_the_manifest():
    m = {m["name"]: m for m in harness.manifest()["per_layer"]}[NAME]
    assert m["source"] == "program_counter" and m["unit"] == "%"
    assert m["layer"] == "coarse solve" and m["moves"] == "solves_per_s"
    assert "diffusion-3d-4096.loads" not in m["workloads"]   # direct route


@pytest.mark.parametrize("graph,value", [(48, 100.0), (40, 100.0 * 40 / 48),
                                         (0, 0.0), (None, 0.0)])
def test_reader_reads_the_buffer(graph, value, monkeypatch):
    """100 graph / enqueued; where the CG ran eagerly (a new operator every
    solve, the CPU, the sharded or dense routes) no replay is counted and
    the share reads 0."""
    counts = dict(CG)
    if graph is not None:
        counts["cg.graph_iterations"] = {"cg": graph}
    buffer(monkeypatch, SPANS, counts)
    assert reader()(CTX) == pytest.approx(value, rel=1e-12)


@pytest.mark.parametrize("spans,counts", [([], {}), (SPANS, {}),
                                          (SPANS, {"host_syncs": {"cg": 8}})])
def test_reader_reads_none_where_no_cg_ran(spans, counts, monkeypatch):
    """An empty buffer, or spans with no CG count (the direct route)."""
    buffer(monkeypatch, spans, counts)
    assert reader()(CTX) is None


def test_reader_reads_none_without_the_tracer(monkeypatch):
    """A port whose ``utils/timers`` has no buffer: nothing raises."""
    monkeypatch.delattr(timers, "records")
    monkeypatch.delattr(timers, "counters")
    assert reader()(CTX) is None


def test_reader_reads_none_on_a_port_without_graphs(monkeypatch):
    """A port whose CG has no graph plan counts no replays: the share is
    not read there, though its CG ran."""
    from dealii_slod_tpu_torch.ops import solvers
    buffer(monkeypatch, SPANS, {**CG, "cg.graph_iterations": {"cg": 0}})
    monkeypatch.delattr(solvers, "CGGraph")
    assert reader()(CTX) is None
