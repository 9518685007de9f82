"""The readers of the port's own spans and counters
(``program_trace.py``): each returns its value on a synthetic buffer, None
on an empty one and None on a port that keeps no such buffer."""

import pytest

import harness
from dealii_slod_tpu_torch.utils import timers

R = timers.Record
MS = 1_000_000                          # ns

# two solves: each a step of basis (its four chunk stages, two launches),
# coarse op, coarse solve (rhs, cg) and prolong; durations in ms
SPANS = [
    R(1, None, 1, "step", 0, 100 * MS, {}),
    R(2, 1, 1, "basis", 0, 60 * MS, {}),
    R(3, 2, 1, "assemble", 0, 10 * MS, {}),
    R(4, 2, 1, "patch_solve", 10 * MS, 30 * MS, {}),
    R(5, 4, 1, "launch", 11 * MS, 12 * MS, {"kernel": "K1"}),
    R(6, 2, 1, "stabilize", 30 * MS, 50 * MS, {}),
    R(7, 6, 1, "launch", 31 * MS, 33 * MS, {"kernel": "K3"}),
    R(8, 2, 1, "canvas", 50 * MS, 58 * MS, {}),
    R(9, 1, 1, "coarse_op", 60 * MS, 70 * MS, {}),
    R(10, 1, 1, "coarse_solve", 70 * MS, 90 * MS, {}),
    R(11, 10, 1, "coarse_rhs", 70 * MS, 71 * MS, {}),
    R(12, 10, 1, "cg", 71 * MS, 90 * MS, {}),
    R(13, None, 13, "prolong", 90 * MS, 94 * MS, {}),
]
SPANS = SPANS + [r._replace(id=r.id + 100, parent=r.parent and r.parent + 100,
                            root=r.root + 100) for r in SPANS]
COUNTS = {"cg.iterations": {"cg": 46}, "cg.enqueued": {"cg": 48},
          "host_syncs": {"cg": 8}, "h2d_bytes": {"cg": 3 * 2 ** 20}}

EXPECTED = {
    "basis.host_ms": 60.0, "basis.assemble.host_ms": 10.0,
    "basis.patch_solve.host_ms": 20.0, "basis.stabilize.host_ms": 20.0,
    "basis.canvas.host_ms": 8.0, "coarse_op.host_ms": 10.0,
    "coarse_solve.host_ms": 20.0, "prolong.host_ms": 4.0,
    "kernels.launch_host_ms": 3.0,
    "coarse_solve.cg_waste_pct": 100.0 * 2 / 48,
    "device.host_syncs": 4.0, "device.h2d_mib": 1.5}
CTX = {"solves": 2}


def reader(name):
    return harness.metric_reader(harness.HERE, name)


def buffer(monkeypatch, spans, counts):
    monkeypatch.setattr(timers, "records", lambda: list(spans))
    monkeypatch.setattr(timers, "counters", lambda: dict(counts))


def test_every_reader_is_in_the_manifest():
    names = {m["name"]: m for m in harness.manifest()["per_layer"]}
    for name in EXPECTED:
        m = names[name]
        assert m["source"] in ("program_span", "program_counter")
        assert m["moves"] == "solves_per_s" and m["workloads"]


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_the_buffer(name, monkeypatch):
    buffer(monkeypatch, SPANS, COUNTS)
    assert reader(name)(CTX) == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_none_on_an_empty_buffer(name, monkeypatch):
    buffer(monkeypatch, [], {})
    assert reader(name)(CTX) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_none_without_the_tracer(name, monkeypatch):
    """A port whose ``utils/timers`` has no buffer (before the tracer):
    nothing to read, and nothing raises."""
    monkeypatch.delattr(timers, "records")
    monkeypatch.delattr(timers, "counters")
    assert reader(name)(CTX) is None


@pytest.mark.parametrize("name,value", [("device.host_syncs", 0.0),
                                        ("device.h2d_mib", 0.0),
                                        ("coarse_solve.cg_waste_pct", None)])
def test_counter_that_never_fired(name, value, monkeypatch):
    """Spans but no count: the syncs and uploads read 0 (the solves made
    none), the CG waste None (no CG ran)."""
    buffer(monkeypatch, SPANS, {})
    assert reader(name)(CTX) == value


def test_readers_on_a_traced_port_step(monkeypatch):
    """The readers on the port's own buffer after a traced CPU step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import dealii_slod_tpu_torch as pt
    cfg = pt.SLODConfig(dim=2, n_global_refinements=2, oversampling=1,
                        lod_stabilization=True, eig_solver="smallk",
                        constant_coefficients=False, patch_chunk=8)
    s = pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device="cpu",
                     verbose=False)
    s.assemble_fine_rhs()
    step = s.build_step()
    step(s.coef_q, s.fem_rhs)
    timers.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        step(s.coef_q, s.fem_rhs)
        s.prolong_lod_solution()
    ctx = {"solves": 1}
    stages = sum(reader(f"basis.{n}.host_ms")(ctx) for n in
                 ("assemble", "patch_solve", "stabilize", "canvas"))
    assert 0.9 <= stages / reader("basis.host_ms")(ctx) <= 1.0
    n = int(s.coarse_cg.n_iter)
    assert reader("device.host_syncs")(ctx) == -(-n // 8) + 1
    assert reader("device.h2d_mib")(ctx) == 0.0
    assert reader("kernels.launch_host_ms")(ctx) is None   # no card
    assert torch.isfinite(torch.tensor(reader("prolong.host_ms")(ctx)))
    timers.clear()
