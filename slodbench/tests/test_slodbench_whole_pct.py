"""The reader of ``basis.patch_solve.whole_pct``: the share of the
window's patches solved by one K1 launch on the whole block in place,
read from the port's counters (``patch_solve.whole_block`` over
``patch_solve.patches``)."""

import pytest

import harness
from dealii_slod_tpu_torch.utils import timers

NAME = "basis.patch_solve.whole_pct"
R = timers.Record
MS = 1_000_000                          # ns

# one solve's basis: two chunks, each a patch solve
SPANS = [
    R(1, None, 1, "basis", 0, 20 * MS, {}),
    R(2, 1, 1, "patch_solve", 1 * MS, 9 * MS, {}),
    R(3, 1, 1, "patch_solve", 11 * MS, 19 * MS, {}),
]
CTX = {"solves": 1}


def reader():
    return harness.metric_reader(harness.HERE, NAME)


def buffer(monkeypatch, spans, counts):
    monkeypatch.setattr(timers, "records", lambda: list(spans))
    monkeypatch.setattr(timers, "counters", lambda: dict(counts))


def test_reader_is_in_the_manifest():
    m = {m["name"]: m for m in harness.manifest()["per_layer"]}[NAME]
    assert m["source"] == "program_counter" and m["unit"] == "%"
    assert m["layer"] == "basis" and m["moves"] == "solves_per_s"
    # diffusion-3d-32768.samples keeps its own four per-layer metrics
    # (test_slodbench_coarse.py pins them), though its basis counts alike
    assert m["workloads"] == ["diffusion-3d-4096.samples",
                              "elasticity-3d-4096.samples"]


@pytest.mark.parametrize("whole,value", [(256, 100.0), (128, 50.0),
                                         (0, 0.0), (None, 0.0)])
def test_reader_reads_the_buffer(whole, value, monkeypatch):
    """100 whole_block / patches; a route that solved no chunk on the
    whole block in place (the Schur split, the CPU) counts none: 0."""
    counts = {"patch_solve.patches": {"patch_solve": 256}}
    if whole is not None:
        counts["patch_solve.whole_block"] = {"patch_solve": whole}
    buffer(monkeypatch, SPANS, counts)
    assert reader()(CTX) == pytest.approx(value, rel=1e-12)


@pytest.mark.parametrize("spans,counts", [
    ([], {}), (SPANS, {}), (SPANS, {"host_syncs": {"patch_solve": 3}})])
def test_reader_reads_none_without_the_counter(spans, counts, monkeypatch):
    """An empty buffer, or a port that counts no patch solves (one from
    before the counter): nothing to read."""
    buffer(monkeypatch, spans, counts)
    assert reader()(CTX) is None


def test_reader_reads_none_without_the_tracer(monkeypatch):
    """A port whose ``utils/timers`` has no buffer: nothing raises."""
    monkeypatch.delattr(timers, "records")
    monkeypatch.delattr(timers, "counters")
    assert reader()(CTX) is None
