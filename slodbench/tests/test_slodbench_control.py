"""On the card, at each cell's own size: the control (the reference
computed in TF32, the next precision below the configuration's float32
with TF32 off) fails the cell's limit, on one seed, and the reference's
own float32 with TF32 off passes it: the gap is TF32's."""

import pytest

import control
import harness

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limit(card, cell):
    spec = harness.resolve(cell)
    gaps = {}
    for r in control.control_gaps(spec, spec["config"], [2 ** 31 + 1], card,
                                  ("float32", "control")):
        gaps.setdefault(r["side"], []).append(r["field_gap"])
    limit = spec["limits"]["field_gap"]
    assert min(gaps["control"]) > limit, gaps
    assert max(gaps["float32"]) < limit, gaps
