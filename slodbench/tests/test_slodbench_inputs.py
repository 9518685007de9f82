"""Inputs repeat exactly for one seed and differ between solves and
seeds; the sample the check keeps is drawn from the seed."""

import pytest
import torch

import harness
from tiny import tiny

CONF = tiny(harness.resolve("elasticity-3d-4096.samples")["config"])
SEED = 2 ** 31 + 977


def inputs(seed):
    return harness.Inputs(CONF, seed, "cpu", torch.float32)


def test_fields_repeat_and_differ():
    a, b = inputs(SEED), inputs(SEED)
    f0, f0b, f1 = a.field(0), b.field(0), a.field(1)
    g0 = inputs(SEED + 1).field(0)
    for k in CONF["coefficients"]["names"]:
        assert torch.equal(f0[k], f0b[k])
        assert not torch.equal(f0[k], f1[k])
        assert not torch.equal(f0[k], g0[k])
        assert float(f0[k].min()) >= 1.0 and float(f0[k].max()) < 100.0
    assert not torch.equal(f0["lam"], f0["mu"])
    assert not torch.equal(a.field(0, setup=True)["lam"], f0["lam"])


def test_field_follows_the_lattice():
    """Every Gauss point of a fine cell reads the cell's lattice value
    (the lattice is as fine as the fine cells here)."""
    f = inputs(SEED).field(3)["lam"]
    assert torch.equal(f, f[:, :1].expand_as(f))
    assert len(torch.unique(f[:, 0])) == f.shape[0]


def test_loads_repeat_differ_and_vanish_on_the_boundary():
    a = inputs(SEED)
    f0, f1 = a.load(0), a.load(1)
    assert torch.equal(f0, inputs(SEED).load(0))
    assert not torch.equal(f0, f1)
    assert not torch.equal(f0, inputs(7).load(0))
    assert f0.shape == (a.n_nodes, 2)
    assert torch.all(f0[~a.interior] == 0)
    assert torch.all(f0[a.interior] != 0)


def test_reservoir_is_drawn_from_the_seed():
    def kept(seed):
        r = harness.Reservoir(4, seed)
        for i in range(100):
            r.offer(i, torch.tensor([float(i)]))
        return [i for i, _ in r.answers()]

    assert kept(SEED) == kept(SEED)
    assert kept(SEED) != kept(SEED + 1)
    assert len(set(kept(SEED))) == 4 and max(kept(SEED)) >= 4


def test_p95_reader():
    p95 = harness.metric_reader(harness.HERE, "solve_ms_p95")
    assert p95({"latencies": [i / 1e3 for i in range(101)]}) == \
        pytest.approx(95.0)
    assert p95({"latencies": [0.003]}) == pytest.approx(3.0)
