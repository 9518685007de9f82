"""A run, its look for a card skipped, at a small size on the CPU, with
the timed path broken underneath: the check must read ``correct`` false
for every fault these cells can have.  (The cells run on one card: no
exchange between chips to leave out.)"""

import pytest
import torch

import harness
from tiny import tiny

CELLS = ["diffusion-3d-4096.samples", "elasticity-3d-4096.samples",
         "diffusion-3d-4096.loads", "elasticity-3d-4096.loads"]


class Stale:
    """A step that returns its state unchanged: after the first call (a
    warm-up solve in set-up) every solve answers with that call's
    answer."""

    def __init__(self, stream):
        self.stream, self.first = stream, None

    def solve(self, x):
        if self.first is None:
            self.first = self.stream.solve(x)
        return self.first.clone()


class HalfBatch:
    """Half of the patches left out of the answer: their coarse
    coefficients zeroed before the prolongation."""

    def __init__(self, stream):
        self.stream = stream
        s = stream.s
        orig = s.prolong_lod_solution

        def prolong():
            u = s.coarse_solution
            s.coarse_solution = torch.cat([u[:len(u) // 2],
                                           torch.zeros_like(u[len(u) // 2:])])
            return orig()

        s.prolong_lod_solution = prolong

    def solve(self, x):
        return self.stream.solve(x)


class Altered:
    """The answer altered where it is produced: the coarse solution off
    by five parts in a hundred."""

    def __init__(self, stream):
        self.stream = stream

    def solve(self, x):
        self.stream.solve(x)
        s = self.stream.s
        s.coarse_solution = s.coarse_solution * 1.05
        return s.prolong_lod_solution()


@pytest.mark.parametrize("fault", [None, Stale, HalfBatch, Altered])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_reads_incorrect(cell, fault):
    spec = harness.resolve(cell)
    conf = tiny(spec["config"])
    out = harness.run(cell, 2 ** 31 + 5, 0.3, False, device="cpu",
                      conf=conf, stream_hook=fault)
    assert out["attempted"] >= 1
    assert out["correct"] is (fault is None), out["compared"]
