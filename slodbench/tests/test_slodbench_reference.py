"""The plain reference agrees with the port's CPU float64 path at small
sizes: both problems, both mixes, the float64 spectral rule and the
float32 one.  The bound: these SLOD fields are rounding-sensitive (the
2D refine-3, l = 2 field moves ~1e-9 under a 1e-15 change of its input,
and the truncation of the smallk directions acts as a gauge), and the
gaps read 1e-10 to 2e-8; 1e-6 leaves room and still fails a reference
that drops the stabilization or the rhs by orders of magnitude."""

import contextlib

import pytest
import torch

import harness
from tiny import tiny

BOUND = 1e-6
# (cell, dim, refine, oversampling): 3D elasticity at l = 1, where the
# port's CPU path takes seconds (at l = 2 ten minutes)
CASES = [("diffusion-3d-4096.samples", 2, 3, 2),
         ("diffusion-3d-4096.loads", 2, 3, 2),
         ("elasticity-3d-4096.samples", 2, 3, 2),
         ("elasticity-3d-4096.loads", 2, 3, 2),
         ("diffusion-3d-4096.samples", 3, 2, 2),
         ("diffusion-3d-4096.loads", 3, 2, 2),
         ("elasticity-3d-4096.samples", 3, 2, 1),
         ("elasticity-3d-4096.loads", 3, 2, 1)]


@contextlib.contextmanager
def float32_rule():
    """The port's float64 path with the float32 spectral rule (jitter
    1e-6, ``smallk_dirs`` directions)."""
    from dealii_slod_tpu_torch.models import basis
    from dealii_slod_tpu_torch.ops import eig
    k_eff, jitter = basis.smallk_k_eff, eig.JITTER[torch.float64]
    basis.smallk_k_eff = lambda cD, dtype, dirs: k_eff(cD, torch.float32,
                                                       dirs)
    eig.JITTER[torch.float64] = eig.JITTER[torch.float32]
    try:
        yield
    finally:
        basis.smallk_k_eff, eig.JITTER[torch.float64] = k_eff, jitter


def port_fields(conf, mix, seed, n):
    from dealii_slod_tpu_torch import LODSolver, ReductionControl, SLODConfig
    st = dict(conf["settings"])
    st["coarse_solver"] = ReductionControl(4000, 1e-15, 1e-15)
    cfg = SLODConfig(**st)
    prob = harness.problem_of(conf).port_problem(cfg)
    s = LODSolver(cfg, prob, device="cpu", verbose=False, eig_block=1)
    inputs = harness.Inputs(conf, seed, "cpu", torch.float64)
    stream = mix.Stream(s, inputs)
    return inputs, [stream.solve(mix.draw(inputs, i)) for i in range(n)]


FIELD = harness.plugin(harness.HERE, "streams", "field")


@pytest.mark.parametrize("cell,dim,refine,ell", CASES)
def test_reference_matches_port(cell, dim, refine, ell):
    spec = harness.resolve(cell)
    mix = spec["stream"]
    conf = tiny(spec["config"], dim, refine, dtype="float64", ell=ell)
    inputs, us = port_fields(conf, mix, 11, 2)
    refs = harness.reference_fields(conf, inputs, mix, [0, 1], "cpu")
    gaps = [harness.gap(u, v) for u, v in zip(us, refs)]
    assert max(gaps) < BOUND, gaps
    # the two solves' answers differ: the check compares real work
    assert harness.gap(us[0], refs[1]) > 1e-3


def test_reference_matches_port_float32_rule():
    """3D refine-2 has 125 canvas coarse dofs, so the float32 rule keeps
    32 smallk directions and adds the 1e-6 jitter; the port runs it in
    float64 with that rule, the reference with ``rule="float32"``."""
    spec = harness.resolve("diffusion-3d-4096.samples")
    conf = tiny(spec["config"], 3, 2, dtype="float64")
    with float32_rule():
        inputs, us = port_fields(conf, FIELD, 3, 1)
    rule32 = dict(conf, settings=dict(conf["settings"], dtype="float32"))
    ref = harness.reference_for(rule32, "cpu")
    ref.build(inputs.field(0))
    v = ref.solve(ref.load_vector([1.0]))
    assert harness.gap(us[0], v) < BOUND
    # and the float64 rule gives another field: the rule is what is held
    v64 = harness.reference_fields(conf, inputs, FIELD, [0], "cpu")[0]
    assert harness.gap(v, v64) > 10 * BOUND


def test_plain_lod_differs():
    """A reference without the stabilization is far from the port's SLOD
    field: the comparison sees the spectral stage."""
    spec = harness.resolve("diffusion-3d-4096.samples")
    conf = tiny(spec["config"], 2, 3, dtype="float64")
    inputs, us = port_fields(conf, FIELD, 5, 1)
    lod = dict(conf, settings=dict(conf["settings"],
                                   lod_stabilization=False))
    v = harness.reference_fields(lod, inputs, FIELD, [0], "cpu")[0]
    assert harness.gap(us[0], v) > 1e-4

