"""The port's examples (``python -m dealii_slod_tpu_torch.examples.<name>``)
against the JAX package's scripts under ``examples/``, float64 on the CPU.

``convergence_study``: the same table rows (<= 1e-10 relative to
max(|norm|, 1)).
``multi_rhs``: the same served coarse solutions on the same loads, both
scripts serving the JAX script's basis (the port's solver loads it through
the port's checkpoint in place of its basis stage): direct <= 1e-10, CG
<= 1e-8 relative.  The two
packages' own SLOD bases differ by the eigh stage's gauge
(``tests/test_torch_plain_lod.py``), so the port's own build is held to
its own serve: the direct and CG solutions of its basis agree to 1e-6."""

import importlib.util
import os
import types

import jax
import numpy as np
import pytest
import torch

from dealii_slod_tpu import models as jax_models
from dealii_slod_tpu.utils import checkpoint as jax_checkpoint
import dealii_slod_tpu_torch as pt
from dealii_slod_tpu_torch.examples import convergence_study, multi_rhs
from dealii_slod_tpu_torch.utils import checkpoint

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_script(name):
    """The JAX package's example ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return float(np.abs(a - np.asarray(b)).max() / np.abs(b).max())


def test_convergence_study_matches_the_jax_script(monkeypatch, capsys):
    """``convergence_study --device cpu --refinements 2 3`` against the JAX
    script's ``--refinements 2 3``: the same tables (keys, cells, dofs,
    each printed), every norm within 1e-10 of JAX's relative to
    max(|norm|, 1).  The norms measure fields of unit size (the exact
    solution's maximum is 1), and the SLOD basis's eigh-stage gauge moves
    the prolonged field by ~1e-13 (measured once: 1.2e-13 on the
    refinement-3 LOD-vs-FEMh Linfty error of 2.3e-4, 5.4e-10 of it)."""
    runs, run0 = [], jax_models.LODSolver.run

    def run_seen(self):
        res = run0(self)
        runs.append(res)
        return res

    monkeypatch.setattr(jax_models.LODSolver, "run", run_seen)
    assert jax_script("convergence_study").main(["--refinements", "2",
                                                 "3"]) == 0
    capsys.readouterr()
    args = ["--device", "cpu", "--refinements", "2", "3"]
    tables, basis_s = convergence_study.study(
        convergence_study.build_parser().parse_args(args))
    assert convergence_study.main(args) == 0
    out = capsys.readouterr().out
    ref = {}
    for res in runs:
        for key, t in res.items():
            if key.startswith("error_"):
                ref.setdefault(key, []).extend(t.rows)
    assert list(tables) == list(ref) and sorted(basis_s) == [2, 3]
    for key, t in tables.items():
        assert f"== {key} ==" in out and str(t) in out
        assert len(t.rows) == len(ref[key]) == 2
        for (c, d, n), (jc, jd, jn) in zip(t.rows, ref[key]):
            assert (c, d, list(n)) == (jc, jd, list(jn)), key
            for name in jn:
                assert abs(n[name] - jn[name]) <= 1e-10 * max(
                    abs(jn[name]), 1.0), \
                    (key, name, n[name], jn[name])


@pytest.fixture(scope="module")
def jax_basis(tmp_path_factory):
    """The JAX script's basis at MR_REFINE=3, saved by its checkpoint."""
    path = str(tmp_path_factory.mktemp("mr") / "basis.npz")
    mp = pytest.MonkeyPatch()
    mp.setenv("MR_REFINE", "3")
    mp.setenv("MR_RHS", "2")
    mp.setenv("MR_DTYPE", "float64")
    seen, op0 = [], jax_models.LODSolver.assemble_coarse_operator

    def op_seen(self):
        seen.append(self)
        return op0(self)

    mp.setattr(jax_models.LODSolver, "assemble_coarse_operator", op_seen)
    served = {}
    try:
        for mode in ("direct", "cg"):
            mp.setenv("MR_COARSE", mode)
            served[mode] = run_jax_multi_rhs()
    finally:
        mp.undo()
    jax_checkpoint.save_basis(seen[0], path)
    return path, served


def run_jax_multi_rhs():
    """The JAX script's ``main()`` -> the coarse solutions it served (its
    jitted serve function, recorded)."""
    mod = jax_script("multi_rhs")
    served = []

    def jit(fn):
        jf = jax.jit(fn)

        def call(*a):
            out = jf(*a)
            served.append(np.asarray(out))
            return out
        return call

    mod.jax = types.SimpleNamespace(jit=jit,
                                    block_until_ready=jax.block_until_ready)
    mod.main()
    return served


@pytest.mark.parametrize("mode, bound", [("direct", 1e-10), ("cg", 1e-8)])
def test_multi_rhs_serves_the_jax_scripts_solutions(jax_basis, monkeypatch,
                                                    capsys, mode, bound):
    """``multi_rhs --device cpu`` at MR_REFINE=3 MR_RHS=2, its solver's
    basis stage replaced by loading the JAX script's checkpoint: the JAX
    script's served coarse solutions on the same loads."""
    path, served = jax_basis
    loaded = []

    def load(self, coefs=None):
        assert coefs is None and checkpoint.load_basis(self, path)
        loaded.append(self)

    monkeypatch.setattr(pt.LODSolver, "compute_basis", load)
    monkeypatch.setattr(pt.LODSolver, "assemble_coarse_operator",
                        lambda self: None)
    for k, v in dict(MR_REFINE="3", MR_RHS="2", MR_DTYPE="float64",
                     MR_COARSE=mode).items():
        monkeypatch.setenv(k, v)
    out = multi_rhs.main(["--device", "cpu"])
    log = capsys.readouterr().out
    assert len(loaded) == 1 and out["mode"] == mode
    assert f"coarse={mode} device=cpu dtype=float64" in log
    assert "serve latency per rhs: median" in log
    assert len(out["solutions"]) == len(served[mode]) == 3
    for u, ref in zip(out["solutions"], served[mode]):
        assert u.shape == ref.shape and u.dtype == torch.float64
        assert rel(u, ref) <= bound


def test_multi_rhs_direct_and_cg_serve_its_own_basis(monkeypatch):
    """The port's script on its own basis at MR_REFINE=3 MR_RHS=2: the
    direct and the CG solutions agree to 1e-6 relative."""
    for k, v in dict(MR_REFINE="3", MR_RHS="2").items():
        monkeypatch.setenv(k, v)
    runs = {}
    for mode in ("direct", "cg"):
        monkeypatch.setenv("MR_COARSE", mode)
        runs[mode] = multi_rhs.main(["--device", "cpu"])
        assert runs[mode]["mode"] == mode
    for a, b in zip(runs["direct"]["solutions"], runs["cg"]["solutions"]):
        assert bool(torch.isfinite(a).all()) and a.dtype == torch.float64
        assert rel(b, a) <= 1e-6
