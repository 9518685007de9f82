"""The port's basis checkpoints: the ``settings`` key beside the
reference's fingerprint (``dealii_slod_tpu_torch/utils/checkpoint.py``),
float64 on the CPU.

For each entry of the key, a change of it moves Phi on a 2D configuration
(refine-2 l=1, or refine-3 l=2 where refine-2 does not show it) and makes
``load_basis`` refuse a file written before the change, while a solver of
the unchanged configuration loads it.  "Moves" is a relative max change of
at least 1e-5: the 2D refine-3 l=2 configuration's basis moves by ~6e-7
under a 1e-15 coefficient change (``tests/test_torch_slice.py``).

``smallk_dirs`` is read only in float32 for Grams larger than 64
(``basis.smallk_k_eff``), and there the float32 jitter keeps ||d0||_inf
below the truncation's 0.5 (3D refine-2 l=2: no patch truncates in
float32, 38 of 64 in float64; ``tests/test_torch_dtype_gap.py:
calibrate``), so the directions are never used.  Its case reads it in
float64 through the float32 direction rule for every Gram size, where the
truncation runs.  ``spectral_stage`` is what ``eig_solver="auto"``
resolves to: the eigh stage on the CPU, smallk on the card in float32; its
case builds the second solver with the card's resolution.

Files move between the packages: a port-written file loads into the JAX
package's ``load_basis``, and a JAX-written file (no ``settings`` key)
loads into the port on the fingerprint alone."""

import numpy as np
import pytest
import torch

import dealii_slod_tpu_torch as pt
from dealii_slod_tpu.config import SLODConfig as JaxConfig
from dealii_slod_tpu.models import DiffusionProblem as JaxDiffusion
from dealii_slod_tpu.models import LODSolver as JaxLOD
from dealii_slod_tpu.utils import checkpoint as jax_checkpoint
from dealii_slod_tpu_torch.models import basis, lod
from dealii_slod_tpu_torch.utils import checkpoint

torch.set_num_threads(2)

BASE = dict(dim=2, n_global_refinements=2, n_subdivisions=2, oversampling=1,
            lod_stabilization=True, constant_coefficients=False, coef_seed=1,
            coef_refinement=3, dtype="float64", eig_solver="lapack")
R3 = dict(n_global_refinements=3, oversampling=2)
MOVE = 1e-5
# entry of the key -> (the configuration both solvers share, the change,
# the problem: "diffusion" or "reaction", or the pair (first, second))
CASES = {
    "problem": (dict(reaction="1e3 * (1 + x)"), {},
                ("diffusion", "reaction")),
    "reaction": ({}, dict(reaction="1e3 * (1 + x)"), "reaction"),
    "coef_corr_len": (dict(coef_field="lognormal"), dict(coef_corr_len=0.3),
                      "diffusion"),
    "coef_rand_offset": (dict(reference_parity=True),
                         dict(coef_rand_offset=12), "diffusion"),
    "smallk_dirs": (dict(eig_solver="smallk"), dict(smallk_dirs=4),
                    "diffusion"),
    "smallk_power": (dict(eig_solver="smallk"), dict(smallk_power=1),
                     "diffusion"),
    "smallk_tol": (dict(eig_solver="smallk", **R3), dict(smallk_tol=0.5),
                   "diffusion"),
    "eig_tol": (dict(eig_solver="jacobi"), dict(eig_tol=0.5), "diffusion"),
    "eig_sweeps": (dict(eig_solver="jacobi"), dict(eig_sweeps=1),
                   "diffusion"),
    "spectral_stage": (dict(eig_solver="auto", **R3), {}, "diffusion"),
}
PROBLEMS = {"diffusion": pt.DiffusionProblem,
            "reaction": pt.ReactionDiffusionProblem}


def solver(kw, problem="diffusion"):
    cfg = pt.SLODConfig(**dict(BASE, **kw))
    return pt.LODSolver(cfg, PROBLEMS[problem](cfg), device="cpu",
                        verbose=False)


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_settings_cover_the_listed_fields():
    """The key is the module's fields, the problem, c(x) and the stage, and
    every case above changes one of them."""
    s = solver({})
    assert set(checkpoint._settings(s)) == set(
        checkpoint.SETTINGS_FIELDS) | {"problem", "reaction",
                                       "spectral_stage"} == set(CASES)


@pytest.mark.parametrize("entry", list(CASES))
def test_changed_setting_moves_phi_and_is_refused(entry, tmp_path,
                                                  monkeypatch):
    shared, change, problem = CASES[entry]
    first, second = (problem if isinstance(problem, tuple)
                     else (problem, problem))
    if entry == "smallk_dirs":
        # the float32 direction rule at every Gram size, in float64
        monkeypatch.setattr(basis, "smallk_k_eff",
                            lambda cD, dtype, dirs: dirs)
    a = solver(shared, first)
    a.compute_basis()
    a.assemble_coarse_operator()
    path = checkpoint.save_basis(a, str(tmp_path / "basis.npz"))
    if entry == "spectral_stage":
        # the card's resolution of "auto" in float32
        monkeypatch.setattr(lod, "spectral_mode", lambda cfg, dev: "smallk")
    b = solver(dict(shared, **change), second)
    assert checkpoint._config_fingerprint(b.cfg, b.C) == \
        checkpoint._config_fingerprint(a.cfg, a.C)
    b.compute_basis()
    assert rel(b.Phi, a.Phi) >= MOVE
    phi = b.Phi
    assert not checkpoint.load_basis(b, path)
    assert b.Phi is phi and not hasattr(b, "A_stencil")
    monkeypatch.undo()
    again = solver(shared, first)
    assert checkpoint.load_basis(again, path)
    np.testing.assert_array_equal(again.A_stencil.numpy(),
                                  a.A_stencil.numpy())


def test_callable_reaction_is_never_trusted(tmp_path):
    """A callable c(x) cannot be compared: its file is refused, also by a
    solver with the very same callable."""
    def c(x):
        return 1.0 + x[..., 0]

    a = solver(dict(reaction=c), "reaction")
    a.compute_basis()
    path = checkpoint.save_basis(a, str(tmp_path / "basis.npz"))
    assert not checkpoint.load_basis(solver(dict(reaction=c), "reaction"),
                                     path)


def test_files_move_between_the_packages(tmp_path):
    """A port file (with ``settings``) loads into the JAX package; a JAX
    file (without) loads into the port on the fingerprint alone, even into
    a solver whose settings differ."""
    kw = dict(BASE, eig_solver="jacobi")
    ps = solver({"eig_solver": "jacobi"})
    ps.compute_basis()
    ps.assemble_coarse_operator()
    pf = checkpoint.save_basis(ps, str(tmp_path / "port.npz"))
    with np.load(pf) as z:
        assert "settings" in z
    jcfg = JaxConfig(**kw)
    jl = JaxLOD(jcfg, JaxDiffusion(jcfg), verbose=False)
    assert jax_checkpoint.load_basis(jl, pf)
    for name in ("Phi", "APhi", "A_stencil"):
        np.testing.assert_array_equal(np.asarray(getattr(jl, name)),
                                      getattr(ps, name).numpy())
    js = JaxLOD(jcfg, JaxDiffusion(jcfg), verbose=False)
    js.compute_basis()
    js.assemble_coarse_operator()
    jf = jax_checkpoint.save_basis(js, str(tmp_path / "jax.npz"))
    with np.load(jf) as z:
        assert "settings" not in z
    for change in ({}, dict(eig_tol=0.5)):
        pl = solver(dict(eig_solver="jacobi", **change))
        assert checkpoint.load_basis(pl, jf)
        for name in ("Phi", "APhi", "A_stencil"):
            np.testing.assert_array_equal(getattr(pl, name).numpy(),
                                          np.asarray(getattr(js, name)))
