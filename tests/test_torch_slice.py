"""The port's whole ``build_step`` against the JAX package's, float64 on
the CPU, on the routes the port implements (the JAX side forced onto them:
fused patch solver, the C=1 trace kernel, and the Jacobi or the smallk
spectral stage).  Both sides' configs are built from one dict of keyword
arguments, each package's own ``SLODConfig``.

Configs: 3D refine-2 l=1 s=2 and 2D refine-3 l=2 s=2 (64 patches each),
and 2D refine-2 l=1 with a constant field (16 patches), on the Jacobi
route; the first two again on the smallk route (``smallk_tol=3e-6``), and
3D once more with the fused W stage (``smallk_weig=True``).  The 2D
configs' Grams carry eigenvalue clusters at the jitter floor whose
eigenvectors rounding picks, and the SLOD truncation amplifies them into
the basis (a gauge: u and A_st change, the prolonged field does not): JAX
itself moves u by ~6e-7 when its coefficients move by 1e-15 relative.  So
the 2D bounds are self-calibrated: 10x JAX's own change under that input
change, measured in the test, and never below 1e-9.  The prolonged field
does not move on the Jacobi route (~6e-13), but on the smallk route the
subspace iteration's unconverged directions reach it too: JAX's own 2D
field moves by ~1.1e-9 to 1.4e-9 there."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dealii_slod_tpu_torch as pt
from dealii_slod_tpu.config import ReductionControl as JaxRC
from dealii_slod_tpu.config import SLODConfig as JaxConfig
from dealii_slod_tpu.models import DiffusionProblem as JaxDiffusion
from dealii_slod_tpu.models import LODSolver as JaxLOD
from dealii_slod_tpu.models.basis import smallk_k_eff as jax_k_eff
from dealii_slod_tpu_torch.models.basis import smallk_k_eff
from dealii_slod_tpu_torch.models.coarse import CoarseSystem

torch.set_num_threads(2)

SMALLK = dict(eig_solver="smallk", smallk_tol=3e-6)
CONFIGS = {"3d-r2-l1": dict(dim=3, n_global_refinements=2, oversampling=1),
           "2d-r3-l2": dict(dim=2, n_global_refinements=3, oversampling=2),
           # constant field: the coefficient gather with the reference's
           # full-size-patch stiffness cache instead of the windows
           "2d-r2-l1-const": dict(dim=2, n_global_refinements=2,
                                  oversampling=1, constant_coefficients=True),
           "3d-r2-l1-smallk": dict(dim=3, n_global_refinements=2,
                                   oversampling=1, **SMALLK),
           "2d-r3-l2-smallk": dict(dim=2, n_global_refinements=3,
                                   oversampling=2, **SMALLK),
           "3d-r2-l1-weig": dict(dim=3, n_global_refinements=2,
                                 oversampling=1, smallk_weig=True, **SMALLK)}


def slice_kwargs(**kw):
    """Keyword arguments of both packages' ``SLODConfig`` (the solver
    controls as a (max_steps, tolerance, reduce) triple)."""
    base = dict(n_subdivisions=2, lod_stabilization=True,
                constant_coefficients=False, coef_seed=3, coef_refinement=3,
                rhs="1", bc="x + 2 * y", dtype="float64", patch_chunk=32,
                solve_fine_problem=False, coarse_solver=(200, 1e-12, 1e-12),
                eig_solver="jacobi", patch_solver="fused", trace_kernel="on",
                trace_impl="c1", fused_block=4, fused_nb=64, eig_sweeps=12,
                eig_tol=3e-6)
    base.update(kw)
    return base


def configs(kw):
    """(JAX config, port config) from one dict of keyword arguments."""
    rc = kw["coarse_solver"]
    return (JaxConfig(**dict(kw, coarse_solver=JaxRC(*rc))),
            pt.SLODConfig(**dict(kw, coarse_solver=pt.ReductionControl(*rc))))


def rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    jcfg, cfg = configs(slice_kwargs(**CONFIGS[request.param]))
    js = JaxLOD(jcfg, JaxDiffusion(jcfg), verbose=False)
    js.assemble_fine_rhs()
    step = jax.jit(js.build_step())
    ju, jA = step(js.coef_q, js.fem_rhs)
    # the reference's own sensitivity to a 1e-15 relative input change
    rng = np.random.default_rng(0)
    pert = {k: v * (1 + 1e-15 * rng.standard_normal(v.shape))
            for k, v in js.coef_q.items()}
    pu, pA = step(pert, js.fem_rhs)
    sens = max(rel(pu, ju), rel(pA, jA))
    js.compute_basis()
    js.coarse_solution = ju
    jfield = js.prolong_lod_solution()
    field_sens = 0.0
    if jcfg.dim == 2:
        jp = JaxLOD(jcfg, JaxDiffusion(jcfg), verbose=False)
        jp.assemble_fine_rhs()
        jp.coef_q = pert
        jp.compute_basis()
        jp.coarse_solution = pu
        field_sens = rel(jp.prolong_lod_solution(), jfield)

    ps = pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device="cpu",
                      verbose=False)
    ps.assemble_fine_rhs()
    u, A_st = ps.build_step()(ps.coef_q, ps.fem_rhs)
    field = ps.prolong_lod_solution()
    return dict(name=request.param, cfg=cfg, js=js, ju=np.asarray(ju),
                jA=np.asarray(jA), jfield=np.asarray(jfield), ps=ps, u=u,
                A_st=A_st, field=field, sens=sens, field_sens=field_sens)


def bound(pair, sens="sens"):
    return 1e-9 if pair["name"].startswith("3d") else max(1e-9,
                                                          10 * pair[sens])


def test_step_matches_jax(pair):
    """u (P, 1) and A_st (P, S, 1, 1) of one step, and a converged CG."""
    assert pair["u"].shape == pair["ju"].shape
    assert pair["A_st"].shape == pair["jA"].shape
    assert rel(pair["u"], pair["ju"]) <= bound(pair)
    assert rel(pair["A_st"], pair["jA"]) <= bound(pair)
    assert bool(pair["ps"].coarse_cg.converged)


def test_prolonged_field_matches_jax(pair):
    """lod_solution = C u + g (inhomogeneous Dirichlet data)."""
    assert rel(pair["field"], pair["jfield"]) <= bound(pair, "field_sens")


def test_fine_rhs_and_coefficients_match_jax(pair):
    """The port's own coef_q and eliminated fine rhs, and load_state's
    carry-over of JAX's, to 1e-13."""
    js, ps = pair["js"], pair["ps"]
    jcoef = {k: np.asarray(v) for k, v in js.coef_q.items()}
    state = pt.load_state(jcoef, np.asarray(js.fem_rhs), "cpu",
                          torch.float64)
    assert rel(ps.coef_q["alpha"], jcoef["alpha"]) <= 1e-13
    assert rel(ps.fem_rhs, np.asarray(js.fem_rhs)) <= 1e-13
    assert rel(state.coef_q["alpha"], ps.coef_q["alpha"].numpy()) <= 1e-13
    assert rel(state.fem_rhs, ps.fem_rhs.numpy()) <= 1e-13


def test_coarse_stages_on_jax_basis(pair):
    """The stencil coarse operator and the coarse CG fed JAX's basis
    canvases through load_state: A_st and u to 1e-10 (no spectral stage
    in between, so no cluster sensitivity)."""
    js = pair["js"]
    state = pt.load_state({k: np.asarray(v) for k, v in js.coef_q.items()},
                          np.asarray(js.fem_rhs), "cpu", torch.float64,
                          Phi=np.asarray(js.Phi), APhi=np.asarray(js.APhi))
    ps = pt.LODSolver(pair["cfg"], pt.DiffusionProblem(pair["cfg"]),
                      device="cpu", verbose=False)
    ps.Phi, ps.APhi, ps.fem_rhs = state.Phi, state.APhi, state.fem_rhs
    A_st = ps.assemble_coarse_operator()
    u = ps.solve_coarse()
    assert rel(A_st, pair["jA"]) <= 1e-10
    assert rel(u, pair["ju"]) <= 1e-10


def test_stencil_matvec_equals_dense(pair):
    """Above ``coarse_dense_cap`` the coarse CG's matvec gathers stencil
    neighbours instead of embedding the dense matrix: the same operator."""
    ps = pair["ps"]
    cfg0 = dataclasses.replace(ps.cfg, coarse_dense_cap=0)
    p0 = pt.LODSolver(cfg0, pt.DiffusionProblem(cfg0), device="cpu",
                      verbose=False)
    u = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (ps.topo.n_patches, 1)))
    dense = CoarseSystem(ps, pair["A_st"]).matvec(u)
    assert rel(CoarseSystem(p0, pair["A_st"]).matvec(u),
               dense.numpy()) <= 1e-13


def test_smallk_route_taken(pair):
    """The smallk configs run the smallk stage (k_eff = all cD directions
    here, trimmed to even), the others the Jacobi stage."""
    mode = "smallk" if "smallk" in pair["name"] or "weig" in pair["name"] \
        else "jacobi"
    assert pair["ps"].spec_mode == mode


@pytest.mark.parametrize("cD, dtype, dirs", [
    (50, "float32", 32), (125, "float32", 32), (125, "float64", 32),
    (375, "float32", 32)])
def test_smallk_k_eff_matches_jax(cD, dtype, dirs):
    assert smallk_k_eff(cD, getattr(torch, dtype), dirs) == jax_k_eff(
        cD, jnp.dtype(dtype), dirs)
