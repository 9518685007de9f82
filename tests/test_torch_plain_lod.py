"""The port's plain LOD basis, its ``eigh`` spectral stage
(``eig_solver="lapack"`` / ``"lax"``) and the per-patch Cholesky solve
(``patch_solver="lax"``) against the JAX package, float64 on the CPU.

The JAX side runs its own CPU routes: the per-patch Cholesky solve and
Cholesky T^-1 inside its vmapped patch function, ``jnp.linalg.eigh`` on each
Gram.  The port runs K1's and K2's plain versions (or, under
``patch_solver="lax"``, its own per-patch Cholesky solve), and
``torch.linalg.eigh`` on the chunk's Grams.

Plain LOD has no spectral stage: Phi, A phi, A_st, u and the prolonged
field match to 1e-10 relative.  On the eigh route the Grams' near-null
directions (the masked centre and outside cells, eigenvalues ~n eps
lambda_0, above the 1e-15 truncation) are resolved differently by the two
LAPACKs, and the SLOD truncation carries that into the basis as a gauge:
u and A_st move, the prolonged field barely does.  So the eigh bounds are
self-calibrated as in ``tests/test_torch_slice.py``: 10x JAX's own change
when its coefficients move by 1e-15 relative, measured in the test, and
never below 1e-10.  Measured once on this suite's configs (JAX's own
change / port against JAX): 2D refine-3 l=2 u 8.8e-6 / 5.8e-6, Phi
5.7e-6 / 5.5e-6, field 1.2e-11 / 5.9e-12; 3D refine-2 l=1 u 6.0e-12 /
1.3e-11, field 1.9e-15 / 3.2e-15."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dealii_slod_tpu_torch as pt
from dealii_slod_tpu.config import ReductionControl as JaxRC
from dealii_slod_tpu.config import SLODConfig as JaxConfig
from dealii_slod_tpu.models import DiffusionProblem as JaxDiffusion
from dealii_slod_tpu.models import LODSolver as JaxLOD

torch.set_num_threads(2)

PLAIN = dict(lod_stabilization=False)
EIGH = dict(lod_stabilization=True)
# name -> (keyword arguments of both configs, port-only keyword arguments)
CASES = {
    "plain-2d-r2-l1": (dict(dim=2, n_global_refinements=2, oversampling=1,
                            **PLAIN), {}),
    "plain-3d-r2-l1": (dict(dim=3, n_global_refinements=2, oversampling=1,
                            **PLAIN), {}),
    "plain-2d-r2-l1-lax": (dict(dim=2, n_global_refinements=2,
                                oversampling=1, **PLAIN),
                           dict(patch_solver="lax")),
    # l = 0: the patch is the cell (s = 4 leaves 3 interior nodes an axis)
    "plain-2d-r2-l0-s4": (dict(dim=2, n_global_refinements=2,
                               oversampling=0, n_subdivisions=4, **PLAIN),
                          {}),
    "lapack-2d-r3-l2": (dict(dim=2, n_global_refinements=3, oversampling=2,
                             eig_solver="lapack", **EIGH), {}),
    "lapack-3d-r2-l1": (dict(dim=3, n_global_refinements=2, oversampling=1,
                             eig_solver="lapack", **EIGH), {}),
    "lax-2d-r3-l2": (dict(dim=2, n_global_refinements=3, oversampling=2,
                          eig_solver="lax", **EIGH), {}),
    "lax-3d-r2-l1-lax": (dict(dim=3, n_global_refinements=2, oversampling=1,
                              eig_solver="lax", **EIGH),
                         dict(patch_solver="lax")),
}


def kwargs(**kw):
    base = dict(n_subdivisions=2, constant_coefficients=False, coef_seed=3,
                coef_refinement=3, rhs="1", bc="x + 2 * y", dtype="float64",
                patch_chunk=32, solve_fine_problem=False)
    base.update(kw)
    return base


def rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _stages(s, coef_q=None):
    """Basis, coarse operator, coarse solve and prolongation of one
    solver (JAX or port) -> (Phi, APhi, A_st, u, field)."""
    if coef_q is not None:
        s.coef_q = coef_q
    s.assemble_fine_rhs()
    s.compute_basis()
    s.assemble_coarse_operator()
    s.solve_coarse()
    s.prolong_lod_solution()
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
            for x in (s.Phi, s.APhi, s.A_stencil, s.coarse_solution,
                      s.lod_solution)]


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    common, port_only = CASES[request.param]
    kw = kwargs(**common)
    rc = (200, 1e-12, 1e-12)
    jcfg = JaxConfig(**kw, coarse_solver=JaxRC(*rc))
    cfg = pt.SLODConfig(**dict(kw, **port_only),
                        coarse_solver=pt.ReductionControl(*rc))
    js = JaxLOD(jcfg, JaxDiffusion(jcfg), verbose=False)
    jax_out = _stages(js)
    sens = [0.0] * 5
    if cfg.lod_stabilization:
        rng = np.random.default_rng(0)
        pert = {k: jnp.asarray(np.asarray(v)
                               * (1 + 1e-15 * rng.standard_normal(v.shape)))
                for k, v in js.coef_q.items()}
        jp = JaxLOD(jcfg, JaxDiffusion(jcfg), verbose=False)
        sens = [rel(a, b) for a, b in zip(_stages(jp, pert), jax_out)]
    ps = pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device="cpu",
                      verbose=False)
    return dict(name=request.param, ps=ps, port=_stages(ps), jax=jax_out,
                sens=sens)


NAMES = ("Phi", "APhi", "A_st", "u", "field")


@pytest.mark.parametrize("what", range(5), ids=NAMES)
def test_matches_jax(case, what):
    """Phi, A phi (P, nN, C, C), A_st (P, S, C, C), the coarse solution
    and the prolonged field: 1e-10 relative, or 10x JAX's own sensitivity
    where that is larger (the eigh route)."""
    port, ref = case["port"][what], case["jax"][what]
    assert port.shape == ref.shape
    bound = max(1e-10, 10 * case["sens"][what])
    assert rel(port, ref) <= bound, (NAMES[what], rel(port, ref), bound)


def test_routes_taken(case):
    """The stage each config names: plain LOD runs no spectral stage,
    "lapack" / "lax" the eigh stage; the patch solver resolves by the
    size rule ("fused") unless named."""
    ps = case["ps"]
    tab = ps._uniform_tables()
    assert tab.slod == ps.cfg.lod_stabilization
    assert ps.spec_mode == ps.cfg.eig_solver or ps.cfg.eig_solver == "auto"
    assert ps.solver_mode == ("lax" if case["name"].endswith("-lax")
                              else "fused")


def test_default_config_builds_and_steps_on_cpu():
    """``SLODConfig()`` (2D, plain LOD, float64, eig_solver "auto"): the
    "auto" stage resolves to "lapack" on the CPU, and the step gives the
    same u as the stage-by-stage run."""
    cfg = pt.SLODConfig()
    s = pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device="cpu",
                     verbose=False)
    assert s.spec_mode == "lapack" and s.solver_mode == "fused"
    s.assemble_fine_rhs()
    u, A_st = s.build_step()(s.coef_q, s.fem_rhs)
    assert u.shape == (16, 1) and A_st.shape[-2:] == (1, 1)
    assert bool(torch.isfinite(u).all()) and float(u.abs().max()) > 0
    s2 = pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device="cpu",
                      verbose=False)
    assert rel(u, _stages(s2)[3]) <= 1e-13


def test_plain_lod_is_the_centre_column():
    """Plain LOD's candidate is X T^-1 at the centre dof, normalized: the
    same canvas as SLOD's candidate formula with dvec = 0."""
    from dealii_slod_tpu_torch.models import basis
    cfg = pt.SLODConfig(**kwargs(dim=2, n_global_refinements=2,
                                 oversampling=1, lod_stabilization=False))
    s = pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device="cpu",
                     verbose=False)
    tab = s._uniform_tables()
    gsub, nlo, nhi, sides = s._uniform_inputs_t()
    cw = {"alpha": basis.coef_windows(cfg, s.grid, s.coef_q["alpha"])}
    band, A_solve, PT_m, cvd = basis.prep(tab, cw, nlo, nhi)
    X, T_raw = basis.patch_solve(tab, A_solve, PT_m)
    Tinv = basis.spd_inverse_schur(T_raw / tab.Hdim
                                   + torch.diag_embed(1.0 - cvd))
    zero = torch.zeros((X.shape[0], 1, tab.cD), dtype=X.dtype)
    plain = basis.finish_post_dvec(tab, band, X, Tinv, None, cvd, nlo, nhi,
                                   sides)
    dvec0 = basis.finish_post_dvec(tab, band, X, Tinv, zero, cvd, nlo, nhi,
                                   sides)
    for a, b in zip(plain, dvec0):
        assert rel(a, b) <= 1e-14
    cens = tab.center_cell * tab.C + torch.arange(tab.C)
    col = X @ Tinv[:, :, cens]
    col = col / torch.sqrt((col ** 2).sum(1, keepdim=True))
    assert rel(plain[0], basis.scatter_interior(tab, col).reshape(
        plain[0].shape)) <= 1e-14
