"""The port's linear-elasticity path (C = dim components) against the JAX
package's, float64 on the CPU: the C > 1 band assembly and dense
embedding, the mu / lambda fine operator, the Lame fields, and the whole
``build_step`` on the route the port runs (the JAX side forced onto it:
the Schur-split patch solver, the C-generic trace kernel in interpret
mode, the smallk spectral stage).  Both sides' configs are built from one
dict of keyword arguments, each package's own ``SLODConfig``.

Configs: 3D refine-2 l=1 (64 patches, C = 3, one split leaf (375, 81))
and 2D refine-3 l=2 (64 patches, C = 2).  The 2D l=2 Grams carry
eigenvalue clusters at the jitter floor (the gauge of ROADMAP.md Queue 3),
so there u and A_st are bounded by 10x JAX's own change under a 1e-15
relative input change, measured here, and never below 1e-9; the same for
the prolonged field where JAX's own change exceeds 1e-10."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dealii_slod_tpu_torch as pt
from dealii_slod_tpu.config import ReductionControl as JaxRC
from dealii_slod_tpu.config import SLODConfig as JaxConfig
from dealii_slod_tpu.grid import GridSpec as JaxGrid
from dealii_slod_tpu.grid import global_connectivity
from dealii_slod_tpu.models import LODSolver as JaxLOD
from dealii_slod_tpu.models.elasticity import ElasticityProblem as JaxElast
from dealii_slod_tpu.ops import assembly as jax_assembly
from dealii_slod_tpu.ops.element import ElementTensors as JaxElement
from dealii_slod_tpu.ops.element import quad_points_global
from dealii_slod_tpu_torch.models.coarse import CoarseSystem
from dealii_slod_tpu_torch.ops import assembly, patch_solve
from dealii_slod_tpu_torch.ops.element import ElementTensors

torch.set_num_threads(2)

CONFIGS = {"3d-r2-l1": dict(dim=3, n_global_refinements=2, oversampling=1,
                            rhs="1; 1; 1"),
           "2d-r3-l2": dict(dim=2, n_global_refinements=3, oversampling=2,
                            rhs="1; 1")}


def elastic_kwargs(**kw):
    """Keyword arguments of both packages' ``SLODConfig`` (the solver
    controls as a (max_steps, tolerance, reduce) triple)."""
    base = dict(n_subdivisions=2, lod_stabilization=True,
                constant_coefficients=False, coef_seed=3, coef_refinement=3,
                bc="x; y" if kw.get("dim") == 2 else "0", dtype="float64",
                patch_chunk=32, solve_fine_problem=False,
                coarse_solver=(200, 1e-12, 1e-12), eig_solver="smallk",
                smallk_tol=3e-6, patch_solver="fused_split",
                trace_kernel="on", eig_sweeps=12, eig_tol=3e-6)
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


# ---------------------------------------------------------------------------
# Assembly at C > 1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [2, 3])
def test_bands_and_dense_embedding_match_jax(dim):
    """C = dim: the (lam, mu) bands (flat column o*C*C + c*C + d) and the
    component-interleaved banded-stride dense matrix, to 1e-14 (the
    embedding moves values)."""
    rng = np.random.default_rng(dim)
    sub_dims = np.array([4, 3, 5][:dim])
    n_sub, nq = int(sub_dims.prod()), 2 ** dim
    coefs = {k: rng.uniform(1, 10, (n_sub, nq)) for k in ("lam", "mu")}
    tens = assembly.make_band_tensors(ElementTensors(dim, 0.125, dim))
    jtens = jax_assembly.make_band_tensors(JaxElement(dim, 0.125, dim))
    assert sorted(tens) == sorted(jtens) == ["lam", "mu"]
    for k in tens:
        np.testing.assert_array_equal(tens[k], jtens[k])
    band = assembly.assemble_bands(
        {k: torch.from_numpy(v)[None] for k, v in coefs.items()}, tens,
        sub_dims)[0]
    jband = np.asarray(jax_assembly.assemble_bands(
        {k: jnp.asarray(v) for k, v in coefs.items()}, jtens, sub_dims))
    n_nodes = int((sub_dims + 1).prod())
    assert band.shape == (n_nodes, 3 ** dim * dim * dim)
    assert rel(band, jband.reshape(n_nodes, -1)) <= 1e-14
    place = assembly.band_placement_matrix(sub_dims + 1)
    dense = assembly.bands_to_dense_mm(
        band.reshape(1, n_nodes, 3 ** dim, dim, dim), *place)[0]
    jdense = np.asarray(jax_assembly.bands_to_dense_mm(jnp.asarray(jband),
                                                       *place))
    assert dense.shape == (n_nodes * dim, n_nodes * dim)
    assert rel(dense, jdense) <= 1e-14
    np.testing.assert_allclose(dense.numpy(), dense.numpy().T, atol=1e-12)


@pytest.mark.parametrize("dim", [2, 3])
def test_fine_operator_matches_jax(dim):
    """The unconstrained mu / lambda matvec on the fine grid, (n_nodes, C)
    -> (n_nodes, C), to 1e-13."""
    grid = JaxGrid(dim, 2, 2, dim)
    conn = global_connectivity(grid)
    rng = np.random.default_rng(10 + dim)
    nq = 2 ** dim
    coefs = {k: rng.uniform(1, 10, (grid.n_fine_cells, nq))
             for k in ("lam", "mu")}
    u = rng.standard_normal((grid.n_nodes, dim))
    jop = jax_assembly.FineOperator(grid, JaxElement(dim, grid.h, dim),
                                    conn, {k: jnp.asarray(v)
                                           for k, v in coefs.items()})
    op = assembly.FineOperator(ElementTensors(dim, grid.h, dim),
                               torch.from_numpy(conn),
                               {k: torch.from_numpy(v)
                                for k, v in coefs.items()})
    out = op._apply_raw(torch.from_numpy(u))
    assert out.shape == (grid.n_nodes, dim)
    assert rel(out, jop._apply_raw(jnp.asarray(u))) <= 1e-13


@pytest.mark.parametrize("parity", [False, True])
@pytest.mark.parametrize("refine", [3, 8])
def test_elasticity_problem_fields_match_jax(parity, refine):
    """lam and mu at the quadrature points, with and without the
    reference's shared glibc rand() stream (and the coef_refinement
    8 -> 6 rule)."""
    kw = elastic_kwargs(dim=2, n_global_refinements=2, oversampling=1,
                        rhs="1; 1", reference_parity=parity,
                        coef_refinement=refine)
    jcfg, cfg = configs(kw)
    jp, p = JaxElast(jcfg), pt.ElasticityProblem(cfg)
    assert p.n_components == jp.n_components == 2
    assert p.cfg.coef_refinement == jp.cfg.coef_refinement
    qpts = quad_points_global(JaxGrid(2, 4, 2, 2))
    jc, c = jp.coefficients(qpts), p.coefficients(qpts)
    assert sorted(c) == ["lam", "mu"]
    for k in c:
        np.testing.assert_array_equal(np.asarray(c[k]), np.asarray(jc[k]))
    assert not np.array_equal(c["lam"], c["mu"])
    assert p.is_constant() == jp.is_constant()


# ---------------------------------------------------------------------------
# The whole step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    jcfg, cfg = configs(elastic_kwargs(**CONFIGS[request.param]))
    js = JaxLOD(jcfg, JaxElast(jcfg), verbose=False)
    js.assemble_fine_rhs()
    step = jax.jit(js.build_step())
    ju, jA = step(js.coef_q, js.fem_rhs)
    sens, field_sens = 0.0, 0.0
    js.compute_basis()
    js.coarse_solution = ju
    jfield = js.prolong_lod_solution()
    if jcfg.dim == 2:
        # the reference's own sensitivity to a 1e-15 relative input change
        rng = np.random.default_rng(0)
        pert = {k: v * (1 + 1e-15 * rng.standard_normal(v.shape))
                for k, v in js.coef_q.items()}
        pu, pA = step(pert, js.fem_rhs)
        sens = max(rel(pu, ju), rel(pA, jA))
        jp = JaxLOD(jcfg, JaxElast(jcfg), verbose=False)
        jp.assemble_fine_rhs()
        jp.coef_q = pert
        jp.compute_basis()
        jp.coarse_solution = pu
        field_sens = rel(jp.prolong_lod_solution(), jfield)

    ps = pt.LODSolver(cfg, pt.ElasticityProblem(cfg), device="cpu",
                      verbose=False)
    ps.assemble_fine_rhs()
    u, A_st = ps.build_step()(ps.coef_q, ps.fem_rhs)
    field = ps.prolong_lod_solution()
    return dict(name=request.param, cfg=cfg, js=js, ju=np.asarray(ju),
                jA=np.asarray(jA), jfield=np.asarray(jfield), ps=ps, u=u,
                A_st=A_st, field=field, sens=sens, field_sens=field_sens)


def bound(pair, sens="sens"):
    return max(1e-9, 10 * pair[sens])


def test_step_matches_jax(pair):
    """u (P, C) and A_st (P, S, C, C) of one step, and a converged CG."""
    C = pair["cfg"].dim
    assert pair["u"].shape == pair["ju"].shape == (64, C)
    assert pair["A_st"].shape == pair["jA"].shape
    assert pair["A_st"].shape[-2:] == (C, C)
    assert rel(pair["u"], pair["ju"]) <= bound(pair)
    assert rel(pair["A_st"], pair["jA"]) <= bound(pair)
    assert bool(pair["ps"].coarse_cg.converged)


def test_prolonged_field_matches_jax(pair):
    """lod_solution = C u + g, (n_nodes, C)."""
    assert pair["field"].shape == pair["jfield"].shape
    assert rel(pair["field"], pair["jfield"]) <= bound(pair, "field_sens")


def test_fine_rhs_and_coefficients_match_jax(pair):
    """The port's own lam, mu and eliminated (n_nodes, C) fine rhs, to
    1e-13."""
    js, ps = pair["js"], pair["ps"]
    for k in ("lam", "mu"):
        assert rel(ps.coef_q[k], np.asarray(js.coef_q[k])) <= 1e-13
    assert ps.fem_rhs.shape == (ps.grid.n_nodes, pair["cfg"].dim)
    assert rel(ps.fem_rhs, np.asarray(js.fem_rhs)) <= 1e-13


def test_load_state_round_trips_jax_state(pair):
    """load_state carries the JAX solver's lam, mu and (n_nodes, C) rhs
    exactly, and with JAX's basis canvases the port's stencil build and
    coarse CG give JAX's A_st and u to 1e-10."""
    js = pair["js"]
    jcoef = {k: np.asarray(v) for k, v in js.coef_q.items()}
    state = pt.load_state(jcoef, np.asarray(js.fem_rhs), "cpu",
                          torch.float64, Phi=np.asarray(js.Phi),
                          APhi=np.asarray(js.APhi))
    assert sorted(state.coef_q) == ["lam", "mu"]
    for k in jcoef:
        np.testing.assert_array_equal(state.coef_q[k].numpy(), jcoef[k])
    np.testing.assert_array_equal(state.fem_rhs.numpy(),
                                  np.asarray(js.fem_rhs))
    ps = pt.LODSolver(pair["cfg"], pt.ElasticityProblem(pair["cfg"]),
                      device="cpu", verbose=False)
    ps.Phi, ps.APhi, ps.fem_rhs = state.Phi, state.APhi, state.fem_rhs
    A_st = ps.assemble_coarse_operator()
    u = ps.solve_coarse()
    assert rel(A_st, pair["jA"]) <= 1e-10
    assert rel(u, pair["ju"]) <= 1e-10


def test_stencil_matvec_equals_dense(pair):
    """The (P C)^2 dense coarse matrix (below ``coarse_dense_cap``, these
    configs) and the stencil matvec (above it, the 4096-patch path) are
    the same operator."""
    ps = pair["ps"]
    cfg0 = dataclasses.replace(ps.cfg, coarse_dense_cap=0)
    p0 = pt.LODSolver(cfg0, pt.ElasticityProblem(cfg0), device="cpu",
                      verbose=False)
    u = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (ps.topo.n_patches, ps.C)))
    dense = CoarseSystem(ps, pair["A_st"]).matvec(u)
    assert rel(CoarseSystem(p0, pair["A_st"]).matvec(u),
               dense.numpy()) <= 1e-13


def test_route_taken(pair):
    """The Schur split with the reference's leaves, smallk on all
    directions (float64)."""
    ps = pair["ps"]
    tab = ps._uniform_tables()
    assert ps.solver_mode == "fused_split" and ps.spec_mode == "smallk"
    assert patch_solve.split_leaves(tab.nI, tab.cD, tab.panel_nb) == [
        (tab.nI, tab.cD)]
    assert tab.k_eff == tab.cD
