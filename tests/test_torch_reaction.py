"""Reaction-diffusion (-div(alpha grad u) + c u = f) in the port against the
JAX package, float64 on the CPU, on inputs made from a numpy seed: the
subcell matrices, the bands and the fine operator with the mass term
("creact"), the step (plain LOD and SLOD in 2D, and the 3D main-path route
with the JAX side forced onto it), ``run()``'s tables, the CLI-level
problem and a basis file moved between the packages; and the JAX suite's
physics checks (``tests/test_reaction.py``) on the port: convergence, the
inhomogeneous Dirichlet lifting through the mass term, and a symmetric
coarse operator when c(x) varies under constant alpha (no stiffness
cache, no patch dedup)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dealii_slod_tpu_torch as pt
from dealii_slod_tpu import grid as jax_grid
from dealii_slod_tpu.models import LODSolver as JaxLOD
from dealii_slod_tpu.models import ReactionDiffusionProblem as JaxReaction
from dealii_slod_tpu.ops import assembly as jax_assembly
from dealii_slod_tpu.ops.element import ElementTensors as JaxElementTensors
from dealii_slod_tpu.utils import checkpoint as jax_checkpoint
from dealii_slod_tpu_torch.grid import GridSpec, global_connectivity
from dealii_slod_tpu_torch.ops import assembly
from dealii_slod_tpu_torch.ops.element import ElementTensors
from dealii_slod_tpu_torch.utils import checkpoint
from tests.test_torch_run import TABLES, pair_configs, rel

torch.set_num_threads(2)

TIGHT = (200, 1e-12, 1e-12)


def coefficients(rng, *shape):
    return {"alpha": rng.uniform(1.0, 5.0, shape),
            "creact": rng.uniform(0.0, 3.0, shape)}


@pytest.mark.parametrize("dim", [2, 3])
def test_subcell_matrices_and_bands_match_jax(dim):
    """``make_subcell_matrices`` (stiffness plus the creact-weighted mass
    term) and the bands of a 4^dim-subcell patch to 1e-12 relative; the
    mass term is the difference from the alpha-only matrices."""
    rng = np.random.default_rng(dim)
    h, nq = 0.25, 2 ** dim
    et, jet = ElementTensors(dim, h), JaxElementTensors(dim, h)
    c = coefficients(rng, 4 ** dim, nq)
    K = assembly.make_subcell_matrices(
        et, {k: torch.as_tensor(v) for k, v in c.items()})
    jK = jax_assembly.make_subcell_matrices(
        jet, {k: jnp.asarray(v) for k, v in c.items()})
    assert rel(K, jK) <= 1e-12
    K0 = assembly.make_subcell_matrices(
        et, {"alpha": torch.as_tensor(c["alpha"])})
    mass = torch.einsum("sq,qij->sij", torch.as_tensor(c["creact"]),
                        torch.as_tensor(et.M))
    assert rel(K - K0, mass) <= 1e-12
    band = assembly.assemble_bands(
        {k: torch.as_tensor(v)[None] for k, v in c.items()},
        assembly.make_band_tensors(et), (4,) * dim)
    jband = jax_assembly.assemble_bands(
        {k: jnp.asarray(v) for k, v in c.items()},
        jax_assembly.make_band_tensors(jet), (4,) * dim)
    assert rel(band[0], np.asarray(jband).reshape(band.shape[1:])) <= 1e-12


@pytest.mark.parametrize("dim", [2, 3])
def test_fine_operator_matches_jax(dim):
    """``FineOperator`` with {alpha, creact}: the unconstrained and the
    constrained matvec and the diagonal, to 1e-12 relative."""
    rng = np.random.default_rng(10 + dim)
    g, jg = GridSpec(dim, 2, 2, 1), jax_grid.GridSpec(dim, 2, 2, 1)
    et, jet = ElementTensors(dim, g.h), JaxElementTensors(dim, jg.h)
    conn = global_connectivity(g)
    c = coefficients(rng, len(conn), 2 ** dim)
    mask = g.boundary_node_mask()
    op = assembly.FineOperator(et, torch.as_tensor(conn),
                               {k: torch.as_tensor(v) for k, v in c.items()},
                               dirichlet_mask=torch.as_tensor(mask))
    jop = jax_assembly.FineOperator(
        jg, jet, conn, {k: jnp.asarray(v) for k, v in c.items()},
        dirichlet_mask=jnp.asarray(mask))
    u = rng.standard_normal((g.n_nodes, 1))
    assert rel(op(torch.as_tensor(u)), jop(jnp.asarray(u))) <= 1e-12
    assert rel(op._apply_raw(torch.as_tensor(u)),
               jop._apply_raw(jnp.asarray(u))) <= 1e-12
    assert rel(op.diagonal(), jop.diagonal()) <= 1e-12


def step_kwargs(**kw):
    base = dict(n_subdivisions=2, lod_stabilization=True,
                constant_coefficients=False, coef_seed=3, coef_refinement=3,
                rhs="1", bc="x + 2 * y", reaction="1 + x", dtype="float64",
                patch_chunk=32, solve_fine_problem=False, coarse_solver=TIGHT,
                eig_solver="jacobi", patch_solver="fused", trace_kernel="on",
                trace_impl="c1")
    base.update(kw)
    return base


def steps(**kw):
    """The step of both packages on the same configuration -> (port u,
    A_st, prolonged field), (JAX's), the port's solver."""
    jcfg, cfg = pair_configs(**step_kwargs(**kw))
    js = JaxLOD(jcfg, JaxReaction(jcfg), verbose=False)
    js.assemble_fine_rhs()
    ju, jA = js.build_step()(js.coef_q, js.fem_rhs)
    js.compute_basis()
    js.coarse_solution = ju
    s = pt.LODSolver(cfg, pt.ReactionDiffusionProblem(cfg), device="cpu",
                     verbose=False, eig_block=1)
    s.assemble_fine_rhs()
    assert rel(s.fem_rhs, js.fem_rhs) <= 1e-12
    u, A_st = s.build_step()(s.coef_q, s.fem_rhs)
    return ((u, A_st, s.prolong_lod_solution()),
            (ju, jA, js.prolong_lod_solution()), s)


@pytest.mark.parametrize("slod", [False, True], ids=["lod", "slod"])
def test_reaction_step_matches_jax(slod):
    """2D refine-2 l=1 with c = 1 + x: u, A_st and the prolonged field to
    1e-10, plain LOD and SLOD (the Jacobi stage, each matrix stopping on
    its own); the varying c turns the patch dedup off."""
    port, ref, s = steps(dim=2, n_global_refinements=2, oversampling=1,
                         lod_stabilization=slod)
    for a, b in zip(port, ref):
        assert rel(a, b) <= 1e-10
    assert s.basis_patches == s.topo.n_patches == 16


def test_reaction_main_route_3d_matches_jax():
    """3D refine-2 l=1 (64 patches) on the main-path route: the fused patch
    solve (K1's plain version), the trace (K3's) and the smallk stage, JAX
    forced onto the same route (fused, smallk, trace kernel on); u, A_st
    within ``tests/test_torch_slice.py``'s 3D bound (1e-9), the prolonged
    field too."""
    port, ref, s = steps(dim=3, n_global_refinements=2, oversampling=1,
                         eig_solver="smallk", smallk_tol=3e-6)
    assert s.spec_mode == "smallk" and s.solver_mode == "fused"
    for a, b in zip(port, ref):
        assert rel(a, b) <= 1e-9


MANUFACTURED = dict(
    dim=2, n_subdivisions=2, lod_stabilization=True,
    constant_coefficients=True, reaction="1",
    rhs="(2*pi^2 + 1)*sin(pi*x)*sin(pi*y)",
    exact_solution="sin(pi*x)*sin(pi*y)", bc="0", dtype="float64",
    solve_fine_problem=True, write_output=False,
    fine_solver=(8000, 1e-12, 1e-12), coarse_solver=(4000, 1e-12, 1e-12))


@pytest.mark.parametrize("precond", ["jacobi", "two_level"])
def test_reaction_run_matches_jax(precond):
    """``run()`` of the manufactured problem of ``tests/test_reaction.py``
    (u = sin(pi x) sin(pi y), alpha = c = 1) at refine 3, l = 2: the same
    result keys and every table to 1e-10 relative to max(|norm|, 1), as
    ``tests/test_torch_examples.py`` holds the convergence study's (the
    norms measure fields of unit size, and the eigh stage's gauge moves
    the prolonged field by ~1e-13: 1.5e-13 on the LOD-vs-FEMh Linfty
    error of 2.4e-4 here), the LOD field to 1e-10, with the fine solve on
    each preconditioner; the constant problem builds its unique windows
    only."""
    jcfg, cfg = pair_configs(**dict(MANUFACTURED, n_global_refinements=3,
                                    oversampling=2,
                                    fine_preconditioner=precond))
    ref = JaxLOD(jcfg, JaxReaction(jcfg), verbose=False).run()
    s = pt.LODSolver(cfg, pt.ReactionDiffusionProblem(cfg), device="cpu",
                     verbose=False)
    out = s.run()
    assert list(out) == list(ref)
    assert [k for k in out if k in TABLES] == [k for k in ref if k in TABLES]
    for key in (k for k in ref if k in TABLES):
        (c, d, n), (jc, jd, jn) = out[key].rows[0], ref[key].rows[0]
        assert (c, d, list(n)) == (jc, jd, list(jn)), key
        for name in jn:
            assert abs(n[name] - jn[name]) <= 1e-10 * max(abs(jn[name]), 1)
    assert rel(out["lod_solution"], ref["lod_solution"]) <= 1e-10
    assert s.problem.is_constant() and s.basis_patches < s.topo.n_patches


def test_reaction_basis_file_moves_from_jax(tmp_path):
    """A reaction basis saved by the JAX package loads into the port, whose
    coarse solve then gives JAX's solution to 1e-10 (the fingerprint does
    not cover ``cfg.reaction``, in either package)."""
    jcfg, cfg = pair_configs(**step_kwargs(dim=2, n_global_refinements=2,
                                           oversampling=1))
    js = JaxLOD(jcfg, JaxReaction(jcfg), verbose=False)
    js.compute_basis()
    js.assemble_coarse_operator()
    js.assemble_fine_rhs()
    ju = js.solve_coarse()
    path = jax_checkpoint.save_basis(js, str(tmp_path / "basis.npz"))
    s = pt.LODSolver(cfg, pt.ReactionDiffusionProblem(cfg), device="cpu",
                     verbose=False)
    assert checkpoint.load_basis(s, path)
    s.assemble_fine_rhs()
    assert rel(s.solve_coarse(), ju) <= 1e-10


def manufactured_errors(bc, exact_extra):
    """The port's fine FEM and LOD solves of the manufactured problem
    (plus ``exact_extra`` in the exact solution, ``bc`` on the boundary)
    at (refine, l) = (2, 1), (3, 2) -> the FEMh max-node errors, the
    LOD-vs-FEMh relative errors, and the last solver."""
    errs_fem, errs_lod = [], []
    for r, ell in ((2, 1), (3, 2)):
        _, cfg = pair_configs(**dict(
            MANUFACTURED, n_global_refinements=r, oversampling=ell, bc=bc,
            rhs=f"(2*pi^2 + 1)*sin(pi*x)*sin(pi*y){exact_extra}"))
        s = pt.LODSolver(cfg, pt.ReactionDiffusionProblem(cfg),
                         device="cpu", verbose=False)
        s.compute_basis()
        s.assemble_coarse_operator()
        s.assemble_fine_rhs()
        s.solve_coarse()
        s.solve_fine_fem()
        u = s.prolong_lod_solution().numpy()
        uf = s.fem_solution.numpy()
        x = s.grid.node_coords()
        exact = np.sin(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1])
        if exact_extra:
            exact = exact + x[:, 1]
        errs_fem.append(np.abs(uf[:, 0] - exact).max())
        errs_lod.append(np.linalg.norm(u - uf) / np.linalg.norm(uf))
    return errs_fem, errs_lod, s


def test_reaction_manufactured_convergence():
    """u = sin(pi x) sin(pi y), alpha = c = 1: FEMh converges at second
    order (> 3.5x per halving) and LOD tracks FEMh (> 4x)."""
    errs_fem, errs_lod, _ = manufactured_errors("0", "")
    assert errs_fem[0] / errs_fem[1] > 3.5, errs_fem
    assert errs_lod[0] / errs_lod[1] > 4, errs_lod


def test_reaction_inhomogeneous_dirichlet():
    """g = y on the boundary through the reaction path (the lifting carries
    the mass term): exact u = sin(pi x) sin(pi y) + y, f = (2 pi^2 + 1)
    sin sin + y; boundary values to 1e-12 and LOD-vs-FEMh decaying > 4x."""
    _, errs_lod, s = manufactured_errors("y", " + y")
    u = s.lod_solution.numpy()
    x = s.grid.node_coords()
    bnd = s.grid.boundary_node_mask()
    np.testing.assert_allclose(u[bnd, 0], x[bnd, 1], atol=1e-12)
    assert errs_lod[0] / errs_lod[1] > 4, errs_lod


def test_reaction_varying_c_with_constant_alpha_symmetric():
    """constant_coefficients=True (constant alpha) with c = 1 + x: the
    stiffness cache and the patch dedup must not fire (c(x) makes the
    patch operators translation-variant); the coarse operator is symmetric
    to 1e-12 of its scale and equals JAX's (whose suite holds it to the
    explicit triple product) to 1e-10."""
    kw = dict(dim=2, n_global_refinements=2, n_subdivisions=2,
              oversampling=1, lod_stabilization=False,
              constant_coefficients=True, reaction="1 + x", rhs="1",
              bc="0", dtype="float64", write_output=False)
    jcfg, cfg = pair_configs(**kw)
    js = JaxLOD(jcfg, JaxReaction(jcfg), verbose=False)
    js.compute_basis()
    jA = np.asarray(js.assemble_coarse_operator())
    s = pt.LODSolver(cfg, pt.ReactionDiffusionProblem(cfg), device="cpu",
                     verbose=False)
    assert not s.problem.is_constant() and not s._stiffness_cache_ok()
    s.compute_basis()
    assert s.basis_patches == s.topo.n_patches
    A_st = s.assemble_coarse_operator()
    assert rel(A_st, jA) <= 1e-10
    A = s.coarse_dense_matrix(A_st).numpy()
    scale = np.abs(A).max()
    assert np.abs(A - A.T).max() < 1e-12 * scale


@pytest.mark.parametrize("reaction, constant", [
    ("1", True), ("1 + x", True), ("2 * y + z", True), ("3", False)])
def test_reaction_problem_copy_matches_jax(reaction, constant):
    """``models/reaction.py`` is a copy of the JAX package's: the same
    coefficient values at 3D points and the same ``is_constant`` (constant
    only when alpha is constant and c has no x, y or z)."""
    kw = dict(dim=3, reaction=reaction, constant_coefficients=constant,
              coef_seed=4, coef_refinement=3)
    jcfg, cfg = pair_configs(**kw)
    p, jp = pt.ReactionDiffusionProblem(cfg), JaxReaction(jcfg)
    pts = np.random.default_rng(5).uniform(0, 1, (40, 3))
    c, jc = p.coefficients(pts), jp.coefficients(pts)
    assert sorted(c) == sorted(jc) == ["alpha", "creact"]
    for k in c:
        np.testing.assert_array_equal(c[k], jc[k])
    assert p.is_constant() == jp.is_constant() == (
        constant and reaction in ("1", "3"))
