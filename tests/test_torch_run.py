"""The port's ``run()`` pipeline against the JAX package's, float64 on the
CPU: the whole run on ``SLODConfig()`` (the reference's example, with its
golden numbers), the fine FEM solve on each preconditioner route, the
coarse FEM solve on each branch, the error norms and tables, the dense
solvers and the constrained fine operator; and the physics ladder of the
verify recipe (SLOD with l ~ log2 N converges against fine FEM)."""

import numpy as np
import pytest
import torch

import dealii_slod_tpu_torch as pt
from dealii_slod_tpu import config as jax_config
from dealii_slod_tpu.models import DiffusionProblem as JaxDiffusion
from dealii_slod_tpu.models import ElasticityProblem as JaxElasticity
from dealii_slod_tpu.models import LODSolver as JaxLOD
from dealii_slod_tpu.ops import assembly as jax_assembly
from dealii_slod_tpu.ops import solvers as jax_solvers
from dealii_slod_tpu.utils import errors as jax_errors
from dealii_slod_tpu_torch.config import ParsedFunction
from dealii_slod_tpu_torch.grid import GridSpec, global_connectivity
from dealii_slod_tpu_torch.ops import assembly, solvers
from dealii_slod_tpu_torch.ops.element import (ElementTensors,
                                               quad_points_global)
from dealii_slod_tpu_torch.utils import errors

torch.set_num_threads(2)

TABLES = ("error_FEMh_exact", "error_LOD_exact", "error_LOD_FEMh",
          "error_FEMH_FEMh", "error_FEMH_exact")


def rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def pair_configs(**kw):
    """(JAX config, port config) from one dict; solver controls as
    (max_steps, tolerance, reduce) triples."""
    jkw, pkw = dict(kw), dict(kw)
    for name in ("fine_solver", "coarse_solver"):
        if name in kw:
            jkw[name] = jax_config.ReductionControl(*kw[name])
            pkw[name] = pt.ReductionControl(*kw[name])
    return jax_config.SLODConfig(**jkw), pt.SLODConfig(**pkw)


def assert_tables_match(port, ref, tol=1e-10):
    assert [k for k in port if k in TABLES] == [k for k in ref
                                                if k in TABLES]
    for key in (k for k in ref if k in TABLES):
        (c, d, n), (jc, jd, jn) = port[key].rows[0], ref[key].rows[0]
        assert (c, d, list(n)) == (jc, jd, list(jn)), key
        for name in jn:
            assert abs(n[name] - jn[name]) <= tol * abs(jn[name]), \
                (key, name, n[name], jn[name])


def test_default_run_matches_jax_and_the_golden_numbers(capsys):
    """``run()`` on ``SLODConfig()``: the reference's result keys, its
    tables to 1e-10, and the golden numbers (fem rhs l2 norm 0.109375, 81
    fine / 16 coarse dofs, 16 patches of sizes 4..9)."""
    jcfg, cfg = pair_configs()
    ref = JaxLOD(jcfg, JaxDiffusion(jcfg), verbose=False).run()
    capsys.readouterr()
    out = pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device="cpu").run()
    log = capsys.readouterr().out
    assert list(out) == list(ref)
    assert_tables_match(out, ref)
    for key in ("coarse_solution", "lod_solution", "fem_solution"):
        assert rel(out[key], ref[key]) <= 1e-10
    assert "fem rhs l2 norm = 0.109375\n" in log
    assert "size of fem u 81\n" in log and "size of u 16\n" in log
    assert "number of patches = 16 " in log
    assert "Patches size in (4, 9)" in log
    assert "SLOD vs reference FEM(h)" in log
    assert str(out["error_LOD_FEMh"]) == str(ref["error_LOD_FEMh"])


def test_elasticity_run_matches_jax():
    """2D elasticity ``run()`` (C = 2: the coarse FEM comparison runs, on
    its dense branch), SLOD on the eigh stage, constant coefficients: all
    five tables to 1e-10."""
    kw = dict(rhs="1; 1", exact_solution="0; 0", lod_stabilization=True,
              fine_solver=(2000, 1e-13, 1e-13),
              coarse_solver=(2000, 1e-13, 1e-13))
    jcfg, cfg = pair_configs(**kw)
    ref = JaxLOD(jcfg, JaxElasticity(jcfg), verbose=False).run()
    out = pt.LODSolver(cfg, pt.ElasticityProblem(cfg), device="cpu",
                       verbose=False).run()
    assert list(out) == list(ref)
    assert set(TABLES) <= set(out)
    assert_tables_match(out, ref)


FINE = {"jacobi": dict(fine_preconditioner="jacobi"),
        "two-level-dense": dict(fine_preconditioner="two_level"),
        "two-level-stencil": dict(fine_preconditioner="two_level",
                                  two_level_dense_cap=0)}


@pytest.mark.parametrize("reduce", [1e-2, 1e-12])
@pytest.mark.parametrize("route", list(FINE))
def test_solve_fine_fem_matches_jax(route, reduce):
    """The fine CG on the constrained operator with Jacobi, the dense
    two-level preconditioner (Cholesky of the densified coarse matrix) and
    the stencil one (Chebyshev of degree 16 past ``two_level_dense_cap``):
    the same iteration count and the solution to 1e-10."""
    kw = dict(dim=2, n_global_refinements=3, oversampling=1,
              constant_coefficients=False, coef_seed=3, coef_refinement=3,
              bc="x + 2 * y", fine_solver=(2000, 1e-14, reduce),
              **FINE[route])
    jcfg, cfg = pair_configs(**kw)
    sols = []
    for s in (JaxLOD(jcfg, JaxDiffusion(jcfg), verbose=False),
              pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device="cpu",
                           verbose=False)):
        s.assemble_fine_rhs()
        s.compute_basis()
        s.assemble_coarse_operator()
        s.solve_fine_fem()
        sols.append(s)
    js, ps = sols
    assert int(ps.fine_cg.n_iter) == int(js.fine_cg.n_iter)
    assert bool(ps.fine_cg.converged)
    assert rel(ps.fem_solution, js.fem_solution) <= 1e-10


def test_fine_cg_non_convergence_is_logged(capsys):
    cfg = pt.SLODConfig(fine_solver=pt.ReductionControl(2, 1e-14, 1e-14))
    s = pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device="cpu")
    s.assemble_fine_rhs()
    s.solve_fine_fem()
    assert "WARNING: fine CG did not converge in 2 iterations" in \
        capsys.readouterr().out


@pytest.mark.parametrize("dim, N", [(2, 4), (3, 16)])
def test_solve_coarse_fem_matches_jax(dim, N):
    """The Q1 coarse FEM solve and its prolongation to the fine nodes:
    the dense direct branch (2D elasticity N = 4, 50 dofs) and the CG
    branch (3D elasticity N = 16, 14739 dofs > 6000), inhomogeneous
    Dirichlet data, to 1e-10."""
    kw = dict(dim=dim, n_global_refinements=int(np.log2(N)), oversampling=1,
              constant_coefficients=False, coef_seed=3, coef_refinement=3,
              rhs="1; 1" if dim == 2 else "1; 1; 1",
              bc="x; y" if dim == 2 else "x; y; z")
    jcfg, cfg = pair_configs(**kw)
    juH, juf = JaxLOD(jcfg, JaxElasticity(jcfg),
                      verbose=False).solve_coarse_fem()
    uH, uf = pt.LODSolver(cfg, pt.ElasticityProblem(cfg), device="cpu",
                          verbose=False).solve_coarse_fem()
    assert uH.shape == juH.shape and uf.shape == juf.shape
    assert rel(uH, juH) <= 1e-10 and rel(uf, juf) <= 1e-10


def _fields(dim, C, seed):
    """A 4-cell-per-axis grid (s = 2), its element tensors, connectivity
    and quadrature points, and two random nodal fields."""
    g = GridSpec(dim, 4, 2, C)
    et = ElementTensors(dim, g.h, C)
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((g.n_nodes, C))
    v = rng.standard_normal((g.n_nodes, C))
    return g, et, global_connectivity(g), quad_points_global(g), u, v


@pytest.mark.parametrize("dim, C", [(2, 1), (3, 1), (2, 2), (3, 3)])
def test_error_norms_match_jax(dim, C):
    """Nodal against nodal and against a parsed function, numpy on both
    sides, and torch tensors handed in: each norm to 1e-13."""
    g, et, conn, qpts, u, v = _fields(dim, C, dim * C)
    spec = "; ".join(["sin(pi*x) * y"] * C)
    exact = ParsedFunction(spec, C, dim)
    jexact = jax_config.ParsedFunction(spec, C, dim)
    for kw, jkw in ((dict(other=v), dict(other=v)),
                    (dict(other=torch.from_numpy(v)), dict(other=v)),
                    (dict(exact=exact, qpts=qpts),
                     dict(exact=jexact, qpts=qpts))):
        ut = torch.from_numpy(u) if "qpts" in kw else u
        d = errors.error_norms(g, et, conn, ut, **kw)
        jd = jax_errors.error_norms(g, et, conn, u, **jkw)
        assert list(d) == list(jd)
        for k in jd:
            assert abs(d[k] - jd[k]) <= 1e-13 * abs(jd[k])


def test_convergence_table_text_matches_jax():
    """One row, several rows with rates, a None rate and the empty
    table print the same text as the reference's."""
    rows = [(16, 81, {"L2": 2.5e-2, "H1": 0.15, "Linfty": 5e-2}),
            (64, 289, {"L2": 6.1e-3, "H1": 7.4e-2, "Linfty": 1.3e-2}),
            (256, 1089, {"L2": 1.5e-3, "H1": 0.0, "Linfty": 3.1e-3})]
    for n_rows, dim in ((0, 2), (1, 2), (3, 2), (3, None)):
        t, jt = (errors.ConvergenceTable("errLOD", dim=dim),
                 jax_errors.ConvergenceTable("errLOD", dim=dim))
        for r in rows[:n_rows]:
            t.add_row(*r)
            jt.add_row(*r)
        assert str(t) == str(jt)
        assert t.rates() == jt.rates()


def test_fine_operator_and_subcell_matrices_match_jax():
    """The constrained fine operator, its diagonal and the subcell
    matrices, diffusion and elasticity, to 1e-13."""
    for C, names in ((1, ("alpha",)), (3, ("lam", "mu"))):
        g, et, conn, qpts, u, _ = _fields(3, C, 7)
        rng = np.random.default_rng(C)
        coefs = {k: rng.uniform(1, 10, (len(conn), 8)) for k in names}
        mask = g.boundary_node_mask()
        jop = jax_assembly.FineOperator(g, et, conn, coefs,
                                        dirichlet_mask=mask)
        op = assembly.FineOperator(
            et, torch.from_numpy(conn),
            {k: torch.from_numpy(v) for k, v in coefs.items()},
            dirichlet_mask=torch.from_numpy(mask))
        assert rel(op(torch.from_numpy(u)), jop(u)) <= 1e-13
        assert rel(op.diagonal(), jop.diagonal()) <= 1e-13
        assert rel(assembly.make_subcell_matrices(
            et, {k: torch.from_numpy(v) for k, v in coefs.items()}),
            jax_assembly.make_subcell_matrices(et, coefs)) <= 1e-13


def test_dense_solvers_match_jax():
    """The Cholesky solve and the Dirichlet-projected dense solve, to
    1e-12."""
    rng = np.random.default_rng(5)
    M = rng.standard_normal((3, 40, 40))
    A = M @ M.transpose(0, 2, 1) / 40 + np.eye(40)
    B = rng.standard_normal((3, 40, 6))
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)
    assert rel(solvers.spd_solve(At, Bt),
               jax_solvers.spd_solve(A, B)) <= 1e-12
    mask = rng.uniform(size=40) < 0.3
    vals, b = rng.standard_normal(40), rng.standard_normal(40)
    x = solvers.dense_dirichlet_solve(At[0], torch.from_numpy(b),
                                      torch.from_numpy(mask),
                                      torch.from_numpy(vals))
    assert rel(x, jax_solvers.dense_dirichlet_solve(A[0], b, mask, vals)) \
        <= 1e-12


def test_profile_dir_writes_a_trace(tmp_path):
    cfg = pt.SLODConfig(profile_dir=str(tmp_path / "prof"),
                        solve_fine_problem=False)
    out = pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device="cpu",
                       verbose=False).run()
    assert "lod_solution" in out
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


LADDER = [(2, 1), (3, 2), (4, 3)]


def test_physics_ladder():
    """SLOD with l ~ log2 N, u = sin(pi x) sin(pi y), constant alpha and
    tight solver controls: the L2 error against fine FEM falls >= 4x per
    step of (refinement, l) = (2, 1), (3, 2), (4, 3) (measured 1.86e-3,
    7.75e-5, 4.76e-6)."""
    errs = []
    for r, ell in LADDER:
        cfg = pt.SLODConfig(
            n_global_refinements=r, oversampling=ell, lod_stabilization=True,
            rhs="2*pi^2*sin(pi*x)*sin(pi*y)",
            exact_solution="sin(pi*x)*sin(pi*y)",
            fine_solver=pt.ReductionControl(8000, 1e-12, 1e-12),
            coarse_solver=pt.ReductionControl(4000, 1e-12, 1e-12))
        out = pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device="cpu",
                           verbose=False).run()
        errs.append(out["error_LOD_FEMh"].rows[0][2]["L2"])
    assert errs[0] < 5e-3
    for a, b in zip(errs, errs[1:]):
        assert a >= 4 * b, errs
