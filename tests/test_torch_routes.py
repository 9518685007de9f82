"""The port's remaining basis and coarse routes against the JAX package's
same routes, float64 on the CPU: the per-shape-class oracle
(``kernel_mode="classes"``), the panel LDL^T (``patch_solver="panel"``),
the scatter assembly, the scan trace (``trace_kernel="off"``), the direct
coarse solve, constant-field patch dedup and basis checkpoints.

The JAX side runs as its own tests run it on the CPU: its panel solver's
Gauss-Jordan kernel in interpret mode, every other route in XLA.  The
classes bounds are ``tests/test_uniform.py``'s: the SLOD pseudo-inverse goes
through the Gram BD^T BD, whose squared conditioning limits agreement
between two implementations to ~1e-8 (3e-7 on Phi)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dealii_slod_tpu_torch as pt
from dealii_slod_tpu.config import ReductionControl as JaxRC
from dealii_slod_tpu.config import SLODConfig as JaxConfig
from dealii_slod_tpu.models import DiffusionProblem as JaxDiffusion
from dealii_slod_tpu.models import ElasticityProblem as JaxElasticity
from dealii_slod_tpu.models import LODSolver as JaxLOD
from dealii_slod_tpu.ops import patch_solve as jax_patch_solve
from dealii_slod_tpu.utils import checkpoint as jax_checkpoint
from dealii_slod_tpu_torch.ops import patch_solve
from dealii_slod_tpu_torch.utils import checkpoint

torch.set_num_threads(2)


def arr(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def rel(a, b):
    a, b = arr(a), arr(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def solvers(elastic=False, jax=True, **kw):
    """(JAX solver or None, port solver on the CPU) of one configuration;
    solver controls as (max_steps, tolerance, reduce) triples."""
    jkw, pkw = dict(kw), dict(kw)
    if "coarse_solver" in kw:
        jkw["coarse_solver"] = JaxRC(*kw["coarse_solver"])
        pkw["coarse_solver"] = pt.ReductionControl(*kw["coarse_solver"])
    cfg = pt.SLODConfig(**pkw)
    ps = pt.LODSolver(cfg, (pt.ElasticityProblem if elastic
                            else pt.DiffusionProblem)(cfg),
                      device="cpu", verbose=False)
    if not jax:
        return None, ps
    jcfg = JaxConfig(**jkw)
    js = JaxLOD(jcfg, (JaxElasticity if elastic else JaxDiffusion)(jcfg),
                verbose=False)
    return js, ps


def basis_of(s):
    s.compute_basis()
    return arr(s.Phi), arr(s.APhi)


# ---------------------------------------------------------------------------
# kernel_mode="classes": tests/test_uniform.py's cases
# ---------------------------------------------------------------------------

CLASSES = {
    # name -> (problem is elasticity, config, Phi bound, APhi bound)
    "2d-lod-const": (False, dict(dim=2, n_global_refinements=2,
                                 oversampling=2, lod_stabilization=False,
                                 constant_coefficients=True, coef_seed=5),
                     1e-11, 3e-8),
    "2d-slod-const": (False, dict(dim=2, n_global_refinements=2,
                                  oversampling=2, lod_stabilization=True,
                                  constant_coefficients=True, coef_seed=5),
                      3e-7, 9e-6),
    "2d-slod-random": (False, dict(dim=2, n_global_refinements=2,
                                   oversampling=2, lod_stabilization=True,
                                   constant_coefficients=False, coef_seed=5),
                       3e-7, 9e-6),
    "2d-elasticity": (True, dict(dim=2, n_global_refinements=2,
                                 oversampling=1, lod_stabilization=True,
                                 constant_coefficients=False, coef_seed=2),
                      3e-7, 1e-5),
    "3d-slod-random": (False, dict(dim=3, n_global_refinements=2,
                                   oversampling=1, lod_stabilization=True,
                                   constant_coefficients=False, coef_seed=4),
                       3e-7, 1e-5),
    "2d-full-domain": (False, dict(dim=2, n_global_refinements=2,
                                   oversampling=4, lod_stabilization=True,
                                   constant_coefficients=True),
                       1e-11, 3e-8),
}


@pytest.fixture(scope="module", params=list(CLASSES))
def classes_case(request):
    elastic, kw, b_phi, b_aphi = CLASSES[request.param]
    kw = dict(kw, n_subdivisions=2, dtype="float64")
    js, ps = solvers(elastic, kernel_mode="classes", **kw)
    _, pu = solvers(elastic, jax=False, **kw)
    return dict(jax=basis_of(js), port=basis_of(ps), uniform=basis_of(pu),
                bounds=(b_phi, b_aphi), solver=ps)


@pytest.mark.parametrize("other", ["jax", "uniform"])
def test_classes_match(classes_case, other):
    """The port's classes route against JAX's classes route and against
    the port's own uniform kernel route (on the CPU the ``eigh`` stage):
    Phi and APhi within ``tests/test_uniform.py``'s bounds, applied as that
    file applies them (``assert_allclose`` with its absolute tolerance and
    numpy's default relative one).  Measured once on 2d-slod-random, the
    widest case: the uniform route's APhi differs by at most 9.04e-6, where
    the bound at that entry is 1.04e-5 (JAX's own uniform route differs
    from the port's by 7.4e-6 there: the Grams' near-null directions,
    resolved differently by two eigensolvers)."""
    port, ref = classes_case["port"], classes_case[other]
    for a, b, bound in zip(port, ref, classes_case["bounds"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=bound, err_msg=other)


def test_classes_launch_no_kernel_and_never_dedup(classes_case):
    s = classes_case["solver"]
    assert s.basis_patches == s.topo.n_patches
    assert s._tables is None            # the uniform tables never built


# ---------------------------------------------------------------------------
# patch_solver="panel"
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k,nb", [(256, 128, 128), (300, 125, 128),
                                    (384, 64, 256)])
def test_panel_matches_jax_and_a_dense_solve(n, k, nb):
    """``panel_spd_multirhs`` against JAX's on random SPD batches: X and T
    within ``tests/test_patch_solve.py``'s 1e-8 relative bound of a dense
    solve, and of JAX's X and T."""
    rng = np.random.default_rng(n + k)
    P = 3
    M = rng.standard_normal((P, n, max(n // 3, 4)))
    A = np.einsum("bik,bjk->bij", M, M) + n * np.eye(n)
    B = rng.standard_normal((P, n, k))
    X, T = patch_solve.panel_spd_multirhs(torch.as_tensor(A),
                                          torch.as_tensor(B), nb=nb)
    Xj, Tj = jax_patch_solve.panel_spd_multirhs(jnp.asarray(A),
                                                jnp.asarray(B), nb=nb)
    X_ref = np.stack([np.linalg.solve(A[i], B[i]) for i in range(P)])
    T_ref = np.einsum("bik,bij->bkj", B, X_ref)
    for got, ref in ((X, X_ref), (T, T_ref), (X, Xj), (T, Tj)):
        assert rel(got, ref) < 1e-8
    assert patch_solve.panel_k2_launches(n, nb) == (
        -(-n // nb) * (1 if nb <= 128 else 2))


@pytest.mark.parametrize("panel_nb", [128, 256])
def test_panel_basis_matches_jax(panel_nb):
    """A basis through ``patch_solver="panel"`` (plain LOD, so no spectral
    stage sits between the two) against JAX's panel route, and SLOD's
    against the port's fused route: <= 1e-10 relative."""
    kw = dict(dim=2, n_global_refinements=3, n_subdivisions=2,
              oversampling=1, constant_coefficients=False, coef_seed=1,
              dtype="float64", patch_chunk=16, patch_solver="panel",
              panel_nb=panel_nb)
    js, ps = solvers(lod_stabilization=False, **kw)
    assert ps.solver_mode == "panel"
    for a, b in zip(basis_of(ps), basis_of(js)):
        assert rel(a, b) <= 1e-10
    _, ps = solvers(jax=False, lod_stabilization=True, **kw)
    _, pf = solvers(jax=False, lod_stabilization=True,
                    **dict(kw, patch_solver="fused"))
    for a, b in zip(basis_of(ps), basis_of(pf)):
        assert rel(a, b) <= 1e-10


# ---------------------------------------------------------------------------
# assembly_mode="scatter" and trace_kernel="off"
# ---------------------------------------------------------------------------

ROUTE_CASES = {
    "c1": (False, dict(dim=2, n_global_refinements=2, oversampling=1,
                       rhs="1")),
    "c1-3d": (False, dict(dim=3, n_global_refinements=2, oversampling=1,
                          rhs="1")),
    "elasticity-2d": (True, dict(dim=2, n_global_refinements=2,
                                 oversampling=1, rhs="1; 1")),
}


@pytest.mark.parametrize("route", [dict(assembly_mode="scatter"),
                                   dict(trace_kernel="off")],
                         ids=["scatter", "off"])
@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_scatter_and_scan_trace_match(case, route):
    """The scatter assembly and the scan trace: Phi and APhi against JAX's
    same route and against the port's default route, <= 1e-10
    relative (SLOD, the eigh stage)."""
    elastic, kw = ROUTE_CASES[case]
    kw = dict(kw, n_subdivisions=2, lod_stabilization=True,
              constant_coefficients=False, coef_seed=3, dtype="float64",
              patch_chunk=8)
    js, ps = solvers(elastic, **route, **kw)
    _, pd = solvers(elastic, jax=False, **kw)
    port = basis_of(ps)
    assert ps._tables.scatter == ("assembly_mode" in route)
    assert ps._tables.trace_kernel == ("trace_kernel" not in route)
    for a, b, c in zip(port, basis_of(js), basis_of(pd)):
        assert rel(a, b) <= 1e-10
        assert rel(a, c) <= 1e-10


def test_scan_trace_is_the_plain_trace_and_off_launches_none(monkeypatch):
    """``trace_kernel="off"`` never reaches the kernel wrapper
    ``stencil_trace``; the default route reaches it for the trace and for
    A phi."""
    from dealii_slod_tpu_torch.models import basis
    calls = []
    real = basis.stencil_trace

    def spy(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(basis, "stencil_trace", spy)
    kw = dict(dim=2, n_global_refinements=2, n_subdivisions=2,
              oversampling=1, lod_stabilization=True, dtype="float64",
              patch_chunk=8)
    _, ps = solvers(jax=False, trace_kernel="off", **kw)
    ps.compute_basis()
    assert calls == []
    _, ps = solvers(jax=False, **kw)
    ps.compute_basis()
    assert len(calls) == 2 * 2          # 2 chunks x (trace, A phi)


# ---------------------------------------------------------------------------
# coarse_solve="direct" (tests/test_solvers_extra.py:191-229)
# ---------------------------------------------------------------------------

DIRECT = dict(dim=2, n_global_refinements=3, n_subdivisions=2,
              oversampling=2, lod_stabilization=True,
              constant_coefficients=False, coef_seed=4, rhs="1", bc="0",
              dtype="float64", write_output=False,
              coarse_solver=(800, 1e-12, 1e-12))


def _coarse(s):
    s.compute_basis()
    s.assemble_coarse_operator()
    s.assemble_fine_rhs()
    return arr(s.solve_coarse())


def test_direct_coarse_solve_matches_cg():
    """``coarse_solve="direct"`` reproduces the CG solution in
    ``solve_coarse`` and in ``build_step``; above ``coarse_dense_cap`` it
    goes back to CG and sets ``coarse_cg``."""
    out = {}
    for mode in ("cg", "direct"):
        _, s = solvers(jax=False, coarse_solve=mode, **DIRECT)
        u = _coarse(s)
        assert (s.coarse_cg is None) == (mode == "direct")
        u_step, _ = s.build_step()(s.coef_q, s.fem_rhs)
        np.testing.assert_allclose(arr(u_step), u, rtol=1e-6, atol=1e-12)
        out[mode] = u
    np.testing.assert_allclose(out["direct"], out["cg"], rtol=1e-6,
                               atol=1e-11)
    _, s = solvers(jax=False, coarse_solve="direct", coarse_dense_cap=4,
                   **DIRECT)
    u_cap = _coarse(s)
    assert s.coarse_cg is not None
    np.testing.assert_allclose(u_cap, out["cg"], rtol=1e-8, atol=1e-11)


def test_direct_coarse_solve_matches_jax():
    """JAX's direct coarse solution against the port's, <= 1e-10 relative,
    on plain LOD (the eigh stage's gauge would otherwise sit between the
    two coarse operators, ``tests/test_torch_plain_lod.py``); the port's
    step takes the same route (``test_direct_coarse_solve_matches_cg``)."""
    js, ps = solvers(**dict(DIRECT, lod_stabilization=False,
                            coarse_solve="direct"))
    assert rel(_coarse(ps), _coarse(js)) <= 1e-10
    assert js.coarse_cg is None and ps.coarse_cg is None


# ---------------------------------------------------------------------------
# constant-field patch dedup
# ---------------------------------------------------------------------------

DEDUP = {
    "2d-r3-l1-lod": (False, dict(dim=2, n_global_refinements=3,
                                 oversampling=1, lod_stabilization=False)),
    "2d-r3-l2-slod": (False, dict(dim=2, n_global_refinements=3,
                                  oversampling=2, lod_stabilization=True)),
    "3d-r3-l1-slod": (False, dict(dim=3, n_global_refinements=3,
                                  oversampling=1, lod_stabilization=True)),
    "2d-elasticity": (True, dict(dim=2, n_global_refinements=3,
                                 oversampling=1, lod_stabilization=True,
                                 rhs="1; 1")),
}


@pytest.mark.parametrize("case", list(DEDUP))
def test_dedup_matches_all_patches_and_jax(case):
    """On a constant field ``compute_basis`` builds JAX's number of unique
    window signatures; its canvases equal a build of all P patches to
    1e-12 and JAX's to 1e-10 relative, or to 10x the port's own change
    under a 1e-15 relative coefficient move where that is larger (the
    eigh stage's gauge; measured once on 2d-r3-l2-slod: 5.4e-8 against
    JAX)."""
    elastic, kw = DEDUP[case]
    kw = dict(kw, n_subdivisions=2, constant_coefficients=True,
              dtype="float64", patch_chunk=8)
    js, ps = solvers(elastic, **kw)
    dedup = basis_of(ps)
    rep, _ = js._patch_dedup(*js._uniform_inputs()[1:])
    assert ps.basis_patches == len(rep) < ps.topo.n_patches
    full = [arr(x) for x in ps.compute_basis(ps.coef_q)]
    assert ps.basis_patches == ps.topo.n_patches
    _, pp = solvers(elastic, jax=False, **kw)
    rng = np.random.default_rng(0)
    pp.coef_q = {k: v * (1 + 1e-15 * torch.as_tensor(
        rng.standard_normal(v.shape))) for k, v in pp.coef_q.items()}
    for a, b, c, d in zip(dedup, full, basis_of(js), basis_of(pp)):
        assert rel(a, b) <= 1e-12
        assert rel(a, c) <= max(1e-10, 10 * rel(d, a))


def test_step_with_fields_never_dedups():
    """``build_step``'s fields need not be constant: on a constant-field
    solver, a non-constant field passed to the step builds every patch,
    and the step equals JAX's (which never dedups) to 1e-10 relative."""
    kw = dict(dim=2, n_global_refinements=3, n_subdivisions=2,
              oversampling=1, lod_stabilization=False, dtype="float64",
              patch_chunk=16, rhs="1", bc="0", constant_coefficients=True)
    js, ps = solvers(**kw)
    _, rand = solvers(jax=False, **dict(kw, constant_coefficients=False,
                                       coef_seed=2))
    out = []
    for s in (ps, js):
        s.assemble_fine_rhs()
        coefs = {k: (v if s is ps else jnp.asarray(arr(v)))
                 for k, v in rand.coef_q.items()}
        out.append(s.build_step()(coefs, s.fem_rhs))
    assert ps.basis_patches == ps.topo.n_patches
    for a, b in zip(*out):
        assert rel(a, b) <= 1e-10


def test_default_config_refined_run_matches_jax():
    """``run()`` on ``SLODConfig()`` at refinement 3 (plain LOD, constant
    field: 25 of the 64 patches built, JAX's count): every table equals
    JAX's to 1e-10."""
    from tests.test_torch_run import assert_tables_match
    js, ps = solvers(n_global_refinements=3)
    ref = js.run()
    out = ps.run()
    assert ps.basis_patches == 25 == len(
        js._patch_dedup(*js._uniform_inputs()[1:])[0])
    assert_tables_match(out, ref)
    assert rel(out["lod_solution"], ref["lod_solution"]) <= 1e-10


# ---------------------------------------------------------------------------
# basis checkpoints
# ---------------------------------------------------------------------------

def test_checkpoints_move_between_the_packages(tmp_path):
    """A basis file written by JAX loads into the port and one written by
    the port loads into JAX, with equal arrays and equal fingerprints; a
    changed configuration is refused (False)."""
    kw = dict(dim=2, n_global_refinements=2, n_subdivisions=2,
              oversampling=1, lod_stabilization=True,
              constant_coefficients=False, coef_seed=1, dtype="float64")
    js, ps = solvers(**kw)
    for s in (js, ps):
        s.compute_basis()
        s.assemble_coarse_operator()
    assert checkpoint._config_fingerprint(ps.cfg, ps.C) == \
        jax_checkpoint._config_fingerprint(js.cfg, js.C)
    jf = jax_checkpoint.save_basis(js, str(tmp_path / "jax.npz"))
    pf = checkpoint.save_basis(ps, str(tmp_path / "port.npz"))
    _, pl = solvers(jax=False, **kw)
    assert checkpoint.load_basis(pl, jf)
    jl, _ = solvers(**kw)
    assert jax_checkpoint.load_basis(jl, pf)
    for name in ("Phi", "APhi", "A_stencil"):
        got = getattr(pl, name)
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        np.testing.assert_array_equal(arr(got), arr(getattr(js, name)))
        np.testing.assert_array_equal(arr(getattr(jl, name)),
                                      arr(getattr(ps, name)))
    # a new solver fed the port's file solves as the solver that wrote it
    _, again = solvers(jax=False, **kw)
    assert checkpoint.load_basis(again, pf)
    for s in (again, ps):
        s.assemble_fine_rhs()
    np.testing.assert_array_equal(arr(again.solve_coarse()),
                                  arr(ps.solve_coarse()))
    _, other = solvers(jax=False, **dict(kw, coef_seed=2))
    assert not checkpoint.load_basis(other, pf)
    assert not hasattr(other, "Phi")
