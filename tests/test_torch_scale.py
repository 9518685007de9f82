"""The port's memory-bounded paths and l = 3 against the JAX package,
float64 on the CPU: the K-chunked and the plane-chunked coarse-operator
builds (each against the same build of the reference on the same basis
canvases), the branch the byte rule picks at the configurations the port
runs on the card (from shapes, no build), the per-chunk coefficient
windows (bit for bit) and the step with them on and off, the SLOD step
at l = 3, and ``run()`` at the physics ladder's (refinement, l) = (4, 3).

At 2D refine-3 l = 3 the smallk stage's Grams resolve near-null
directions by rounding: JAX's own u and A_st move by ~4e-3 and its
prolonged field by ~1e-7 when its coefficients move by 1e-15 relative.
There the port is held to 10x that measured change (the prolonged field
at least to 1e-9), as ``tests/test_torch_slice.py`` does at l = 2.  At
3D refine-1 l = 3 every patch covers the domain, so the SLOD branch
falls back to the LOD candidate and u, A_st agree to 1e-10 (refine-2,
also covered, takes ~50 s a side at n = 2304)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dealii_slod_tpu_torch as pt
from dealii_slod_tpu import config as jax_config
from dealii_slod_tpu.models import DiffusionProblem as JaxDiffusion
from dealii_slod_tpu.models import ElasticityProblem as JaxElasticity
from dealii_slod_tpu.models import LODSolver as JaxLOD
from dealii_slod_tpu.models.stencil import StencilOps as JaxStencilOps
from dealii_slod_tpu_torch.models import basis, stencil

torch.set_num_threads(2)


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


def solvers(C, eig_block=None, **kw):
    """The JAX and the port solver of one configuration with C
    components (C = 1 diffusion, else elasticity)."""
    base = dict(n_subdivisions=2, lod_stabilization=True,
                constant_coefficients=False, coef_seed=4,
                rhs="; ".join(["1"] * C), bc="; ".join(["0"] * C),
                dtype="float64")
    jcfg, cfg = pair_configs(**dict(base, **kw))
    if C == 1:
        js, problem = JaxLOD(jcfg, JaxDiffusion(jcfg), verbose=False), \
            pt.DiffusionProblem(cfg)
    else:
        js, problem = JaxLOD(jcfg, JaxElasticity(jcfg), verbose=False), \
            pt.ElasticityProblem(cfg)
    return js, pt.LODSolver(cfg, problem, device="cpu", verbose=False,
                            eig_block=eig_block)


# ---------------------------------------------------------------------------
# (a) the K-chunked and the plane-chunked builds against the reference's

BUILD_CASES = {"2d-r3-l1-diffusion": (1, dict(dim=2, n_global_refinements=3)),
               "2d-r3-l1-elasticity": (2, dict(dim=2,
                                               n_global_refinements=3)),
               "3d-r2-l1-elasticity": (3, dict(dim=3,
                                               n_global_refinements=2))}


@pytest.fixture(scope="module", params=list(BUILD_CASES))
def canvases(request):
    """One configuration's basis canvases from the reference (numpy),
    its solver and the port's stencil tables."""
    C, kw = BUILD_CASES[request.param]
    js, ps = solvers(C, oversampling=1, **kw)
    js.compute_basis()
    Phi, APhi = np.asarray(js.Phi), np.asarray(js.APhi)
    tab = stencil.stencil_tables(ps.cfg, ps.grid, ps.canvas_dims,
                                 ps.stencil_offsets, "cpu", torch.float64)
    return dict(js=js, ps=ps, tab=tab, Phi=Phi, APhi=APhi, C=C)


def test_k_chunked_build_matches_jax(canvases):
    """``stencil_build_cells`` with 1, 4 and K chunks of the phi slots
    against ``_stencil_build_cells(n_chunks)``, 1e-12 relative; and the
    chunked builds against the whole one."""
    js, tab = canvases["js"], canvases["tab"]
    Phi, APhi = torch.from_numpy(canvases["Phi"]), \
        torch.from_numpy(canvases["APhi"])
    whole = stencil.stencil_build_cells(Phi, APhi, tab, n_chunks=1)
    for n in (1, 4, tab["K"]):
        ref = np.asarray(jax.jit(
            lambda p, a, n=n: js._stencil_build_cells(p, a, n_chunks=n))(
                canvases["Phi"], canvases["APhi"]))
        got = stencil.stencil_build_cells(Phi, APhi, tab, n_chunks=n)
        assert got.shape == ref.shape
        assert rel(got, ref) <= 1e-12, n
        assert rel(got, whole) <= 1e-12, n


def test_planes_build_matches_jax(canvases):
    """``stencil_build_cells_planes`` against
    ``_stencil_build_cells_planes`` at three budgets: 1 byte (one slot
    z-plane a side), two phi planes a chunk (a partial tail on the phi
    side) and three A phi planes a chunk (a partial tail on the A phi
    side), 1e-12 relative; the chunk sizes as the budget implies."""
    js, ps, tab, C = (canvases[k] for k in ("js", "ps", "tab", "C"))
    P, dim = ps.topo.n_patches, ps.cfg.dim
    kappa, O, item = 3, (ps.cfg.n_subdivisions + 1) ** dim, 8
    plane1, plane2 = kappa ** (dim - 1), (kappa + 1) ** (dim - 1)
    Phi, APhi = torch.from_numpy(canvases["Phi"]), \
        torch.from_numpy(canvases["APhi"])
    whole = stencil.stencil_build_cells(Phi, APhi, tab)
    budgets = {1: (1, 1),
               4 * P * 2 * plane1 * O * C * C * item: (2, 1),
               4 * P * 3 * plane2 * O * C * C * item: (3, 3)}
    for budget, chunks in budgets.items():
        assert stencil.planes_chunks(P, C * C, kappa, dim, O, item,
                                     budget) == chunks
        ref = np.asarray(jax.jit(
            lambda p, a, b=budget: js._stencil_build_cells_planes(
                p, a, budget_bytes=b))(canvases["Phi"], canvases["APhi"]))
        got = stencil.stencil_build_cells_planes(Phi, APhi, tab, budget)
        assert rel(got, ref) <= 1e-12, chunks
        assert rel(got, whole) <= 1e-12, chunks


def test_solver_dispatch_follows_the_budget(canvases, monkeypatch):
    """``LODSolver._stencil_build`` takes the planes build when
    ``stencil_side_budget_mb`` is 0, and agrees with the whole build."""
    ps, tab = canvases["ps"], canvases["tab"]
    Phi, APhi = torch.from_numpy(canvases["Phi"]), \
        torch.from_numpy(canvases["APhi"])
    via = ps._stencil_build(Phi, APhi)
    monkeypatch.setattr(ps.cfg, "stencil_side_budget_mb", 0)
    planes = ps._stencil_build(Phi, APhi)
    assert stencil.stencil_plan(ps.cfg, len(Phi), canvases["C"], 8)[0] == \
        "planes"
    assert rel(planes, via) <= 1e-12
    assert rel(via, stencil.stencil_build_cells(Phi, APhi, tab)) <= 1e-12


# ---------------------------------------------------------------------------
# (b) the branch the byte rule picks, from shapes

BRANCH_ROWS = {
    # name: (dtype, C, refinement, l, the port's plan)
    "main": ("float32", 1, 4, 2, ("cells", 1)),
    "main-f64": ("float64", 1, 4, 2, ("cells", 1)),
    "elasticity-r3-f64": ("float64", 3, 3, 2, ("cells", 1)),
    "elasticity": ("float32", 3, 4, 2, ("cells", 4)),
    "r5-diffusion": ("float32", 1, 5, 2, ("cells", 4)),
    "r5-elasticity": ("float32", 3, 5, 2, ("planes", 1, 1)),
    "l3-diffusion": ("float32", 1, 4, 3, ("cells", 3)),
    "l3-elasticity-r3": ("float32", 3, 3, 3, ("cells", 4)),
}


@pytest.mark.parametrize("name", list(BRANCH_ROWS))
def test_branch_rule_matches_jax(name):
    """``stencil_plan`` against the reference's ``_stencil_build`` rule
    (run on the shapes alone, its two builds replaced by recorders) at
    the 3D configurations the port runs on the card."""
    dtype, C, r, ell, plan = BRANCH_ROWS[name]
    jcfg, cfg = pair_configs(dim=3, n_global_refinements=r,
                             oversampling=ell, n_subdivisions=2, dtype=dtype)
    P = (2 ** r) ** 3
    fake = types.SimpleNamespace(
        cfg=jcfg, C=C, topo=types.SimpleNamespace(n_patches=P),
        dtype=jnp.float64 if dtype == "float64" else jnp.float32,
        _stencil_build_cells=lambda p, a, n_chunks: ("cells", n_chunks),
        _stencil_build_cells_planes=lambda p, a, budget_bytes: ("planes",))
    ref = JaxStencilOps._stencil_build(fake, None, None)
    got = stencil.stencil_plan(cfg, P, C, 8 if dtype == "float64" else 4)
    assert got[:len(ref)] == ref
    assert got == plan


# ---------------------------------------------------------------------------
# (c) per-chunk coefficient windows

WINDOW_CASES = [(2, 3, 2), (2, 3, 4), (2, 4, 8), (3, 2, 4), (3, 2, 8),
                (3, 2, 16)]


def window_solvers(dim, refine, C=1, **kw):
    return solvers(C, dim=dim, n_global_refinements=refine, oversampling=1,
                   coef_seed=3, **kw)


@pytest.mark.parametrize("dim,refine,n_chunks", WINDOW_CASES)
def test_window_chunks_match_full_and_jax(dim, refine, n_chunks):
    """``window_stack_chunk`` over every chunk equals ``coef_windows`` bit
    for bit, and each chunk equals the reference's
    ``_window_stack_chunk``; ``window_chunk_rows`` equals
    ``_window_chunk_rows``."""
    js, ps = window_solvers(dim, refine)
    cfg, N = ps.cfg, ps.cfg.n_coarse
    B = N ** dim
    R = basis.window_chunk_rows(cfg, B, n_chunks)
    assert R == js._window_chunk_rows(B, n_chunks)
    assert R is not None and R * N * n_chunks == B
    win = (2 * cfg.oversampling + 1) * cfg.n_subdivisions
    name = ps.coef_names[0]
    coef = ps.coef_q[name]
    full = basis.coef_windows(cfg, ps.grid, coef)
    lat = basis.coef_lattice(cfg, ps.grid, coef)
    jlat = js._coef_lattice(jnp.asarray(coef.numpy()))
    assert np.array_equal(lat.numpy(), np.asarray(jlat))
    parts = []
    for j in range(n_chunks):
        part = basis.window_stack_chunk(lat, j, R, win, cfg.n_subdivisions)
        assert np.array_equal(part.numpy(), np.asarray(
            js._window_stack_chunk(jlat, jnp.int32(j), R, win)))
        parts.append(part)
    assert torch.equal(torch.cat(parts), full)


def test_window_chunk_rows_gates_match_jax():
    """The legality gate on the reference's own cases: whole x-rows, the
    full lex-ordered patch set, no z-plane straddle in 3D."""
    for dim, refine, cases in (
            (3, 2, [(64, 4), (64, 8), (64, 16), (64, 1), (64, 3), (48, 4),
                    (64, 32), (64, 64)]),
            (2, 3, [(64, 2), (64, 32), (64, 8), (64, 64)])):
        js, ps = window_solvers(dim, refine)
        for B, n in cases:
            assert basis.window_chunk_rows(ps.cfg, B, n) == \
                js._window_chunk_rows(B, n), (dim, B, n)
    js, ps = window_solvers(3, 2)
    assert [basis.window_chunk_rows(ps.cfg, 64, n) for n in (4, 8, 16, 3)] \
        == [4, 2, 1, None]


# ---------------------------------------------------------------------------
# (d) the step with the per-chunk windows on and off

@pytest.mark.parametrize("C", [1, 3])
def test_step_window_chunk_on_equals_off(C, monkeypatch):
    """3D refine-2 l=1 SLOD in chunks of 16 (4 x-rows a chunk): u and A_st
    with ``window_chunk="on"`` equal "off" bit for bit; "auto" cuts per
    chunk only past 256 MiB of windows (here when that limit is 0)."""
    outs = {}
    for mode in ("on", "off", "auto"):
        _, ps = window_solvers(3, 2, C=C, patch_chunk=16, window_chunk=mode)
        rows = ps._window_chunk_rows(ps.coef_q, 64, 16)
        assert rows == {"on": 4, "off": None, "auto": None}[mode]
        ps.assemble_fine_rhs()
        outs[mode] = ps.build_step()(ps.coef_q, ps.fem_rhs)
    for a, b in zip(outs["on"], outs["off"]):
        assert torch.equal(a, b)
    monkeypatch.setattr(basis, "WINDOW_SLAB_BYTES", 0)
    assert ps._window_chunk_rows(ps.coef_q, 64, 16) == 4
    assert ps._window_chunk_rows(ps.coef_q, 64, 24) is None   # ragged


# ---------------------------------------------------------------------------
# (e) the SLOD step at l = 3

L3_CASES = {
    "2d-r3-l3-elasticity": (2, dict(dim=2, n_global_refinements=3)),
    "2d-r3-l3-diffusion-split": (1, dict(dim=2, n_global_refinements=3,
                                         patch_solver="fused_split")),
    "3d-r1-l3-diffusion-split": (1, dict(dim=3, n_global_refinements=1,
                                         patch_chunk=8,
                                         patch_solver="fused_split")),
}


@pytest.mark.parametrize("name", list(L3_CASES))
def test_l3_step_matches_jax(name):
    """The step at l = 3, the reference forced onto the main route (the
    fused patch solver, or its split as the card's 3D l = 3 diffusion
    runs it, smallk, the trace kernel), the port with each matrix's
    Jacobi stop its own (``eig_block=1``)."""
    C, kw = L3_CASES[name]
    kw = dict(dict(oversampling=3, coef_refinement=3, patch_chunk=16,
                   eig_solver="smallk", smallk_tol=3e-6,
                   patch_solver="fused", trace_kernel="on",
                   coarse_solver=(200, 1e-12, 1e-12)), **kw)
    js, ps = solvers(C, eig_block=1, **kw)
    js.assemble_fine_rhs()
    step = jax.jit(js.build_step())
    ju, jA = (np.asarray(a) for a in step(js.coef_q, js.fem_rhs))
    ps.assemble_fine_rhs()
    u, A_st = ps.build_step()(ps.coef_q, ps.fem_rhs)
    assert ps.solver_mode == kw["patch_solver"]
    if ps.cfg.n_coarse <= ps.cfg.oversampling:
        # every patch covers the domain: the LOD candidate, no gauge
        assert rel(u, ju) <= 1e-10 and rel(A_st, jA) <= 1e-10
        return
    # the reference's own change under a 1e-15 relative coefficient change
    rng = np.random.default_rng(0)
    pert = {k: v * (1 + 1e-15 * rng.standard_normal(v.shape))
            for k, v in js.coef_q.items()}
    pu, pA = step(pert, js.fem_rhs)
    sens = max(rel(pu, ju), rel(pA, jA))
    assert max(rel(u, ju), rel(A_st, jA)) <= max(1e-10, 10 * sens)
    js.compute_basis()
    js.coarse_solution = ju
    jfield = np.asarray(js.prolong_lod_solution())
    js.coef_q = pert
    js.compute_basis()
    js.coarse_solution = pu
    field_sens = rel(js.prolong_lod_solution(), jfield)
    assert rel(ps.prolong_lod_solution(), jfield) <= max(1e-9,
                                                         10 * field_sens)


# ---------------------------------------------------------------------------
# (f) run() on the physics ladder's last rung

def test_run_l3_matches_jax_on_the_ladder():
    """``run()`` at 2D (refinement, l) = (4, 3), the verify recipe's
    manufactured problem with tight controls: LOD vs FEMh L2 ~4.8e-6,
    the LOD and FEM fields to 1e-10 and the tables to 1e-10 relative;
    the LOD-vs-FEMh table is a difference ~1e-5 of two fields ~1, so
    their ~1e-14 of rounding is ~1e-9 of it (1.0e-9 measured): it is held
    to 1e-10 of the same norm of the FEM error (``error_FEMh_exact``)."""
    jcfg, cfg = pair_configs(
        n_global_refinements=4, oversampling=3, lod_stabilization=True,
        rhs="2*pi^2*sin(pi*x)*sin(pi*y)",
        exact_solution="sin(pi*x)*sin(pi*y)",
        fine_solver=(8000, 1e-12, 1e-12), coarse_solver=(4000, 1e-12, 1e-12))
    ref = JaxLOD(jcfg, JaxDiffusion(jcfg), verbose=False).run()
    out = pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device="cpu",
                       verbose=False).run()
    l2 = out["error_LOD_FEMh"].rows[0][2]["L2"]
    assert 3e-6 < l2 < 7e-6
    for key in ("lod_solution", "fem_solution"):
        assert rel(out[key], ref[key]) <= 1e-10
    tables = [k for k in ref if hasattr(ref[k], "rows")]
    assert tables == [k for k in out if hasattr(out[k], "rows")]
    for key in tables:
        (c, d, n), (jc, jd, jn) = out[key].rows[0], ref[key].rows[0]
        assert (c, d, list(n)) == (jc, jd, list(jn)), key
        for k, v in jn.items():
            scale = (ref["error_FEMh_exact"].rows[0][2][k]
                     if key == "error_LOD_FEMh" else v)
            assert abs(n[k] - v) <= 1e-10 * abs(scale), (key, k)
