"""The port's package boundary: it never loads jax or the JAX package,
it runs on the card unless asked for the CPU and refuses a CUDA device that
is not there, it resolves the "auto" knobs by the reference's rules, every
knob value of the basis and coarse routes builds and steps, and what it
does not implement raises, naming its ROADMAP.md entry by title."""

import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

import numpy as np

import dealii_slod_tpu_torch as pt

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_cfg(**kw):
    base = dict(dim=2, n_global_refinements=2, n_subdivisions=2,
                oversampling=1, lod_stabilization=True,
                constant_coefficients=False, coef_refinement=2,
                dtype="float64", patch_chunk=8, eig_solver="jacobi",
                patch_solver="fused", trace_kernel="on")
    base.update(kw)
    return pt.SLODConfig(**base)


def test_import_and_cpu_step_never_load_jax():
    """In a fresh interpreter: import the port, run a tiny CPU diffusion
    step on the Jacobi and on the smallk route and a tiny elasticity step
    (C = 2, the Schur-split patch solver), and find no jax module and no
    module of the JAX package loaded."""
    code = textwrap.dedent("""
        import sys
        import torch
        torch.set_num_threads(2)
        import dealii_slod_tpu_torch as pt
        for eig_solver in ("jacobi", "smallk"):
            cfg = pt.SLODConfig(dim=2, n_global_refinements=2,
                                n_subdivisions=2, oversampling=1,
                                lod_stabilization=True,
                                constant_coefficients=False,
                                coef_refinement=2, dtype="float64",
                                patch_chunk=8, eig_solver=eig_solver,
                                patch_solver="fused")
            s = pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device="cpu",
                             verbose=False)
            s.assemble_fine_rhs()
            u, A_st = s.build_step()(s.coef_q, s.fem_rhs)
            assert s.spec_mode == eig_solver
            assert u.shape == (16, 1) and bool(torch.isfinite(u).all())
            assert float(u.abs().max()) > 0
        cfg = pt.SLODConfig(dim=2, n_global_refinements=2, n_subdivisions=2,
                            oversampling=1, lod_stabilization=True,
                            constant_coefficients=False, coef_refinement=2,
                            dtype="float64", patch_chunk=8, rhs="1; 1",
                            eig_solver="smallk", patch_solver="fused_split")
        s = pt.LODSolver(cfg, pt.ElasticityProblem(cfg), device="cpu",
                         verbose=False)
        s.assemble_fine_rhs()
        u, A_st = s.build_step()(s.coef_q, s.fem_rhs)
        assert u.shape == (16, 2) and A_st.shape[-2:] == (2, 2)
        assert bool(torch.isfinite(u).all()) and float(u.abs().max()) > 0
        # the reference's default run and the modules it reaches
        import dealii_slod_tpu_torch.cli
        import dealii_slod_tpu_torch.examples.convergence_study
        import dealii_slod_tpu_torch.examples.multi_rhs
        import dealii_slod_tpu_torch.utils.checkpoint
        import dealii_slod_tpu_torch.utils.errors
        import dealii_slod_tpu_torch.utils.io
        import dealii_slod_tpu_torch.utils.native
        cfg = pt.SLODConfig(solve_fine_problem=True)
        out = pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device="cpu",
                           verbose=False).run()
        assert "error_LOD_FEMh" in out
        loaded = sorted(m for m in sys.modules
                        if m in ("jax", "jaxlib", "dealii_slod_tpu")
                        or m.startswith(("jax.", "jaxlib.",
                                         "dealii_slod_tpu.")))
        assert not loaded, loaded
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cfg = tiny_cfg()
    with pytest.raises(RuntimeError):
        pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device="cuda",
                     verbose=False)


def test_entry_points_default_to_the_card():
    """``LODSolver`` and ``load_state`` run on the card unless given
    ``device="cpu"``: with no GPU, the defaults raise."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cfg = tiny_cfg()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.LODSolver(cfg, pt.DiffusionProblem(cfg), verbose=False)
    with pytest.raises((RuntimeError, AssertionError)):
        pt.load_state({"alpha": np.ones((4, 4))}, np.ones((9, 1)))
    state = pt.load_state({"alpha": np.ones((4, 4))}, np.ones((9, 1)),
                          "cpu")
    assert state.fem_rhs.dtype == torch.float32


def test_auto_spectral_stage_on_cpu_is_eigh():
    """``eig_solver="auto"`` is smallk only on the card in float32; on the
    CPU it names the LAPACK (``eigh``) stage, in either dtype, and the
    solver builds on it instead of raising."""
    for dtype in ("float64", "float32"):
        cfg = tiny_cfg(eig_solver="auto", dtype=dtype)
        s = pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device="cpu",
                         verbose=False)
        assert s.spec_mode == "lapack"


def test_auto_spectral_stage_resolution():
    """The rule itself: smallk on CUDA in float32, lapack otherwise."""
    from dealii_slod_tpu_torch.models.lod import spectral_mode
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert spectral_mode(tiny_cfg(eig_solver="auto", dtype="float32"),
                         cuda) == "smallk"
    assert spectral_mode(tiny_cfg(eig_solver="auto", dtype="float64"),
                         cuda) == "lapack"
    assert spectral_mode(tiny_cfg(eig_solver="auto", dtype="float32"),
                         cpu) == "lapack"
    assert spectral_mode(tiny_cfg(eig_solver="smallk"), cpu) == "smallk"


def test_auto_patch_solver_resolution():
    """``patch_solver="auto"`` applies the reference's size rule on any
    device: 3D l=2 diffusion sits exactly at the fused kernel's 12 MiB
    estimate ("fused"), 3D l=2 elasticity (n = 2187) takes the Schur split,
    3D l=1 and 2D l=2 elasticity fit the fused estimate; a named solver is
    taken as it is."""
    from dealii_slod_tpu_torch.grid import GridSpec, ShapeClass
    from dealii_slod_tpu_torch.models.lod import patch_solver_mode

    def mode(dim, ell, C):
        cfg = tiny_cfg(dim=dim, n_global_refinements=3, oversampling=ell,
                       patch_solver="auto")
        grid = GridSpec(dim, cfg.n_coarse, cfg.n_subdivisions, C)
        return patch_solver_mode(cfg, C, ShapeClass((2 * ell + 1,) * dim,
                                                    grid))

    assert mode(3, 2, 1) == "fused"
    assert mode(3, 2, 3) == "fused_split"
    assert mode(3, 1, 3) == "fused"
    assert mode(2, 2, 2) == "fused"
    assert patch_solver_mode(tiny_cfg(patch_solver="fused_split"), 1,
                             None) == "fused_split"


class _Elasticity:
    n_components = 3           # C = 3 components in 2D


# each knob value of the basis and coarse routes -> (the default-route
# knobs it is compared with, what is compared, bound): "rel" the relative
# max difference of Phi, "abs" the absolute one (the classes route's SVD
# against the uniform route's eigh stage, tests/test_uniform.py's bound)
TIGHT = pt.ReductionControl(800, 1e-12, 1e-12)
ROUTE_KNOBS = [
    (dict(patch_solver="panel"), {}, "rel", 1e-10),
    (dict(kernel_mode="classes"), dict(eig_solver="lapack"), "abs", 3e-7),
    (dict(coarse_solve="direct", coarse_solver=TIGHT),
     dict(coarse_solver=TIGHT), "rel", 0.0),
    (dict(trace_kernel="off"), {}, "rel", 1e-10),
    (dict(fused_nb=128), {}, "rel", 0.0),
    (dict(assembly_mode="scatter"), {}, "rel", 1e-10),
    (dict(problem="elasticity", patch_solver="fused_split", panel_nb=96),
     dict(problem="elasticity", patch_solver="fused_split"), "rel", 1e-10),
]


def _ids(k):
    return "-".join(f"{a}={b}" for a, b in k.items())


def _tiny_solver(knobs):
    knobs = dict(knobs)
    elastic = knobs.pop("problem", None) == "elasticity"
    if elastic:
        knobs.setdefault("rhs", "1; 1")
    cfg = tiny_cfg(**knobs)
    problem = (pt.ElasticityProblem if elastic else pt.DiffusionProblem)(cfg)
    return pt.LODSolver(cfg, problem, device="cpu", verbose=False)


@pytest.mark.filterwarnings("ignore:fused_algo")
@pytest.mark.parametrize("knobs, base, how, bound", ROUTE_KNOBS,
                         ids=[_ids({a: b for a, b in k[0].items()
                                    if a != "coarse_solver"})
                              for k in ROUTE_KNOBS])
def test_route_knobs_build_and_match_the_default(knobs, base, how, bound):
    """Each knob value of the remaining basis and coarse routes builds a
    tiny solver on the CPU and steps, and its Phi is the default route's
    within the route's bound (the direct coarse solve and fused_nb, a TPU
    tiling of K1, leave the basis as it is); the direct solve's u is the
    CG's."""
    s, d = _tiny_solver(knobs), _tiny_solver(base)
    out = []
    for solver in (s, d):
        solver.assemble_fine_rhs()
        out.append(solver.build_step()(solver.coef_q, solver.fem_rhs)[0])
    diff = float((s.Phi - d.Phi).abs().max())
    if how == "rel":
        diff /= float(d.Phi.abs().max())
    assert diff <= bound, (knobs, diff)
    assert bool(torch.isfinite(out[0]).all())
    if "coarse_solve" in knobs:
        assert s.coarse_cg is None and d.coarse_cg is not None
        assert torch.allclose(out[0], out[1], rtol=1e-6, atol=1e-12)


def _refusal(knobs):
    """The NotImplementedError that building a solver with ``knobs``
    raises."""
    cfg = tiny_cfg(**knobs)
    with pytest.raises(NotImplementedError) as info:
        pt.LODSolver(cfg, _Elasticity(), device="cpu", verbose=False)
    return str(info.value)


def test_unsupported_knobs_raise():
    """C = 3 components in 2D, which no problem of the reference has,
    raises saying so."""
    assert "C = 1 or dim" in _refusal({})


def _queue1_text():
    with open(os.path.join(REPO, "ROADMAP.md")) as fh:
        text = fh.read()
    return text.split("### Queue 1", 1)[1].split("### Queue 2", 1)[0]


def test_refusals_name_a_queue1_title():
    """Each refusal names a Queue 1 entry of ROADMAP.md by its title (a
    bold item heading there), so renumbering the queue cannot break it:
    the coefficient sets, the sharded step and the CLI's reaction problem
    (which raises as the coefficient sets do)."""
    from dealii_slod_tpu_torch.models import lod
    from dealii_slod_tpu_torch.ops.assembly import FineOperator
    msgs = []
    s = pt.LODSolver(tiny_cfg(), pt.DiffusionProblem(tiny_cfg()),
                     device="cpu", verbose=False)
    for call in (lambda: s.build_step(mesh=object()),
                 lambda: FineOperator(s.et, s.conn,
                                      {"alpha": s.coef_q["alpha"],
                                       "creact": s.coef_q["alpha"]})):
        with pytest.raises(NotImplementedError) as info:
            call()
        msgs.append(str(info.value))
    headings = [h.lower() for h in
                re.findall(r"^\d+\. \*\*(.+?)\.?\*\*", _queue1_text(),
                           re.M)]
    titles = {lod.REACTION, lod.SCALING}
    for msg in msgs:
        title = re.search(r"ROADMAP\.md Queue 1: ([^)]+)\)", msg).group(1)
        assert title in titles, msg
    for title in titles:
        assert any(h.startswith(title) for h in headings), (title, headings)


@pytest.mark.parametrize("knobs", [
    dict(eig_solver="auto"),
    dict(eig_solver="lapack"), dict(eig_solver="lax"),
    dict(patch_solver="lax"), dict(lod_stabilization=False),
], ids=_ids)
def test_reference_knobs_build_and_step_on_cpu(knobs):
    """The reference's default method (plain LOD), its CPU spectral stage
    (``eigh``: "auto" on the CPU, "lapack", "lax") and its per-patch
    Cholesky solve build and step on the CPU: finite, non-zero u and a
    converged coarse CG."""
    cfg = tiny_cfg(**knobs)
    s = pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device="cpu",
                     verbose=False)
    s.assemble_fine_rhs()
    u, A_st = s.build_step()(s.coef_q, s.fem_rhs)
    assert u.shape == (16, 1) and A_st.shape[-2:] == (1, 1)
    assert bool(torch.isfinite(u).all()) and float(u.abs().max()) > 0
    assert bool(s.coarse_cg.converged)
    if "eig_solver" in knobs:
        assert s.spec_mode == ("lapack" if knobs["eig_solver"] == "auto"
                               else knobs["eig_solver"])
    assert s.solver_mode == knobs.get("patch_solver", "fused")


def test_sharded_step_raises():
    cfg = tiny_cfg()
    s = pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device="cpu",
                     verbose=False)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        s.build_step(mesh=object())


def test_tpu_variant_knobs_warn_and_route_to_the_kernel():
    """fused_algo / fused_block / solver_gj2 name TPU variants of K1's
    contract: accepted with a warning."""
    cfg = tiny_cfg(fused_algo="chol", fused_block=1)
    with pytest.warns(UserWarning, match="K1"):
        pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device="cpu",
                     verbose=False)


@pytest.mark.parametrize("knobs, kernel", [
    (dict(split_bs=2), "K6"), (dict(trace_impl="unrollslice"), "K7")])
def test_elasticity_tpu_variant_knobs_warn(knobs, kernel):
    """split_bs (the leaf's patch batching on the TPU) and the trace's
    ``impl`` values are TPU variants of K6's and K7's contracts: accepted
    with a warning that names the kernel that serves them."""
    cfg = tiny_cfg(rhs="1; 1", patch_solver="fused_split", **knobs)
    with pytest.warns(UserWarning, match=kernel):
        s = pt.LODSolver(cfg, pt.ElasticityProblem(cfg), device="cpu",
                         verbose=False)
    assert s.solver_mode == "fused_split"
