"""The port's package boundary: it never loads jax, it refuses a CUDA
device that is not there, and it refuses every knob value it does not
implement."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

import dealii_slod_tpu_torch as pt
from dealii_slod_tpu.config import SLODConfig

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_cfg(**kw):
    base = dict(dim=2, n_global_refinements=2, n_subdivisions=2,
                oversampling=1, lod_stabilization=True,
                constant_coefficients=False, coef_refinement=2,
                dtype="float64", patch_chunk=8, eig_solver="jacobi",
                patch_solver="fused", trace_kernel="on")
    base.update(kw)
    return SLODConfig(**base)


def test_import_and_cpu_step_never_load_jax():
    """In a fresh interpreter: import the port, run a tiny CPU step, and
    find no jax module loaded."""
    code = textwrap.dedent("""
        import sys
        import torch
        torch.set_num_threads(2)
        import dealii_slod_tpu_torch as pt
        cfg = pt.SLODConfig(dim=2, n_global_refinements=2, n_subdivisions=2,
                            oversampling=1, lod_stabilization=True,
                            constant_coefficients=False, coef_refinement=2,
                            dtype="float64", patch_chunk=8,
                            eig_solver="jacobi", patch_solver="fused")
        s = pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device="cpu",
                         verbose=False)
        s.assemble_fine_rhs()
        u, A_st = s.build_step()(s.coef_q, s.fem_rhs)
        assert u.shape == (16, 1) and bool(torch.isfinite(u).all())
        assert float(u.abs().max()) > 0
        loaded = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith(("jax.", "jaxlib")))
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


class _Elasticity:
    n_components = 2


@pytest.mark.parametrize("knobs", [
    dict(eig_solver="auto"), dict(eig_solver="smallk"),
    dict(eig_solver="lapack"), dict(eig_solver="lax"),
    dict(patch_solver="panel"), dict(patch_solver="fused_split"),
    dict(patch_solver="lax"), dict(kernel_mode="classes"),
    dict(coarse_solve="direct"), dict(lod_stabilization=False),
    dict(trace_kernel="off"), dict(fused_nb=128),
    dict(assembly_mode="scatter"), dict(problem="elasticity"),
], ids=lambda k: "-".join(f"{a}={b}" for a, b in k.items()))
def test_unsupported_knobs_raise(knobs):
    knobs = dict(knobs)
    elastic = knobs.pop("problem", None) == "elasticity"
    cfg = tiny_cfg(**knobs)
    problem = _Elasticity() if elastic else pt.DiffusionProblem(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        pt.LODSolver(cfg, problem, device="cpu", verbose=False)


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
