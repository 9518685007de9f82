"""The float32 / float64 gap of the smallk basis, the port against the JAX
package, on the CPU.

The two dtypes' smallk stages part by more than rounding: float32
regularizes each Gram by 1e-6 of its largest diagonal entry, float64 by
1e-13 (``ops/eig.py: JITTER``, the reference's rule), so the SLOD
truncation runs on different coefficients.  This test builds six bases of
one configuration, JAX's and the port's float32, float64 and float64
under the float32 rule (below), all on the main path's routes (the fused patch solve, the trace
kernel, smallk; the port's Jacobi stops matrix by matrix, as the CUDA
kernels do), and compares the prolonged fine fields, each coarse system
solved exactly on the same float64 operator code: the port's float32 -
float64 difference must equal JAX's.

Configuration: 2D refine-4 l=2 (256 patches), where the JAX gap is
5.579e-03 (max |difference| over max |field|).  The float32 fields are
sensitive to rounding: a 1e-7 relative change of JAX's float32
coefficients moved its field by 3.808e-04, 1.877e-04 and 2.249e-04
(three random changes); the port's float32 field is 3.403e-04 from JAX's.
So the float32 case's tolerance is 10x the largest of those moves,
3.808e-03, and the gap itself must exceed it: it catches only a gross
departure from the rule.

The rule itself is held in float64, where rounding barely moves the
field: both packages' float64 smallk stages run with the float32 choices
(the jitter 1e-6, and ``smallk_dirs`` directions, all of them at this
Gram size), and the gap between that field and the plain float64 one must
be the same in both.  That gap is 5.709e-03 in JAX.  A 1e-15 relative
change of JAX's coefficients moved its rule field by 6.027e-13,
4.421e-13 and 5.565e-13, and its plain float64 field, whose truncation
runs on the 1e-13 jitter, by 7.168e-09, 9.395e-09 and 1.565e-08; the
port's gap is 8.097e-09 from JAX's.  So the tolerance is 10x the largest
move, 1.565e-07, about 1/36000 of the gap.

``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_dtype_gap.py``
prints those numbers again (``calibrate``)."""

import contextlib
import functools

import numpy as np
import pytest
import torch

import dealii_slod_tpu_torch as pt
from dealii_slod_tpu.config import SLODConfig as JaxConfig
from dealii_slod_tpu.models import DiffusionProblem as JaxDiffusion
from dealii_slod_tpu.models import LODSolver as JaxLOD
from dealii_slod_tpu.models import basis as jax_basis
from dealii_slod_tpu.ops import eig as jax_eig
from dealii_slod_tpu_torch.models import basis
from dealii_slod_tpu_torch.models.coarse import CoarseSystem
from dealii_slod_tpu_torch.ops import eig

torch.set_num_threads(2)

KW = dict(dim=2, n_global_refinements=4, n_subdivisions=2, oversampling=2,
          lod_stabilization=True, constant_coefficients=False, coef_seed=3,
          coef_refinement=3, rhs="1", bc="0", patch_chunk=32,
          solve_fine_problem=False, eig_solver="smallk",
          patch_solver="fused", trace_kernel="on", smallk_tol=3e-6,
          eig_sweeps=12, eig_tol=3e-6)
# the variant whose gap from float64 is compared -> 10x JAX's own field
# move under a relative coefficient change of about its rounding
GAP_TOL = {"float32": 3.808e-03, "float32 rule": 1.565e-07}
# JAX's float32 smallk jitter (``smallk_truncated_dvec``'s default)
JAX_F32_JITTER = 1e-6


@contextlib.contextmanager
def f32_rule():
    """Inside the block both packages' float64 smallk stages make the
    float32 choices: the jitter and the direction count."""
    saved = (jax_eig.smallk_truncated_dvec, jax_basis.smallk_k_eff,
             basis.smallk_k_eff, eig.JITTER[torch.float64])
    dvec, jk, pk, _ = saved
    jax_eig.smallk_truncated_dvec = functools.partial(dvec,
                                                      jitter=JAX_F32_JITTER)
    jax_basis.smallk_k_eff = lambda cD, dtype, dirs: jk(cD, np.float32, dirs)
    basis.smallk_k_eff = lambda cD, dtype, dirs: pk(cD, torch.float32, dirs)
    eig.JITTER[torch.float64] = eig.JITTER[torch.float32]
    try:
        yield
    finally:
        (jax_eig.smallk_truncated_dvec, jax_basis.smallk_k_eff,
         basis.smallk_k_eff, eig.JITTER[torch.float64]) = saved


def exact_field(judge, Phi, A_st):
    """The field prolonged from the basis (Phi, A_st), its coarse system
    solved exactly: ``judge``'s (a float64 port solver's) placement, rhs
    and canvases, numpy's dense solve."""
    Phi = torch.as_tensor(np.array(Phi), dtype=torch.float64)
    A_st = torch.as_tensor(np.array(A_st), dtype=torch.float64)
    A = judge.coarse_dense_matrix(A_st).numpy()
    rhs = CoarseSystem(judge, A_st).rhs(Phi, judge.fem_rhs).numpy()
    x = np.linalg.solve(A, rhs.reshape(-1)).reshape(rhs.shape)
    out = torch.zeros((judge.grid.n_nodes, judge.C), dtype=torch.float64)
    out.index_add_(0, judge.canvas_gidx.reshape(-1),
                   torch.einsum("pncd,pd->pnc", Phi,
                                torch.as_tensor(x)).reshape(-1, judge.C))
    return out.numpy()


def judge_solver():
    cfg64 = pt.SLODConfig(**dict(KW, dtype="float64"))
    judge = pt.LODSolver(cfg64, pt.DiffusionProblem(cfg64), device="cpu",
                         verbose=False)
    judge.assemble_fine_rhs()
    return judge


def jax_field(judge, dtype, pert=0.0, seed=0):
    """JAX's prolonged field of ``dtype``, its coefficients moved by
    ``pert`` relative (seeded normal noise) when that is not 0."""
    jcfg = JaxConfig(**dict(KW, dtype=dtype))
    js = JaxLOD(jcfg, JaxDiffusion(jcfg), verbose=False)
    if pert:
        rng = np.random.default_rng(seed)
        js.coef_q = {k: (np.asarray(v, np.float64) * (
            1 + pert * rng.standard_normal(v.shape))).astype(v.dtype)
            for k, v in js.coef_q.items()}
    js.compute_basis()
    js.assemble_coarse_operator()
    return exact_field(judge, js.Phi, js.A_stencil)


def port_field(judge, dtype):
    cfg = pt.SLODConfig(**dict(KW, dtype=dtype))
    ps = pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device="cpu",
                      verbose=False, eig_block=1)
    ps.compute_basis()
    ps.assemble_coarse_operator()
    assert ps.spec_mode == "smallk" and ps.solver_mode == "fused"
    return exact_field(judge, ps.Phi, ps.A_stencil)


def all_fields(judge):
    """(package, variant) -> the prolonged field of that basis; the
    variants are float32, float64 and float64 under the float32 rule."""
    fields = {}
    for pkg, field in (("jax", jax_field), ("port", port_field)):
        for dtype in ("float32", "float64"):
            fields[pkg, dtype] = field(judge, dtype)
        with f32_rule():
            fields[pkg, "float32 rule"] = field(judge, "float64")
    return fields


def gaps(fields, variant):
    """The JAX gap of ``variant`` from float64, the port's gap and their
    difference, relative to max |JAX float64 field|."""
    scale = np.abs(fields["jax", "float64"]).max()
    gap = {pkg: fields[pkg, variant] - fields[pkg, "float64"]
           for pkg in ("jax", "port")}
    return (np.abs(gap["jax"]).max() / scale,
            np.abs(gap["port"]).max() / scale,
            np.abs(gap["port"] - gap["jax"]).max() / scale)


@pytest.fixture(scope="module")
def fields():
    return all_fields(judge_solver())


@pytest.mark.parametrize("variant", list(GAP_TOL))
def test_float32_float64_gap_matches_jax(fields, variant):
    jax_gap, _, apart = gaps(fields, variant)
    assert jax_gap > GAP_TOL[variant]
    assert apart <= GAP_TOL[variant]


def calibrate():
    """The numbers behind ``GAP_TOL``: each variant's two gaps from
    float64, and JAX's field's move under three relative coefficient
    changes of about its rounding (1e-7 in float32, 1e-15 in float64 under
    the float32 rule); then, on 3D refine-2 l=2, how many patches the SLOD
    truncation runs on in each dtype (float32's jitter keeps ||d0||_inf
    below its 0.5)."""
    judge = judge_solver()
    fields = all_fields(judge)
    scale = np.abs(fields["jax", "float64"]).max()
    for variant in GAP_TOL:
        print(f"{variant} - float64 gap: JAX %.3e, the port %.3e, %.3e "
              "apart" % gaps(fields, variant))
    for variant, dtype, pert in (("float32", "float32", 1e-7),
                                 ("float64", "float64", 1e-15),
                                 ("float32 rule", "float64", 1e-15)):
        ref = fields["jax", variant]
        print(f"the port's {variant} field from JAX's "
              f"{np.abs(fields['port', variant] - ref).max() / scale:.3e}")
        with f32_rule() if variant == "float32 rule" else \
                contextlib.nullcontext():
            for seed in range(3):
                moved = jax_field(judge, dtype, pert, seed)
                print(f"JAX {variant} move at a {pert:g} change (seed "
                      f"{seed}): {np.abs(moved - ref).max() / scale:.3e}")
    scan, seen = eig._truncation_scan, []

    def spy(d0, rev):
        seen.append(d0.abs().amax(-1))
        return scan(d0, rev)

    eig._truncation_scan = spy
    try:
        for dtype in ("float32", "float64"):
            seen.clear()
            cfg = pt.SLODConfig(**dict(KW, dim=3, n_global_refinements=2,
                                       dtype=dtype))
            pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device="cpu",
                         verbose=False, eig_block=1).compute_basis()
            d = torch.cat(seen)
            print(f"3D refine-2 l=2 {dtype}: max ||d0||_inf "
                  f"{float(d.max()):.3f}, {int((d >= 0.5).sum())} of "
                  f"{len(d)} patches truncate")
    finally:
        eig._truncation_scan = scan


if __name__ == "__main__":
    import jax
    jax.config.update("jax_enable_x64", True)
    calibrate()
