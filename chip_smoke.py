#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``dealii_slod_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --phases device,build,kernels --root DIR
        # DIR (inside this checkout) holds another commit's package, for
        # example the parent's from ``git archive``: the same phases and
        # timing code on its kernels, so two commits compare like for like

Phases (each prints its numbers; any failure exits non-zero):

1. device: torch's device name and nvidia-smi's name / power limit;
2. build: nvcc builds ``dealii_slod_tpu_torch/csrc`` (timed);
3. kernels: K1, K2, K3, K4, K5 (on the smallk W, the warp-per-matrix
   routine, and on the Jacobi route's factor rows, the CTA routine) and
   K8 against their plain PyTorch versions on the first 128-patch chunk
   of the main-path configuration (real assembled operators and Grams),
   in float64 (relative max error <= 1e-10) and float32 (error against
   the f64 plain version <= 4x the f32 plain version's own error + 1e-6);
   K4 on the real subspace iterate is held to its contract
   (orthonormality, span), elementwise on a well-conditioned block
   (against the plain version and its twin in the kernel's order), and
   also at the float64 main step's shape (k = 124, the columns in shared
   memory).  Each is timed with CUDA events beside its plain version, one
   PyTorch library call computing the same function where there is one,
   and its bound (the larger of FLOPs at 67 TFLOP/s and bytes at 3.35
   TB/s: the H100 SXM's float32 peak outside the tensor cores, its
   float64 peak on them, and its HBM peak); K1 and K6, which multiply on
   the tensor cores, also get that bound with the FLOPs at the 165
   TFLOP/s of a 3xTF32 product, the float64 rows of K4 and K5, which
   multiply on the CUDA cores, with the FLOPs at their 34 TFLOP/s; K1 is
   held against the plain blocked version that sums in the kernel's
   order, and its float32 gate, and K3's, is read on every chunk of the
   configuration, not only on the first.  K3's and
   K7's library call is ``torch.sparse.mm`` (cuSPARSE SpMM) with the
   trace as a block-diagonal CSR matrix of the band.  Each row also
   gives the kernel's device time (the calls queued behind a spin kernel,
   so the host's issue time drops out).  A K5 / K8 row times the wrapper's
   function, sorted and normalized eigenpairs (the kernels now do that
   themselves), and K5 rows also the rows launch alone (``kernel_ms``);
   every K5 row prints the sweeps each matrix ran in the kernel beside the
   plain version's per-matrix count, in both dtypes, so a changed stopping
   rule shows; K8 rows likewise; K5 and K8 also at the float64 main step's
   W (k = 124), and K8's float32 gate is read on the real ZT / YT of every
   chunk of the weig path (recorded from one step of it);
4. el-kernels: the same checks on the middle 128-patch chunk of the 3D
   elasticity configuration (real operators, C = 3): K6 at each leaf of
   the Schur split, K7 on the real band and X, K2 (the register-tiled
   sweep) on a real 128-pivot of T and of G + delta I, K4 / K5 at the
   float32 path's shapes (all 384 Grams of the chunk, k = 32: K5's
   warp-per-matrix routine; K6's float32 gate on the leaves of every
   chunk of the configuration, K7's on every chunk's X), and K4 / K5 at
   the float64 path's Gram size (n = 375, k = 374: K4's global-memory
   columns, K5's thread-block cluster, held in float64 only, the one
   dtype that runs them; K5 on 4 of the W against the plain version, its
   eigenvalues on all 384 W against ``torch.linalg.eigh``'s, both timed
   on all 384, with the cluster size, a second bound at the rows'
   shared-memory traffic and, at the end, its device time per float64
   refine-3 step); K8 at the float32 path's shape (384, 32, 375) and, in
   float64, at k = 374 (a cluster per W, no workspace: 4 W compared and
   timed, the eigenvalues of all 384 against the plain version's), each
   with the route it took; K1 on the whole 2187 block is timed beside the
   split, for the record;
5. e2e-f64: small steps in float64 on the CPU (plain versions) and on the
   card (kernels): 3D refine-2 l=1 diffusion on the Jacobi and on the
   smallk route, and 3D refine-2 l=1 elasticity on the Schur split; u and
   the prolonged field agree to 1e-8 relative;
6. jacobi: the earlier path, the 4096-patch step with
   ``eig_solver="jacobi"`` in float32: one first call and 1 timed call,
   K1, K2, K3 and K5 launched;
7. main: the ``bench.py`` default (3D, 16^3 coarse cells = 4096 patches,
   l=2, s=2, coef_refinement=5, float32, chunks of 128,
   ``eig_solver="auto"`` = smallk on the card): one first call and 2 timed
   calls, every kernel launched, finite non-zero u, converged CG; then the
   same step in float64 (``eig_solver="smallk"``, the ``main-f64`` path:
   one first call and 1 timed call, its launches counted), prolonged
   fields within 1e-2;
8. weig: the main configuration with ``smallk_weig=True`` (K8): one
   first call and one timed call, prolonged field within 1e-2 of main's
   float64 field; then the same in float64 (``weig-f64``, K8 at k = 124),
   its field against ``main-f64``'s (``WEIG_FIELD_BOUND``);
9. elasticity: ``BENCH_PROBLEM=elasticity``'s configuration (the main
   one with C = 3 components, Lame fields lam / mu, rhs "1; 1; 1"):
   ``patch_solver="auto"`` must resolve to the Schur split and the
   spectral stage to smallk; one first call and 2 timed calls, K2, K4,
   K5, K6, K7 launched as often as the code path implies; then refine-3
   l=2 (512 patches) in float32 and in float64 (K4 on global columns, K5
   on a thread-block cluster per W), and the same two with
   ``smallk_weig=True`` (K8 four times a step, no K5; each field against
   the same dtype's path with K5, ``WEIG_FIELD_BOUND``), prolonged fields
   of each pair within 1e-2;
10. run: ``LODSolver(...).run()`` on the card, the whole pipeline (basis,
   coarse operator and solve, fine FEM, coarse FEM, error tables), each
   run a path of its own: ``run-2d-default`` (``SLODConfig()``, the
   reference's example: 2D plain LOD in float64; the golden fem rhs l2
   norm 0.109375, 81 / 16 dofs, 16 patches of sizes 4..9, every table
   equal to the CPU run's to 1e-10), ``run-plain-f64`` (the main grid,
   plain LOD in float64, the fine solve on the dense two-level
   preconditioner), ``run-slod-eigh-f64`` (the same with SLOD:
   "auto" = the ``torch.linalg.eigh`` stage, its time printed; its
   LOD-vs-FEMh L2 error and prolonged field against the float64 smallk
   step on the same field, ``EIGH_BOUND``, which two faulty eigh stages
   must exceed; and refine-3's eigh step against the same route on
   the CPU, within 10x the card's own change under a 1e-15 coefficient
   change and at least ``EIGH_CPU_BOUND``, which each faulty stage must
   exceed),
   ``run-elasticity`` (the elasticity configuration in float32 with the
   stencil two-level preconditioner and the coarse FEM's CG branch) and
   ``run-cli`` (the CLI once, 2D diffusion in float32, into a temporary
   directory: rc 0, the parameter dump and three VTU files, the launches
   its code path implies, tables and LOD field within ``CLI_F32_BOUND``
   of the same configuration's float32 run on the CPU).  Each prints its
   stage walls, peak memory, tables and launches;
11. routes: the remaining basis and coarse routes.  The classes oracle:
   3D refine-3 l=2 (512 patches) in float64, the uniform default route
   (K1, K2, K3, the eigh stage) against ``kernel_mode="classes"`` (no
   kernel) with SLOD and plain LOD on the random field, and with SLOD on
   a constant field, where the uniform route dedups (``CLASSES_BOUND``);
   ``patch_solver="panel"`` on the 4096-patch main configuration beside
   the fused step, in turns in one process (walls, patches/s, K2's
   launches), its prolonged field against the fused step's in float64
   and its float32 X and T in K1's float32 gate on every chunk; the
   direct coarse solve on the 4096-patch float64 step against CG (walls);
   a basis checkpoint saved and loaded on the card; the scatter assembly
   and ``trace_kernel="off"`` (no K3) against the default route at
   refine-3 float64; and the examples ``convergence_study
   --refinements 3 4 5`` and ``multi_rhs`` on the card.

Every path counts its kernel launches from 0, set just before its first
call and read just after its last; each K4 row's device time per step of
its path (launches x device ms) is printed, and K5's and K8's on the
float64 refine-3 paths (launches x device ms on all 384 W of a chunk).  The
second-to-last line is the JSON kernel table, the last line ``{"ok":
true, "device": {...}}``.  No JAX is imported.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "kernels", "el-kernels", "e2e-f64", "jacobi",
          "main", "weig", "elasticity", "run", "routes")
# H100 SXM: float32 outside the tensor cores, float64 on them (DMMA)
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
SMS, SMEM_BYTES_PER_CLK = 132, 128   # H100 SXM: SMs, shared memory B/clk
# second bounds beside ``bound_ms``: row key -> (FLOP/s, what runs at it)
SECOND_PEAKS = {
    # TF32 tensor cores, 495e12 / 3 products (K1, K6)
    "bound_ms_3xtf32": (165e12, "165 TFLOP/s (3xTF32)"),
    # float64 outside the tensor cores, where K4 and K5 multiply
    "bound_ms_f64_cuda_cores": (34e12, "34 TFLOP/s (float64 CUDA cores)"),
}
# kernel -> (source, replaced Pallas call, path whose run counts it)
SOURCE = {
    "K1 fused_spd_multirhs": ("dealii_slod_tpu_torch/csrc/patch_solve.cu",
                              "dealii_slod_tpu/ops/patch_solve.py:894",
                              "main"),
    "K2 gj_inverse": ("dealii_slod_tpu_torch/csrc/patch_solve.cu",
                      "dealii_slod_tpu/ops/patch_solve.py:474", "main"),
    "K3 stencil_trace": ("dealii_slod_tpu_torch/csrc/stencil_trace.cu",
                         "dealii_slod_tpu/ops/assembly.py:409", "main"),
    "K4 mgs_qr": ("dealii_slod_tpu_torch/csrc/mgs_qr.cu",
                  "dealii_slod_tpu/ops/eig.py:696", "main"),
    "K5 jacobi_eigh": ("dealii_slod_tpu_torch/csrc/jacobi_eigh.cu",
                       "dealii_slod_tpu/ops/eig.py:408", "main"),
    "K6 spd_multirhs_solve": ("dealii_slod_tpu_torch/csrc/patch_solve.cu",
                              "dealii_slod_tpu/ops/patch_solve.py:640",
                              "elasticity"),
    "K7 stencil_trace": ("dealii_slod_tpu_torch/csrc/stencil_trace.cu",
                         "dealii_slod_tpu/ops/assembly.py:481",
                         "elasticity"),
    "K8 weig": ("dealii_slod_tpu_torch/csrc/jacobi_eigh.cu",
                "dealii_slod_tpu/ops/eig.py:524", "weig"),
}
_ELASTIC = ("K2 gj_inverse", "K4 mgs_qr", "K5 jacobi_eigh",
            "K6 spd_multirhs_solve", "K7 stencil_trace")
_ELASTIC_WEIG = ("K2 gj_inverse", "K4 mgs_qr", "K6 spd_multirhs_solve",
                 "K7 stencil_trace", "K8 weig")
_MAIN = ("K1 fused_spd_multirhs", "K2 gj_inverse", "K3 stencil_trace",
         "K4 mgs_qr", "K5 jacobi_eigh")
_WEIG = ("K1 fused_spd_multirhs", "K2 gj_inverse", "K3 stencil_trace",
         "K4 mgs_qr", "K8 weig")
PATH_KERNELS = {
    "jacobi": ("K1 fused_spd_multirhs", "K2 gj_inverse", "K3 stencil_trace",
               "K5 jacobi_eigh"),
    "main": _MAIN,
    "weig": _WEIG,
    "elasticity": _ELASTIC,
    "elasticity-r3-f32": _ELASTIC,
    "elasticity-r3-f64": _ELASTIC,
    "main-f64": _MAIN,
    "weig-f64": _WEIG,
    "elasticity-r3-weig-f32": _ELASTIC_WEIG,
    "elasticity-r3-weig-f64": _ELASTIC_WEIG,
    # LODSolver.run(): plain LOD and the eigh stage skip K4 / K5
    "run-2d-default": _MAIN[:3],
    "run-plain-f64": _MAIN[:3],
    "run-slod-eigh-f64": _MAIN[:3],
    "run-elasticity": _ELASTIC,
    "run-cli": _MAIN[:3],
    # the routes phase: the classes route runs no kernel; the uniform
    # default route at refine-3 f64 runs the eigh stage (no K4 / K5); the
    # panel route K2 on its diagonal blocks and no K1; scatter and "off"
    # no K3; the direct coarse solve no kernel of its own
    "routes-classes-slod": (),
    "routes-classes-lod": (),
    "routes-classes-slod-const": (),
    "routes-uniform-slod": _MAIN[:3],
    "routes-uniform-lod": _MAIN[:3],
    "routes-uniform-slod-const": _MAIN[:3],
    "routes-panel-f32": _MAIN[1:],
    "routes-fused-f32": _MAIN,
    "routes-panel-f64": _MAIN[1:],
    "routes-fused-f64": _MAIN,
    "routes-default-r3-f64": _MAIN[:3],
    "routes-scatter-r3-f64": _MAIN[:2],
    "routes-off-r3-f64": _MAIN[:2],
    "routes-direct-f64": _MAIN,
}
# a weig path's prolonged field against the same dtype's path with K5 on
# the symmetrized W (the weig path -> (that path, bound)): each bound is 10x
# the difference that K8's previous design (a warp per pair on the W built
# in float32 / float64 sums) gave on an NVIDIA H100 80GB HBM3 (1.084e-12,
# 5.708e-07, 1.004e-05; PERF.md section 6)
# the eigh run's LOD-vs-FEMh L2 error and prolonged field against the
# float64 smallk step on the same field (smallk resolves all 125
# directions in float64, its W to the Jacobi stop at smallk_tol = 3e-6):
# 10x the relative differences an NVIDIA H100 80GB HBM3 gave (7.515e-06,
# 1.300e-07)
EIGH_BOUND = {"L2": 7.515e-05, "field": 1.300e-06}
# the eigh route on the card against the same route on the CPU, float64,
# refine-3 l=2 (512 patches): the prolonged fields' rel max difference is
# held to 10x the card's own change when the coefficients move by 1e-15
# relative, and never below this (the Grams' near-null directions are
# resolved differently by two LAPACKs, as tests/test_torch_plain_lod.py
# bounds the port against JAX)
EIGH_CPU_BOUND = 1e-10
# the CLI's run on the card (float32, SLODConfig()'s 2D shapes) against the
# same configuration's run on the CPU in float32: every table value and the
# LOD field, relative; 10x the float32-vs-float64 differences of that run
# on the CPU (<= 8.8e-7 in the tables, 7.3e-7 in the field)
CLI_F32_BOUND = 1e-5
# routes phase: the classes oracle's cases (3D refine-3 l=2 float64, the
# uniform default route against kernel_mode="classes") and their Phi bounds:
# 3e-7 with SLOD and 1e-11 for plain LOD (tests/test_uniform.py's), or 10x
# the same two routes' gap on the CPU where that is larger
# (scripts/classes_gap.py: 8.906e-07 with SLOD, 1.027e-15 plain, 1.285e-05
# with SLOD on the constant field, the uniform route deduped)
CLASSES_CASES = {"slod": {}, "lod": dict(lod_stabilization=False),
                 "slod-const": dict(constant_coefficients=True)}
CLASSES_BOUND = {"slod": 8.906e-06, "lod": 1e-11, "slod-const": 1.285e-04}
# the panel step's prolonged field against the fused step's (float64,
# 4096 patches, smallk); scatter and "off" against the default route
# (refine-3 float64, eigh): "off" at 1e-10, scatter at 10x the largest
# difference measured on an H100 (1.597e-10), since index_add_ on CUDA
# adds in no fixed order and the eigh stage carries that rounding into
# the field; the direct coarse solution against a CG solve to 1e-12 on
# the same operator
PANEL_F64_BOUND = 1e-9
ROUTE_FIELD_BOUND = {"scatter": 1.6e-9, "off": 1e-10}
DIRECT_BOUND = 1e-6
WEIG_FIELD_BOUND = {
    "weig-f64": ("main-f64", 1.084e-11),
    "elasticity-r3-weig-f32": ("elasticity-r3-f32", 5.708e-06),
    "elasticity-r3-weig-f64": ("elasticity-r3-f64", 1.004e-04),
}


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def rel(a, b) -> float:
    """max |a - b| / max |b| (b the reference)."""
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-300))


def bench_cfg(dtype, **kw):
    """The ``bench.py`` default configuration (bench.py:323-355)."""
    from dealii_slod_tpu_torch import ReductionControl, SLODConfig
    base = dict(dim=3, n_global_refinements=4, n_subdivisions=2,
                oversampling=2, lod_stabilization=True,
                constant_coefficients=False, coef_seed=0, coef_refinement=5,
                rhs="1", bc="0", dtype=dtype, patch_chunk=128,
                solve_fine_problem=False,
                coarse_solver=ReductionControl(500, 1e-6, 1e-6),
                eig_solver="auto", patch_solver="auto", trace_kernel="auto",
                eig_sweeps=12, eig_tol=3e-6, smallk_dirs=32, smallk_power=3,
                smallk_tol=3e-6, smallk_weig=False)
    base.update(kw)
    return SLODConfig(**base)


def elastic_cfg(dtype, **kw):
    """``BENCH_PROBLEM=elasticity python bench.py``'s configuration
    (bench.py:293-359): the default one, with C = 3 and rhs "1; 1; 1"."""
    return bench_cfg(dtype, **dict(dict(rhs="1; 1; 1"), **kw))


def make_solver(cfg, elastic, **kw):
    from dealii_slod_tpu_torch import (DiffusionProblem, ElasticityProblem,
                                       LODSolver)
    problem = (ElasticityProblem if elastic else DiffusionProblem)(cfg)
    return LODSolver(cfg, problem, verbose=False, **kw)


def expected_launches(s):
    """Kernel launches per basis build that the solver's code path implies:
    per chunk of the patches it built (``s.basis_patches``: all P, or the
    unique window signatures of a deduped constant field) the patch solve
    (K1 once, K6 once per leaf of the Schur split, K2 once per diagonal
    block of the panel LDL^T, none for the per-patch Cholesky solve), K2
    once per 128-pivot of T^-1 and, on the smallk route, of
    (G + delta I)^-1, A phi and, with SLOD, the trace (K3 at C = 1, K7 at
    C > 1; neither under ``trace_kernel="off"`` or the scatter assembly),
    and the spectral stage (smallk: K4 per subspace step and K5, or K8,
    once; Jacobi: K5 once; eigh: no kernel).  The classes route launches
    no kernel."""
    from dealii_slod_tpu_torch.ops.patch_solve import (GJ_PAD,
                                                       panel_k2_launches,
                                                       split_leaves)
    if s.cfg.kernel_mode != "uniform":
        return {}
    tab = s._tables
    per = {}
    smallk = tab.slod and tab.spec_mode == "smallk"
    per["K2 gj_inverse"] = -(-tab.cD // GJ_PAD) * (2 if smallk else 1)
    if tab.solver_mode == "fused_split":
        per["K6 spd_multirhs_solve"] = len(split_leaves(tab.nI, tab.cD,
                                                        tab.panel_nb))
    elif tab.solver_mode == "fused":
        per["K1 fused_spd_multirhs"] = 1
    elif tab.solver_mode == "panel":
        per["K2 gj_inverse"] += panel_k2_launches(tab.nI, tab.panel_nb)
    if tab.trace_kernel and not tab.scatter:
        per["K3 stencil_trace" if tab.C == 1 else "K7 stencil_trace"] = \
            2 if tab.slod else 1
    if smallk:
        per["K4 mgs_qr"] = max(1, tab.smallk_power)
        per["K8 weig" if tab.smallk_weig else "K5 jacobi_eigh"] = 1
    elif tab.slod and tab.spec_mode == "jacobi":
        per["K5 jacobi_eigh"] = 1
    B = s.basis_patches
    chunks = -(-B // (s.cfg.patch_chunk or B))
    return {k: v * chunks for k, v in per.items()}


def device_ms(fn, reps=3):
    """Device time of one call of ``fn``: the ``reps`` calls are queued
    behind a ~25 ms spin kernel, so the events around them time the
    device's work, not the host's time to issue a call whose device work
    is shorter (``cuda_ms``)."""
    import torch
    fn()                                      # warm-up
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(50_000_000)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def k5_fns(sweeps, tol, n0=None):
    """K5 on (B, n, n) rows, n even, of which n0 (default n) are the
    matrix's -> the sorted eigenpairs (each matrix stops on its own):
    (kernel, plain version, the kernel's rows launch alone).  The kernel
    sorts and normalizes the eigenpairs itself; a checkout from before that
    (``--root``) runs what its wrapper ran, the rows launch and
    ``_finalize_rows``, which is also the plain version's glue."""
    from dealii_slod_tpu_torch.ops import eig

    def rows(g):
        return eig._jacobi_rows_cuda(g, sweeps, tol,
                                     eig._default_null_rel(g.dtype))

    def kern(g):
        m = n0 or g.shape[-1]
        if hasattr(eig, "_jacobi_eigh_cuda"):
            return eig._jacobi_eigh_cuda(g, m, sweeps, tol,
                                         eig._default_null_rel(g.dtype))
        return eig._finalize_rows(*rows(g), m, (g.shape[0],))

    def plain(g):
        XT, XB = eig.jacobi_rows_plain(g, sweeps, 1, tol,
                                       eig._default_null_rel(g.dtype))
        return eig._finalize_rows(XT, XB, n0 or g.shape[-1], (g.shape[0],))
    return kern, plain, rows


def cuda_ms(fn, reps=3):
    import torch
    fn()                                      # warm-up
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# ---------------------------------------------------------------------------

def sm_clock_hz():
    """The card's top SM clock (``nvidia-smi``'s clocks.max.sm), in Hz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[device] torch: {name}; count {torch.cuda.device_count()} "
          f"(this run uses 1); torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    print(card)
    return name, card


def phase_build():
    from dealii_slod_tpu_torch.utils import kernels
    t0 = time.perf_counter()
    path = kernels.library()._name
    dt = time.perf_counter() - t0
    print(f"[build] {dt:.2f} s  {os.path.relpath(path, HERE)}")


def chunk_inputs(elastic=False, chunk=128):
    """Real operators of one chunk of patches, float64: the first chunk of
    the main-path configuration, or the chunk at the middle of the
    elasticity configuration's patch range (its first chunk lies in the
    z = 0 layer, where the leading block of the Schur split is masked dofs
    only: an identity block with zero right-hand sides).  Returns the
    solver, its tables, the coefficient windows and the window data."""
    import torch
    from dealii_slod_tpu_torch.models import basis
    cfg = (elastic_cfg if elastic else bench_cfg)("float64",
                                                  eig_solver="smallk")
    s = make_solver(cfg, elastic)
    tab = s._uniform_tables()
    _, nlo, nhi, sides = s._uniform_inputs()
    p0 = (s.topo.n_patches // 2 // chunk) * chunk if elastic else 0
    sel = slice(p0, p0 + chunk)
    cw = {k: basis.coef_windows(cfg, s.grid, s.coef_q[k])[sel]
          for k in tab.coef_names}
    lo = torch.as_tensor(nlo[sel], device="cuda")
    hi = torch.as_tensor(nhi[sel], device="cuda")
    sd = torch.as_tensor(sides[sel], device="cuda")
    print(f"[kernels] chunk of patches {p0}..{p0 + chunk - 1} of "
          f"{s.topo.n_patches} ({'elasticity' if elastic else 'main'})")
    return s, tab, cw, lo, hi, sd


def jacobi_sweep_counts(G, sweeps, tol, null_rel):
    """Sweeps each matrix of G (B, n, n) runs under the kernels' per-matrix
    adaptive stop: the plain K5 loop (block=1), counting."""
    import torch
    from dealii_slod_tpu_torch.ops import eig
    B, n, _ = G.shape
    if tol <= 0:
        return torch.full((B,), sweeps)
    eps = eig._eps(G.dtype)
    XT, XB = G[:, 0::2, :].clone(), G[:, 1::2, :].clone()

    def norms(XT, XB):
        return ((XT * XT).sum(-1, keepdim=True),
                (XB * XB).sum(-1, keepdim=True))

    a0, b0 = norms(XT, XB)
    amax2 = torch.amax(torch.maximum(a0, b0), dim=-2, keepdim=True)
    active = torch.ones(B, dtype=torch.bool, device=G.device)
    off = torch.full((B,), eig._F32_MAX, dtype=G.dtype, device=G.device)
    count = torch.zeros(B, dtype=torch.int64, device=G.device)
    for _ in range(sweeps):
        active = active & (off > tol)
        if not bool(active.any()):
            break
        count += active
        XT0, XB0 = XT, XB
        a, b = norms(XT, XB)
        o = G.new_zeros(B)
        for _ in range(n - 1):
            XT, XB, a, b, o = eig._caterpillar_round_nj(
                XT, XB, a, b, eps, off=o, amax2=amax2, null_rel=null_rel)
        act = active[:, None, None]
        XT, XB = torch.where(act, XT, XT0), torch.where(act, XB, XB0)
        off = torch.where(active, o, off)
    return count.cpu()


def sweep_flops(counts, n):
    """FLOPs of the one-sided Jacobi sweeps: per sweep the exact row norms
    (2 n^2) and n - 1 rounds of n / 2 pair dots (2n) and rotations (6n);
    plus the initial norms."""
    return float(counts.sum()) * (2 * n * n + 4 * n * n * (n - 1)) \
        + 2 * n * n * len(counts)


def k5_err(out, ref):
    """Eigenvalue error relative to lambda_max, and the eigenvector error
    of eigenpairs separated from their neighbours by more than 1e-6 (f64)
    / 1e-2 (f32) of lambda_max: vectors of tighter clusters are determined
    only up to a rotation within the cluster, which rounding picks."""
    import torch
    lam, V = out
    sep_rel = 1e-6 if lam.dtype == torch.float64 else 1e-2
    lam_r, V_r = ref
    lmax = lam_r[:, :1].double()
    e_lam = float(((lam.double() - lam_r.double()).abs() / lmax).max())
    gaps = (lam_r[:, :, None] - lam_r[:, None, :]).abs().double() / lmax[
        :, :, None]
    gaps = gaps + torch.eye(gaps.shape[-1], device=gaps.device,
                            dtype=gaps.dtype) * 1e300
    sep = gaps.amin(-1) > sep_rel
    cos = (V.double() * V_r.double()).sum(1).abs()
    e_vec = float(((1.0 - cos) * sep).max())
    return max(e_lam, e_vec)


def qr_contract_err(Q, X):
    """max(|Q^T Q - I|, |Q Q^T X - X| / |X|) over the batch (f64)."""
    import torch
    Q, X = Q.double(), X.double()
    eye = torch.eye(Q.shape[-1], dtype=Q.dtype, device=Q.device)
    orth = float((Q.mT @ Q - eye).abs().max())
    span = float((Q @ (Q.mT @ X) - X).abs().max() / X.abs().max())
    return max(orth, span)


def k4_block_check(name, X_wc, X_real, f32=True):
    """K4 elementwise: on the well-conditioned block X_wc (float64) within
    1e-10 of the plain version and of the plain twin that sums in the
    kernel's order, and in float32 (unless ``f32`` is False) within 4x the
    plain float32 version's error + 1e-6 of the float64 plain version.  On
    the real iterate X_real (float64), whose columns span decades, the
    elementwise float64 differences are printed (the row's contract check
    holds it): the kernel against the plain version and against the twin,
    and, as the input's own witness, the two plain versions against each
    other (no kernel), also on the CPU on the first 8 matrices beside the
    kernel's distance on those."""
    from dealii_slod_tpu_torch.ops import eig
    twin = eig.mgs_qr_panel_plain
    ref = eig.mgs_qr_plain(X_wc)
    Q = eig.mgs_qr(X_wc)
    e64, e_twin = rel(Q, ref), rel(Q, twin(X_wc))
    ok = e64 <= 1e-10 and e_twin <= 1e-10
    msg = (f"f64 err {e64:.3e} (<= 1e-10), against the kernel-order twin "
           f"{e_twin:.3e}")
    if f32:
        e32 = rel(eig.mgs_qr(X_wc.float()), ref)
        base32 = rel(eig.mgs_qr_plain(X_wc.float()), ref)
        ok = ok and e32 <= 4 * base32 + 1e-6
        msg += (f", f32 err {e32:.3e} vs plain-f32 {base32:.3e} (bound "
                f"{4 * base32 + 1e-6:.3e})")
    Qr, Pr, Tr = eig.mgs_qr(X_real), eig.mgs_qr_plain(X_real), twin(X_real)
    sub = X_real[:8].cpu()
    ref_sub = eig.mgs_qr_plain(sub)
    print(f"[kernels] {name} on a well-conditioned X {tuple(X_wc.shape)}: "
          f"{msg}: {ok}; on the real iterate, f64 elementwise "
          f"{rel(Qr, Pr):.3e}, against the twin {rel(Qr, Tr):.3e}, the "
          f"twin against the plain version {rel(Tr, Pr):.3e} (no kernel); "
          f"first 8 matrices: the kernel {rel(Qr[:8].cpu(), ref_sub):.3e}, "
          f"the twin on the CPU {rel(twin(sub), ref_sub):.3e} (no kernel)")
    check(ok, f"{name} disagrees with its plain version")


def by(flops, nbytes, peak=PEAK_FLOPS):
    """The bound (ms, what bounds it) of work of ``flops`` operations
    moving ``nbytes`` bytes."""
    t_f, t_b = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_f, "operations") if t_f >= t_b else (t_b, "bytes")


def sweeps_bound(G, sweeps, tol, extra_flops, nbytes):
    """K5's / K8's bound with the sweeps this input needs under the
    per-matrix stop."""
    from dealii_slod_tpu_torch.ops import eig
    c = jacobi_sweep_counts(G, sweeps, tol, eig._default_null_rel(G.dtype))
    print(f"[kernels]   sweeps per matrix on the {str(G.dtype)[6:]} input: "
          f"mean {float(c.double().mean()):.2f}, max {int(c.max())}")
    return by(extra_flops + sweep_flops(c, G.shape[-1]), nbytes)


def k5_sweep_report(name, make, sweeps, tol, dtypes=("float32", "float64")):
    """The sweeps each matrix of ``make(dtype)`` (B, n, n) ran in K5, beside
    the plain version's count under the same per-matrix stop, in each
    dtype: a changed stopping rule shows as matrices whose counts
    differ."""
    import inspect

    import torch
    from dealii_slod_tpu_torch.ops import eig
    if "counts" not in inspect.signature(eig._jacobi_rows_cuda).parameters:
        print(f"[kernels] {name}: this checkout's K5 reports no sweep counts")
        return
    parts = []
    for dt in dtypes:
        g = make(getattr(torch, dt)).contiguous()
        n_rel = eig._default_null_rel(g.dtype)
        kc = eig._jacobi_rows_cuda(g, sweeps, tol, n_rel,
                                   counts=True)[2].long().cpu()
        pc = jacobi_sweep_counts(g, sweeps, tol, n_rel)
        parts.append(f"{dt[5:]}-bit kernel mean "
                     f"{float(kc.double().mean()):.2f} max {int(kc.max())}, "
                     f"plain mean {float(pc.double().mean()):.2f} max "
                     f"{int(pc.max())}, {int((kc != pc).sum())} of {len(kc)} "
                     f"matrices differ")
    print(f"[kernels] {name}: sweeps per matrix: " + "; ".join(parts))


def k8_fns(sweeps, tol):
    """K8 on (ZT, YT) -> the sorted eigenpairs (each matrix stops on its
    own): (kernel, plain version with block=1)."""
    from dealii_slod_tpu_torch.ops import eig
    return (lambda z, y: eig.weig(z, y, sweeps=sweeps, tol=tol),
            lambda z, y: eig.weig_plain(z, y, sweeps=sweeps, tol=tol,
                                        block=1))


def k8_counts(ZT, YT, sweeps, tol):
    """The sweeps each matrix ran in K8 (None: a checkout whose K8 reports
    none)."""
    from dealii_slod_tpu_torch.ops import eig
    if not hasattr(eig, "_weig_cuda"):
        return None
    return eig._weig_cuda(ZT.contiguous(), YT.contiguous(), sweeps, tol,
                          eig._default_null_rel(ZT.dtype),
                          counts=True)[2].long().cpu()


def k8_work(ZT, YT, sweeps, tol):
    """K8's work on (ZT, YT) (B, k, n): (FLOPs, bytes) of the build (2 k^2
    n a matrix) and of the sweeps this input needs under the per-matrix
    stop (counted by the plain loop on W = ZT YT^T), each input read once,
    the eigenpairs written once."""
    import torch
    from dealii_slod_tpu_torch.ops import eig
    B, k, n = ZT.shape
    c = jacobi_sweep_counts(torch.bmm(ZT, YT.mT), sweeps, tol,
                            eig._default_null_rel(ZT.dtype))
    print(f"[kernels]   sweeps per matrix on the {str(ZT.dtype)[6:]} input: "
          f"mean {float(c.double().mean()):.2f}, max {int(c.max())}")
    return (B * 2.0 * k * k * n + sweep_flops(c, k),
            B * ZT.element_size() * (2 * k * n + k * k + k))


def k8_sweep_report(name, make, sweeps, tol, dtypes=("float32", "float64")):
    """The sweeps each matrix of K8's input ``make(dtype)`` ran in the
    kernel beside the plain version's (block=1, on W = ZT YT^T of the same
    dtype), as ``k5_sweep_report`` does for K5; for float32 inputs also
    beside the plain version's on them cast to float64 (K8 sweeps in
    float64)."""
    import torch
    from dealii_slod_tpu_torch.ops import eig
    parts = []
    for dt in dtypes:
        z, y = make(getattr(torch, dt))
        kc = k8_counts(z, y, sweeps, tol)
        if kc is None:
            print(f"[kernels] {name}: this checkout's K8 reports no sweep "
                  "counts")
            return
        pc = jacobi_sweep_counts(torch.bmm(z, y.mT), sweeps, tol,
                                 eig._default_null_rel(z.dtype))
        msg = (f"{dt[5:]}-bit kernel mean {float(kc.double().mean()):.2f} "
               f"max {int(kc.max())}, plain mean "
               f"{float(pc.double().mean()):.2f} max {int(pc.max())}, "
               f"{int((kc != pc).sum())} of {len(kc)} matrices differ")
        if z.dtype == torch.float32:
            p64 = jacobi_sweep_counts(
                torch.bmm(z.double(), y.double().mT), sweeps, tol,
                eig._default_null_rel(torch.float64))
            msg += (f" (from the plain version on the inputs in float64: "
                    f"{int((kc != p64).sum())})")
        parts.append(msg)
    print(f"[kernels] {name}: sweeps per matrix: " + "; ".join(parts))


def k8_gate_all_chunks(sweeps, tol):
    """K8's float32 gate (error against the float64 plain version <= 4x the
    float32 plain version's + 1e-6, ``k5_err``) on the real ZT / YT of
    every chunk of the float32 weig path, recorded from one step of that
    path (the float64 plain version runs on them cast to float64); beside
    it, per chunk, the sweeps each matrix ran in the kernel, the float32
    and the float64 plain versions (block=1).  Prints the worst
    error-to-gate ratio and the count differences; fails where a ratio
    exceeds 1."""
    import torch
    from dealii_slod_tpu_torch.ops import eig
    s = make_solver(bench_cfg("float32", smallk_weig=True), False)
    s.assemble_fine_rhs()
    step = s.build_step()
    seen, weig = [], eig.weig

    def record(ZT, YT, *a, **kw):
        seen.append((ZT.clone(), YT.clone()))
        return weig(ZT, YT, *a, **kw)

    eig.weig = record
    try:
        step(s.coef_q, s.fem_rhs)
    finally:
        eig.weig = weig
    kern, plain = k8_fns(sweeps, tol)
    n_rel64 = eig._default_null_rel(torch.float64)
    n_rel32 = eig._default_null_rel(torch.float32)
    worst, diff_k32, diff_k64, diff_32_64, n_mat = (0.0, None), 0, 0, 0, 0
    for i, (zt, yt) in enumerate(seen):
        z64, y64 = zt.double(), yt.double()
        ref = plain(z64, y64)
        e, base = k5_err(kern(zt, yt), ref), k5_err(plain(zt, yt), ref)
        g = 4 * base + 1e-6
        if e / g >= worst[0]:
            worst = (e / g, i, e, g)
        kc = k8_counts(zt, yt, sweeps, tol)
        p32 = jacobi_sweep_counts(torch.bmm(zt, yt.mT), sweeps, tol, n_rel32)
        p64 = jacobi_sweep_counts(torch.bmm(z64, y64.mT), sweeps, tol,
                                  n_rel64)
        if kc is None:
            diff_k32 = diff_k64 = "n/a"
        else:
            diff_k32 += int((kc != p32).sum())
            diff_k64 += int((kc != p64).sum())
        diff_32_64 += int((p32 != p64).sum())
        n_mat += len(p32)
    print(f"[kernels] K8 weig: float32 gate on every chunk of the weig path "
          f"({len(seen)} chunks, {n_mat} W): worst error / gate "
          f"{worst[0]:.4f} at chunk {worst[1]} (err {worst[2]:.3e}, gate "
          f"{worst[3]:.3e}); sweeps per matrix: the kernel differs from the "
          f"float32 plain version on {diff_k32} W and from the float64 one "
          f"on {diff_k64}, the two plain versions on {diff_32_64}")
    check(len(seen) == -(-s.topo.n_patches // s.cfg.patch_chunk),
          f"K8 weig: {len(seen)} chunks recorded from the weig path")
    check(worst[0] <= 1.0, f"K8 weig: float32 error over the gate at chunk "
          f"{worst[1]}")


def check_case(table, card, name, shape, make, kern, plain, err, bound, lib,
               path=None, time_dtype="float32", contract=None, f32=True,
               kernel_fn=None):
    """One kernel against its plain version on the inputs ``make(dtype)``:
    float64 within 1e-10 of the f64 plain version, float32 (unless
    ``f32`` is False: sizes only the float64 path runs) within 4x the f32
    plain version's own error + 1e-6 (``err(out, ref)``; where
    ``contract(out, args64)`` is given, the kernel's contract error, and
    the plain f32 version's for the f32 bound, instead); then the kernel,
    its plain version and the library call ``lib`` (or None) timed with
    CUDA events in ``time_dtype``, the kernel's device time (``device_ms``),
    ``kernel_fn`` (where given: the kernel's launch alone, without the glue
    of the wrapper that ``kern`` calls) as ``kernel_ms``, and the bound
    (``bound(args)`` -> (ms, by)).  Adds the row to ``table``."""
    import torch
    args64 = make(torch.float64)
    ref, out64 = plain(*args64), kern(*args64)
    e64 = (contract(out64, args64) if contract is not None
           else err(out64, ref))
    ok64 = e64 <= 1e-10
    ok32, msg32 = True, "f32 not run at this size"
    if f32:
        args32 = make(torch.float32)
        out = kern(*args32)
        if contract is not None:
            e32 = contract(out, args64)
            base32 = contract(plain(*args32), args64)
        else:
            e32, base32 = err(out, ref), err(plain(*args32), ref)
        ok32 = e32 <= 4 * base32 + 1e-6
        msg32 = (f"f32 err {e32:.3e} vs plain-f32 {base32:.3e} (bound "
                 f"{4 * base32 + 1e-6:.3e}: {ok32})")
    else:
        args32, out = None, out64
    if contract is not None:      # the (f32, else f64) kernel's contract
        abs_err = e32 if f32 else e64
    else:
        o = out[0] if isinstance(out, tuple) else out
        r64 = ref[0] if isinstance(ref, tuple) else ref
        abs_err = float((o.double() - r64.double()).abs().max())
    del out64, out, ref
    targs = args64 if time_dtype == "float64" else args32
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: kern(*targs))
    plain_ms = cuda_ms(lambda: plain(*targs))
    library_ms = None if lib is None else cuda_ms(lambda: lib(*targs))
    extra = {"device_ms": device_ms(lambda: kern(*targs))}
    dev_ms = extra["device_ms"]
    if kernel_fn is not None:
        extra["kernel_ms"] = cuda_ms(lambda: kernel_fn(*targs))
    bound_ms, bound_by = bound(targs)
    lib_s = "-" if library_ms is None else f"{library_ms:.3f} ms"
    alone_s = ("" if kernel_fn is None else
               f" (the launch alone {extra['kernel_ms']:.3f} ms)")
    print(f"[kernels] {name} {shape}: f64 err {e64:.3e} (<= 1e-10: "
          f"{ok64}); {msg32}; {time_dtype[5:]}-bit "
          f"{ms:.3f} ms{alone_s}, device {dev_ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, library {lib_s}, bound "
          f"{bound_ms:.4f} ms ({bound_by}; {100 * bound_ms / ms:.2f}% of it) "
          f"[{card}]")
    check(ok64 and ok32, f"{name} disagrees with its plain version")
    kname = name.split(" [")[0]
    src, rep, kpath = SOURCE[kname]
    table.append(dict(name=name, kernel=kname, route="cuda", source=src,
                      replaces=rep, path=path or kpath, shape=shape,
                      dtype=time_dtype, max_abs_err=abs_err, ms=ms,
                      plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by, library_ms=library_ms, **extra))


def second_bound(row, card, flops, nbytes, key):
    """Beside the bound every row has (FLOPs at 67 TFLOP/s), the same
    work's bound with the FLOPs at the peak ``SECOND_PEAKS[key]`` of the
    units the kernel multiplies on, put into the row just added."""
    peak, label = SECOND_PEAKS[key]
    ms, what = by(flops, nbytes, peak)
    row[key] = ms
    print(f"[kernels] {row['name']}: bound at {label} {ms:.4f} ms ({what}; "
          f"{100 * ms / row['ms']:.2f}% of it) [{card}]")


def trace_operand(tab, X):
    """X (B, nI, k) of the patch solve -> the trace's Xp (B, C, nNp, k):
    the interior scattered onto the canvas, components first, the node
    axis zero-padded by shiftN (``basis.stencil_apply``'s layout)."""
    import torch
    from dealii_slod_tpu_torch.models import basis
    B, C, nN = X.shape[0], tab.C, tab.n_nodes
    Xz = basis.scatter_interior(tab, X).reshape(B, nN, C, -1).transpose(1, 2)
    return torch.nn.functional.pad(
        Xz, (0, 0, tab.shiftN, tab.shiftN)).contiguous()


def trace_spmm(band, nNp, shiftN, offs_flat):
    """The library call that computes K3's / K7's function:
    ``torch.sparse.mm`` (cuSPARSE SpMM) of the trace as one CSR matrix of the
    band, block-diagonal over the patches (B C nN rows, 3^dim C nonzeros
    each, columns ascending), times Xp viewed as (B C nNp, k).  The CSR
    is built here, once; the returned call (band, Xp) -> S (B, C, nN, k)
    runs the product alone."""
    import torch
    B, nN, W = band.shape
    n_off = len(offs_flat)
    C = round((W // n_off) ** 0.5)
    dev = band.device
    offs = torch.as_tensor([shiftN + int(o) for o in offs_flat], device=dev)
    b = torch.arange(B, device=dev).view(B, 1, 1, 1, 1)
    n = torch.arange(nN, device=dev).view(1, 1, nN, 1, 1)
    d = torch.arange(C, device=dev).view(1, 1, 1, C, 1)
    cols = ((b * C + d) * nNp + n + offs.view(1, 1, 1, 1, n_off)).expand(
        B, C, nN, C, n_off)                         # (b, c, n, d, o)
    vals = band.reshape(B, nN, n_off, C, C).permute(0, 3, 1, 4, 2)
    crow = torch.arange(B * C * nN + 1, device=dev) * (C * n_off)
    A = torch.sparse_csr_tensor(
        crow.int(), cols.reshape(-1).int(), vals.reshape(-1),
        size=(B * C * nN, B * C * nNp), check_invariants=False)
    return lambda b_, x: torch.sparse.mm(
        A, x.reshape(B * C * nNp, -1)).reshape(B, C, nN, -1)


def spmm_check(name, lib, band, Xp, tab):
    """The trace's library yardstick computes the trace: its float32
    result within 1e-4 of the float64 plain version (a check of the
    function, not of precision)."""
    from dealii_slod_tpu_torch.ops import assembly
    e = rel(lib(None, Xp.float()),
            assembly.stencil_trace_plain(band, Xp, tab.shiftN,
                                         tab.offs_flat))
    print(f"[kernels] {name}: library (torch.sparse.mm, cuSPARSE SpMM) f32 "
          f"err {e:.3e} against the f64 plain version (<= 1e-4)")
    check(e <= 1e-4, f"{name}: the SpMM yardstick computes another "
          "function")


def f32_gate_all_chunks(s, tab, name, chunk=128, solve=None):
    """The float32 gate of ``check_case`` (error against the float64 plain
    version <= 4x the float32 plain version's + 1e-6) on the real
    operators of every chunk of the configuration: K1's X and T, or, on
    the elasticity configuration, K6's X at every leaf of the Schur split;
    and the trace (K3, or K7) on the chunk's band and the X that solve
    gives (the split's X assembled from its plain leaves).  With ``solve``
    (A, B) -> (X, T) in place of K1 (the panel route), that solve's X and
    T alone.  Prints the worst error-to-gate ratio of each; fails where
    one exceeds 1."""
    import torch
    from dealii_slod_tpu_torch.models import basis
    from dealii_slod_tpu_torch.ops import assembly, patch_solve
    split = s.solver_mode == "fused_split"
    full = {k: basis.coef_windows(s.cfg, s.grid, s.coef_q[k])
            for k in tab.coef_names}
    _, nlo, nhi, _ = s._uniform_inputs()
    trace = "K3 stencil_trace" if tab.C == 1 else "K7 stencil_trace"
    worst = {name: (0.0, None, 0.0, 0.0), trace: (0.0, None, 0.0, 0.0)}
    solve = solve or patch_solve.fused_spd_multirhs
    n_cases = 0

    def gate(kname, e, base, where):
        g = 4 * base + 1e-6
        if e / g >= worst[kname][0]:
            worst[kname] = (e / g, where, e, g)

    for p0 in range(0, s.topo.n_patches, chunk):
        sel = slice(p0, p0 + chunk)
        band, A, PT_m, _ = basis.prep(
            tab, {k: v[sel] for k, v in full.items()},
            torch.as_tensor(nlo[sel], device="cuda"),
            torch.as_tensor(nhi[sel], device="cuda"))
        if split:
            (X, _), ops = split_leaf_operands(A, PT_m, tab.panel_nb)
        else:
            ops = [(A, PT_m)]
        del A, PT_m
        for i, (a, b) in enumerate(ops):
            a32, b32 = a.float(), b.float()
            if split:
                ref = patch_solve.spd_multirhs_solve_plain(a, b)
                e = rel(patch_solve.spd_multirhs_solve(a32, b32), ref)
                base = rel(patch_solve.spd_multirhs_solve_plain(a32, b32),
                           ref)
            else:
                ref = patch_solve.fused_spd_multirhs_plain(a, b)
                out = solve(a32, b32)
                pl = patch_solve.fused_spd_multirhs_plain(a32, b32)
                e = max(rel(o, r) for o, r in zip(out, ref))
                base = max(rel(o, r) for o, r in zip(pl, ref))
                X = ref[0]
            n_cases += 1
            gate(name, e, base, f"patches {p0}.., leaf {i + 1}" if split
                 else f"patches {p0}..")
        del ops
        if solve is not patch_solve.fused_spd_multirhs:
            del band, X
            continue
        Xp = trace_operand(tab, X)
        args = (tab.shiftN, tab.offs_flat)
        ref = assembly.stencil_trace_plain(band, Xp, *args)
        b32, x32 = band.float(), Xp.float()
        gate(trace, rel(assembly.stencil_trace(b32, x32, *args), ref),
             rel(assembly.stencil_trace_plain(b32, x32, *args), ref),
             f"patches {p0}..")
        del band, X, Xp, ref, b32, x32
    n_chunks = -(-s.topo.n_patches // chunk)
    gates = [(name, f"{n_cases} solves")]
    if solve is patch_solve.fused_spd_multirhs:
        gates.append((trace, f"{n_chunks} traces"))
    for kname, count in gates:
        w = worst[kname]
        print(f"[kernels] {kname}: float32 gate on every chunk ({count}): "
              f"worst error / gate {w[0]:.4f} at {w[1]} (err {w[2]:.3e}, "
              f"gate {w[3]:.3e})")
        check(w[0] <= 1.0, f"{kname}: float32 error over the gate at "
              f"{w[1]}")


def phase_kernels(card):
    """Each kernel against its plain version at the main-path shapes."""
    import numpy as np
    import torch
    from dealii_slod_tpu_torch.models import basis
    from dealii_slod_tpu_torch.ops import assembly, eig, patch_solve

    s, tab, cw, lo, hi, sd = chunk_inputs()
    band, A, PT_m, cvd = basis.prep(tab, cw, lo, hi)
    X64, Traw = patch_solve.fused_spd_multirhs_plain(A, PT_m)
    T = Traw / tab.Hdim + torch.diag_embed(1.0 - cvd)
    Tinv = patch_solve.gj_inverse_plain(T)
    Xp = trace_operand(tab, X64)
    S99, is99d = basis.trace_S_chunk(tab, band, X64, lo, hi, sd)
    G, _ = basis.finish_pre_from_S(tab, S99, Tinv, cvd, is99d)
    G = G[:, 0]
    B, cD = G.shape[0], G.shape[-1]
    dmax = torch.diagonal(G, dim1=-2, dim2=-1).abs().amax(-1, keepdim=True)
    eye = torch.eye(cD, dtype=G.dtype, device=G.device)

    def factor_rows(dt):
        jit = 1e-13 if dt == torch.float64 else 1e-6
        Gd = G.to(dt)
        L = torch.linalg.cholesky(Gd + (jit * dmax.to(dt))[..., None]
                                  * eye.to(dt))
        Gp = L.new_zeros((B, cD + cD % 2, cD + cD % 2))
        Gp[:, :cD, :cD] = L.mT
        return Gp

    # the smallk stage's operands on the main path (float32 jitter), from
    # the plain f64 chain: the first iterate Ginv Z0, and Z, W after the
    # 3 subspace steps
    k = basis.smallk_k_eff(cD, torch.float32, s.cfg.smallk_dirs)
    check(k == 32, f"main-path smallk directions {k}, expected 32")
    Gj = G + (1e-6 * torch.where(dmax > 0, dmax, 1.0))[..., None] * eye
    Ginv = patch_solve.gj_inverse_plain(Gj)
    Z = eig.smallk_start(cD, k, G.dtype, G.device).expand(B, cD, k)
    X_it = Ginv @ Z
    Z = eig.mgs_qr_plain(X_it)
    for _ in range(tab.smallk_power - 1):
        Z = eig.mgs_qr_plain(Ginv @ Z)
    W = Z.mT @ Gj @ Z
    W = 0.5 * (W + W.mT)
    ZT = Z.mT.contiguous()
    YT = ZT @ Gj
    X_wc = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (B, cD, k)) * np.logspace(0, -5, k), device="cuda")
    sw, st = 8, tab.smallk_tol                  # the W stage's sweeps, tol
    k5w = k5_fns(sw, st)                        # on W
    k5j = k5_fns(tab.sweeps, tab.eig_tol, cD)   # on the factor rows
    k8 = k8_fns(sw, st)

    f4 = 4  # bytes of a float32 (the timed dtype)
    n, kk = A.shape[-1], PT_m.shape[-1]
    k1_work = (B * (n ** 3 / 3 + 2 * n * n * kk + 2 * n * kk * kk),
               B * f4 * (n * n + 2 * n * kk + kk * kk))
    nN, n_off = band.shape[1], band.shape[2]
    nNp = Xp.shape[2]
    m126 = cD + cD % 2
    k3_lib = trace_spmm(band.float(), nNp, tab.shiftN, tab.offs_flat)
    cases = {
        # name: (shape, make(dtype) -> args, kernel, plain, error,
        #        bound (ms, by) from f32 args, library call or None)
        "K1 fused_spd_multirhs": (
            f"A ({B}, {n}, {n}), B ({B}, {n}, {kk})",
            lambda dt: (A.to(dt), PT_m.to(dt)),
            patch_solve.fused_spd_multirhs,
            patch_solve.fused_spd_multirhs_plain,
            lambda o, r: max(rel(o[0], r[0]), rel(o[1], r[1])),
            lambda a: by(*k1_work),
            None),
        "K2 gj_inverse": (
            f"T ({B}, {cD}, {cD})",
            lambda dt: (T.to(dt),),
            patch_solve.gj_inverse, patch_solve.gj_inverse_plain, rel,
            lambda a: by(B * 2 * cD ** 3, B * f4 * 2 * cD * cD),
            lambda a: torch.linalg.inv(a)),
        "K3 stencil_trace": (
            f"band ({B}, {nN}, {n_off}), X ({B}, 1, {nNp}, {kk})",
            lambda dt: (band.to(dt), Xp.to(dt).contiguous()),
            lambda b, x: assembly.stencil_trace(b, x, tab.shiftN,
                                                tab.offs_flat),
            lambda b, x: assembly.stencil_trace_plain(b, x, tab.shiftN,
                                                      tab.offs_flat),
            rel,
            lambda a: by(B * 2 * n_off * nN * kk,
                         B * f4 * (nN * n_off + nNp * kk + nN * kk)),
            k3_lib),
        "K4 mgs_qr": (
            f"X ({B}, {cD}, {k}) = Ginv Z",
            lambda dt: (X_it.to(dt),),
            eig.mgs_qr, eig.mgs_qr_plain,
            lambda o, r: None,                   # held to its contract below
            lambda a: by(B * 4 * cD * k * k, B * f4 * 2 * cD * k),
            lambda x: torch.linalg.qr(x)),
        "K5 jacobi_eigh": (
            f"W ({B}, {k}, {k})",
            lambda dt: (W.to(dt),),
            k5w[0], k5w[1], k5_err,
            lambda a: sweeps_bound(a[0], sw, st, 0, B * f4 * 2 * k * k),
            lambda w: torch.linalg.eigh(w)),
        "K5 jacobi_eigh [jacobi route]": (
            f"factor rows ({B}, {m126}, {m126})",
            lambda dt: (factor_rows(dt),),
            k5j[0], k5j[1], k5_err,
            lambda a: sweeps_bound(a[0], tab.sweeps, tab.eig_tol, 0,
                                   B * f4 * 2 * m126 * m126),
            lambda g: torch.linalg.svd(g)),
        "K8 weig": (
            f"ZT, YT ({B}, {k}, {cD})",
            lambda dt: (ZT.to(dt), YT.to(dt)),
            k8[0], k8[1], k5_err,
            lambda a: by(*k8_work(*a, sw, st)),
            None),
    }
    spmm_check("K3 stencil_trace", k3_lib, band, Xp, tab)
    k5_alone = {"K5 jacobi_eigh": k5w[2],
                "K5 jacobi_eigh [jacobi route]": k5j[2]}
    table = []
    for name, (shape, make, kern, plain, err, bound, lib) in cases.items():
        if name == "K4 mgs_qr":
            # the real iterate's columns span decades: hold Q to its
            # contract there, elementwise on a well-conditioned block
            k4_block_check(name, X_wc, X_it)
        check_case(table, card, name, shape, make, kern, plain, err, bound,
                   lib, path="jacobi" if name.endswith("[jacobi route]")
                   else None,
                   contract=(lambda q, a: qr_contract_err(q, a[0]))
                   if name == "K4 mgs_qr" else None,
                   kernel_fn=k5_alone.get(name))
        if name == "K5 jacobi_eigh":
            k5_sweep_report(name, W.to, sw, st)
        elif name == "K5 jacobi_eigh [jacobi route]":
            k5_sweep_report(name, factor_rows, tab.sweeps, tab.eig_tol)
        elif name == "K8 weig":
            k8_sweep_report(name, make, sw, st)
        if name == "K1 fused_spd_multirhs":
            second_bound(table[-1], card, *k1_work, "bound_ms_3xtf32")
            f32_gate_all_chunks(s, tab, name)
            # the kernel's order of summation on tensors: a wrong panel
            # would show here as well as against the Cholesky solve
            Xb, Tb = patch_solve.fused_ldl_blocked_plain(A, PT_m)
            Xk, Tk = kern(A, PT_m)
            e_b = max(rel(Xk, Xb), rel(Tk, Tb))
            print(f"[kernels] {name} against the blocked left-looking "
                  f"plain version, f64: {e_b:.3e} (<= 1e-10)")
            check(e_b <= 1e-10, f"{name} disagrees with the blocked plain "
                  "version")

    # K4 on the float64 main path: every direction but one (k = 124), the
    # float64 jitter, the columns in shared memory
    k64 = basis.smallk_k_eff(cD, torch.float64, s.cfg.smallk_dirs)
    k64 -= k64 % 2
    Gj64 = G + (1e-13 * torch.where(dmax > 0, dmax, 1.0))[..., None] * eye
    X_it64 = patch_solve.gj_inverse_plain(Gj64) @ eig.smallk_start(
        cD, k64, G.dtype, G.device).expand(B, cD, k64)
    del Gj64
    name = "K4 mgs_qr [f64 main]"
    k4_block_check(name, torch.as_tensor(
        np.random.default_rng(2).standard_normal((B, cD, k64))
        * np.logspace(0, -5, k64), device="cuda"), X_it64, f32=False)
    k4_work = (B * 4 * cD * k64 * k64, B * 8 * 2 * cD * k64)
    check_case(
        table, card, name, f"X ({B}, {cD}, {k64}) = Ginv Z0, f64 path",
        lambda dt: (X_it64.to(dt),), eig.mgs_qr, eig.mgs_qr_plain, None,
        lambda a: by(*k4_work), lambda x: torch.linalg.qr(x),
        path="main-f64", time_dtype="float64", f32=False,
        contract=lambda q, a: qr_contract_err(q, a[0]))
    second_bound(table[-1], card, *k4_work, "bound_ms_f64_cuda_cores")

    # K8 on the float64 main path's factors (k = 124: RegRows' CTA), from
    # the plain f64 chain with the float64 jitter
    Gj64 = G + (1e-13 * torch.where(dmax > 0, dmax, 1.0))[..., None] * eye
    Z64 = eig.mgs_qr_plain(X_it64)
    Ginv64 = patch_solve.gj_inverse_plain(Gj64)
    for _ in range(tab.smallk_power - 1):
        Z64 = eig.mgs_qr_plain(Ginv64 @ Z64)
    ZT64 = Z64.mT.contiguous()
    YT64 = ZT64 @ Gj64
    del Gj64, Ginv64, Z64
    # K5 on the same W, symmetrized (the main-f64 path's spectral stage;
    # RegRows' CTA), beside K8
    W64 = torch.bmm(ZT64, YT64.mT)
    W64 = (0.5 * (W64 + W64.mT)).contiguous()
    name = "K5 jacobi_eigh [f64 main]"
    k5_work64 = (sweep_flops(jacobi_sweep_counts(
        W64, sw, st, eig._default_null_rel(W64.dtype)), k64),
        B * 8 * 2 * k64 * k64)
    check_case(
        table, card, name, f"W ({B}, {k64}, {k64}), f64 path",
        lambda dt: (W64.to(dt),), k5w[0], k5w[1], k5_err,
        lambda a: by(*k5_work64), lambda w: torch.linalg.eigh(w),
        path="main-f64", time_dtype="float64", f32=False, kernel_fn=k5w[2])
    second_bound(table[-1], card, *k5_work64, "bound_ms_f64_cuda_cores")
    k5_sweep_report(name, W64.to, sw, st, dtypes=("float64",))
    del W64
    name = "K8 weig [f64 main]"
    k8_route_check(name, torch.float64, k64, "rows")
    k8_work64 = k8_work(ZT64, YT64, sw, st)
    check_case(
        table, card, name, f"ZT, YT ({B}, {k64}, {cD}), f64 path",
        lambda dt: (ZT64.to(dt), YT64.to(dt)), k8[0], k8[1], k5_err,
        lambda a: by(*k8_work64), None, path="weig-f64",
        time_dtype="float64", f32=False)
    second_bound(table[-1], card, *k8_work64, "bound_ms_f64_cuda_cores")
    k8_sweep_report(name, lambda dt: (ZT64.to(dt), YT64.to(dt)), sw, st,
                    dtypes=("float64",))
    k8_gate_all_chunks(sw, st)
    return table


def k8_route_check(name, dtype, k, expect):
    """K8's route at k (the launcher's ``slod_weig_route``) is ``expect``
    and equals the twin ``eig.k8_route``; a checkout without the query (the
    route before K8 took K5's) is held to nothing.  Returns the route, or
    None there."""
    import torch
    from dealii_slod_tpu_torch.ops import eig
    from dealii_slod_tpu_torch.utils import kernels
    if "slod_weig_route" not in getattr(kernels, "_QUERIES", {}):
        print(f"[kernels] {name}: this checkout's K8 reports no route")
        return None
    dev = torch.device("cuda")
    route = eig.K5_ROUTES[kernels.query("slod_weig_route", dtype, dev, k)]
    twin = eig.k8_route(k)
    ws = kernels.workspace("K8", "slod_weig", dtype, dev, 1, k)
    print(f"[kernels] {name}: route at k = {k} {str(dtype)[6:]}: {route} "
          f"(twin {twin}), workspace {'none' if ws is None else 'global'}")
    check(route == expect == twin and (ws is None) == (route != "global rows"),
          f"{name}: K8 took the {route} route at k = {k} (twin {twin}), "
          f"not {expect}")
    return route


def split_leaf_operands(A, B, nb):
    """The Schur split of (A, B) with the plain leaf solve, recording each
    leaf's operands: ((X, T), [(A_leaf, B_leaf), ...])."""
    from dealii_slod_tpu_torch.ops import patch_solve
    ops = []

    def record(a, b):
        ops.append((a, b))
        return patch_solve.spd_multirhs_solve_plain(a, b)

    return patch_solve.fused_spd_multirhs_split(A, B, nb=nb, leaf=record), ops


def phase_el_kernels(card):
    """On the middle 128-patch chunk of the 3D elasticity configuration:
    K6 at each split leaf, K7, K2 on a real pivot of T and of G + delta I,
    K4 and K5 at the float32 path's shapes (the B C = 384 Grams, k = 32:
    shared-memory rows), and K4 / K5 at the float64 path's (n = 375,
    k = 374: K4's global columns, K5's cluster rows, float64 only); K1 on
    the whole block timed beside the split."""
    import numpy as np
    import torch
    from dealii_slod_tpu_torch.models import basis
    from dealii_slod_tpu_torch.ops import assembly, eig, patch_solve

    s, tab, cw, lo, hi, sd = chunk_inputs(elastic=True)
    check(s.solver_mode == "fused_split", f"3D elasticity resolved to "
          f"patch_solver {s.solver_mode!r}, not 'fused_split'")
    band, A, PT_m, cvd = basis.prep(tab, cw, lo, hi)
    B, C, nN = band.shape[0], tab.C, tab.n_nodes
    (X64, Traw), leaves = split_leaf_operands(A, PT_m, tab.panel_nb)
    shapes = [(a.shape[-1], b.shape[-1]) for a, b in leaves]
    print(f"[kernels] elasticity chunk: A ({B}, {A.shape[-1]}, "
          f"{A.shape[-1]}), PT ({B}, {PT_m.shape[1]}, {PT_m.shape[2]}); "
          f"split leaves (n, k) {shapes}")
    T = Traw / tab.Hdim + torch.diag_embed(1.0 - cvd)
    Tinv = torch.linalg.inv(T)
    S99, is99d = basis.trace_S_chunk(tab, band, X64, lo, hi, sd)
    G, _ = basis.finish_pre_from_S(tab, S99, Tinv, cvd, is99d)
    del S99
    cD = tab.cD
    G = G.reshape(B * C, cD, cD)
    Xp = trace_operand(tab, X64)
    kk = Xp.shape[-1]
    n_off = len(tab.offs_flat)
    nNp = Xp.shape[2]
    f4, f8 = 4, 8
    table = []

    def k6_work(n, k):
        return (B * (n ** 3 / 3 + 2 * n * n * k),
                B * f4 * (n * n + 2 * n * k))

    for i, (a, b) in enumerate(leaves):
        n, k = a.shape[-1], b.shape[-1]
        check_case(
            table, card, f"K6 spd_multirhs_solve [leaf {i + 1}]",
            f"A ({B}, {n}, {n}), B ({B}, {n}, {k})",
            lambda dt, a=a, b=b: (a.to(dt), b.to(dt)),
            patch_solve.spd_multirhs_solve,
            patch_solve.spd_multirhs_solve_plain, rel,
            lambda a_, n=n, k=k: by(*k6_work(n, k)),
            lambda a, b: torch.linalg.solve(a, b))
        second_bound(table[-1], card, *k6_work(n, k),
                     "bound_ms_3xtf32")
    del leaves
    f32_gate_all_chunks(s, tab, "K6 spd_multirhs_solve")
    k7_lib = trace_spmm(band.float(), nNp, tab.shiftN, tab.offs_flat)
    check_case(
        table, card, "K7 stencil_trace",
        f"band ({B}, {nN}, {band.shape[2]}), X ({B}, {C}, {nNp}, {kk})",
        lambda dt: (band.to(dt).contiguous(), Xp.to(dt)),
        lambda b, x: assembly.stencil_trace(b, x, tab.shiftN, tab.offs_flat),
        lambda b, x: assembly.stencil_trace_plain(b, x, tab.shiftN,
                                                  tab.offs_flat),
        rel,
        lambda a: by(B * nN * kk * 2 * n_off * C * C,
                     B * f4 * (nN * n_off * C * C + C * nNp * kk
                               + C * nN * kk)),
        k7_lib)
    spmm_check("K7 stencil_trace", k7_lib, band, Xp, tab)
    del Xp, k7_lib
    piv = T[:, :patch_solve.GJ_PAD, :patch_solve.GJ_PAD].contiguous()
    m = piv.shape[-1]
    check_case(
        table, card, "K2 gj_inverse [elasticity pivot]",
        f"first pivot of T ({B}, {m}, {m}) (T {tuple(T.shape)})",
        lambda dt: (piv.to(dt),), patch_solve.gj_inverse,
        patch_solve.gj_inverse_plain, rel,
        lambda a: by(B * 2 * m ** 3, B * f4 * 2 * m * m),
        lambda a: torch.linalg.inv(a), path="elasticity")

    # K1 on the whole (2187 -> 2240) block, for the record beside the split
    A32, P32 = A.float(), PT_m.float()
    ms_whole = cuda_ms(lambda: patch_solve.fused_spd_multirhs(A32, P32), 1)
    ms_split = cuda_ms(lambda: patch_solve.fused_spd_multirhs_split(
        A32, P32, nb=tab.panel_nb), 1)
    e_whole = rel(patch_solve.fused_spd_multirhs(A32, P32)[0], X64)
    e_split = rel(patch_solve.fused_spd_multirhs_split(
        A32, P32, nb=tab.panel_nb)[0], X64)
    print(f"[kernels] patch solve of the elasticity chunk, f32: K1 on the "
          f"whole block {ms_whole:.3f} ms (X err {e_whole:.3e}); Schur "
          f"split on K6 leaves {ms_split:.3f} ms (X err {e_split:.3e}) "
          f"[{card}]")
    del A32, P32, A, X64

    # the smallk stage's operands on all B C Grams of the chunk, from the
    # plain f64 chain, for the float32 path (k = 32, jitter 1e-6) and the
    # float64 one (k = all directions but one, jitter 1e-13): G + delta I,
    # the first iterate Ginv Z0, and W after the subspace steps
    BC = G.shape[0]
    dmax = torch.diagonal(G, dim1=-2, dim2=-1).abs().amax(-1)
    eye = torch.eye(cD, dtype=G.dtype, device=G.device)

    def smallk_operands(dt, jitter):
        k = basis.smallk_k_eff(cD, dt, s.cfg.smallk_dirs)
        k -= k % 2
        Gj = G + (jitter * torch.where(dmax > 0, dmax, 1.0))[:, None,
                                                               None] * eye
        Ginv = torch.linalg.inv(Gj)
        Z = eig.smallk_start(cD, k, G.dtype, G.device).expand(BC, cD, k)
        X_it = Ginv @ Z
        for _ in range(tab.smallk_power):
            Z = eig.mgs_qr_plain(Ginv @ Z)
        W = Z.mT @ Gj @ Z
        return k, Gj, X_it, 0.5 * (W + W.mT), Z

    sw, st = 8, tab.smallk_tol                  # the W stage's sweeps, tol
    k5, k5_plain, k5_rows = k5_fns(sw, st)
    k8, k8_plain = k8_fns(sw, st)

    from dealii_slod_tpu_torch.utils import kernels

    def rows(name, dt, entry, *sizes):
        # which rows the launcher's size rule gives (None: shared memory)
        ws = kernels.workspace(name, entry, dt, dmax.device, 1, *sizes)
        return "shared" if ws is None else "global"

    def k5_cluster(dt, n):
        # K5's thread-block cluster size at row length n (0: another
        # route; None: a checkout from before the cluster route)
        if not hasattr(kernels, "query"):
            return None
        return kernels.query("slod_jacobi_rows_cluster", dt, dmax.device, n)

    k32, Gj, X_it, W, Z = smallk_operands(torch.float32, 1e-6)
    check(k32 == 32, f"elasticity f32 smallk directions {k32}, expected 32")
    check(rows("K4", torch.float32, "slod_mgs_qr", cD, k32) == "shared"
          and rows("K5", torch.float32, "slod_jacobi_rows", k32) == "shared",
          "the float32 elasticity smallk shapes left shared memory")
    gpiv = Gj[:, :m, :m].contiguous()
    ZT = Z.mT.contiguous()
    YT = ZT @ Gj
    del Gj, Z
    check_case(
        table, card, "K2 gj_inverse [elasticity G pivot]",
        f"first pivot of G + delta I ({BC}, {m}, {m})",
        lambda dt: (gpiv.to(dt),), patch_solve.gj_inverse,
        patch_solve.gj_inverse_plain, rel,
        lambda a: by(BC * 2 * m ** 3, BC * f4 * 2 * m * m),
        lambda a: torch.linalg.inv(a), path="elasticity")
    k4_block_check("K4 mgs_qr [elasticity]", torch.as_tensor(
        np.random.default_rng(3).standard_normal((BC, cD, k32))
        * np.logspace(0, -5, k32), device="cuda"), X_it)
    check_case(
        table, card, "K4 mgs_qr [elasticity]",
        f"X ({BC}, {cD}, {k32}) = Ginv Z0",
        lambda dt: (X_it.to(dt),), eig.mgs_qr, eig.mgs_qr_plain, None,
        lambda a: by(BC * 4 * cD * k32 * k32, BC * f4 * 2 * cD * k32),
        lambda x: torch.linalg.qr(x), path="elasticity",
        contract=lambda q, a: qr_contract_err(q, a[0]))
    check_case(
        table, card, "K5 jacobi_eigh [elasticity]",
        f"W ({BC}, {k32}, {k32})",
        lambda dt: (W.to(dt).contiguous(),), k5, k5_plain, k5_err,
        lambda a: sweeps_bound(a[0], sw, st, 0, BC * f4 * 2 * k32 * k32),
        lambda w: torch.linalg.eigh(w), path="elasticity", kernel_fn=k5_rows)
    k5_sweep_report("K5 jacobi_eigh [elasticity]", W.to, sw, st)
    del gpiv, X_it, W
    name = "K8 weig [elasticity]"
    k8_route_check(name, torch.float32, k32, "warp")
    check_case(
        table, card, name, f"ZT, YT ({BC}, {k32}, {cD})",
        lambda dt: (ZT.to(dt), YT.to(dt)), k8, k8_plain, k5_err,
        lambda a: by(*k8_work(*a, sw, st)), None,
        path="elasticity-r3-weig-f32")
    k8_sweep_report(name, lambda dt: (ZT.to(dt), YT.to(dt)), sw, st)
    del ZT, YT

    k64, Gj, X_it, W_all, Z = smallk_operands(torch.float64, 1e-13)
    ZT = Z.mT.contiguous()
    YT = ZT @ Gj
    del Gj, G, Z
    S = k5_cluster(torch.float64, k64)
    k5_rows_at = rows("K5", torch.float64, "slod_jacobi_rows", k64)
    check(rows("K4", torch.float64, "slod_mgs_qr", cD, k64) == "global",
          f"K4 at the float64 elasticity shape (n {cD}, k {k64}) took the "
          "shared-memory columns")
    check(k5_rows_at == "global" if S is None
          else (S > 0 and k5_rows_at == "shared"),
          f"K5 at the float64 elasticity W ({k64} x {k64}) took the "
          f"{k5_rows_at} rows (cluster size {S}), not a cluster's")
    k5_route = "global rows" if S is None else "cluster rows"
    print(f"[kernels] K5 at {k64} x {k64} float64: {k5_route}"
          + ("" if S is None else f", a cluster of {S} CTAs, no workspace"))
    k4_block_check("K4 mgs_qr [global rows]", torch.as_tensor(
        np.random.default_rng(1).standard_normal((BC, cD, k64))
        * np.logspace(0, -3, k64), device="cuda"), X_it, f32=False)
    k4_work = (BC * 4 * cD * k64 * k64, BC * f8 * 2 * cD * k64)
    check_case(
        table, card, "K4 mgs_qr [global rows]",
        f"X ({BC}, {cD}, {k64}) = Ginv Z0, f64 path",
        lambda dt: (X_it.to(dt),), eig.mgs_qr, eig.mgs_qr_plain, None,
        lambda a: by(*k4_work), lambda x: torch.linalg.qr(x),
        path="elasticity-r3-f64", time_dtype="float64", f32=False,
        contract=lambda q, a: qr_contract_err(q, a[0]))
    second_bound(table[-1], card, *k4_work, "bound_ms_f64_cuda_cores")
    del X_it
    # the plain K5 at 374 takes seconds per matrix: a few of them are
    # compared and timed, the kernel also on all of them
    sel = torch.linspace(0, BC - 1, 4, device=W_all.device).long()
    W = W_all[sel]
    nsel = len(sel)
    k5_work = (sweep_flops(jacobi_sweep_counts(
        W, sw, st, eig._default_null_rel(W.dtype)), k64),
        nsel * f8 * 2 * k64 * k64)        # the sweeps these W need
    name = f"K5 jacobi_eigh [{k5_route}]"
    check_case(
        table, card, name,
        f"W ({nsel} of {BC}, {k64}, {k64}), f64 path",
        lambda dt: (W.to(dt).contiguous(),), k5, k5_plain, k5_err,
        lambda a: by(*k5_work),
        lambda w: torch.linalg.eigh(w), path="elasticity-r3-f64",
        time_dtype="float64", f32=False, kernel_fn=k5_rows)
    second_bound(table[-1], card, *k5_work, "bound_ms_f64_cuda_cores")
    row = table[-1]
    row["cluster_size"] = S
    k5_sweep_report(name, W.to, sw, st, dtypes=("float64",))
    # all 384 W: the kernel's eigenvalues against the plain version's
    # (<= 1e-10 of lambda_max) and against linalg.eigh's, where the kernel
    # may be no further (+ 1e-10) than the plain version itself: the W
    # stage's 8 sweeps at tol 3e-6 stop short of eigh's accuracy on some W
    lam_all = k5(W_all)[0]
    lam_pl = k5_plain(W_all)[0]
    ref_all = torch.linalg.eigvalsh(W_all).flip(-1)
    lmax = ref_all[:, :1]
    e_k = ((lam_all - ref_all).abs() / lmax).amax(-1)
    e_p = ((lam_pl - ref_all).abs() / lmax).amax(-1)
    e_kp = float(((lam_all - lam_pl).abs() / lmax).max())
    cnt = eig._jacobi_rows_cuda(W_all, sw, st, eig._default_null_rel(
        W_all.dtype), counts=True)[2].cpu()
    far = (e_k > 1e-10).nonzero().flatten().cpu()
    print(f"[kernels] {name}: eigenvalues of all {BC} W: against the plain "
          f"version {e_kp:.3e} of lambda_max (<= 1e-10); against "
          f"linalg.eigh's {float(e_k.max()):.3e} (the plain version "
          f"{float(e_p.max()):.3e}); {len(far)} W beyond 1e-10 of eigh's"
          + (f", sweeps {cnt[far].tolist()[:12]}" if len(far) else ""))
    check(e_kp <= 1e-10 and bool((e_k <= e_p + 1e-10).all()),
          f"{name}: eigenvalues of the 384 W off the plain version's by "
          f"{e_kp:.3e}, or further from linalg.eigh's than it")
    del lam_all, lam_pl, ref_all
    ms_all = cuda_ms(lambda: k5(W_all), 1)
    lib_all = cuda_ms(lambda: torch.linalg.eigh(W_all), 1)
    row["ms_full_batch"] = ms_all
    row["library_ms_full_batch"] = lib_all
    row["device_ms_full_batch"] = device_ms(lambda: k5(W_all), 1)
    print(f"[kernels] {name} on all {BC} W of the chunk, f64: {ms_all:.3f} "
          f"ms (device {row['device_ms_full_batch']:.3f} ms), library "
          f"(linalg.eigh) {lib_all:.3f} ms [{card}]")
    # the rows' traffic through shared memory with the sweeps the kernel
    # ran: a round passes half the rows to another warp (written once,
    # read once); at 128 B per clock on each SM at the card's top SM clock
    clk = sm_clock_hz()
    for key, c, ms_ in (("bound_ms_smem", cnt[sel.cpu()], row["ms"]),
                        ("bound_ms_smem_full_batch", cnt, ms_all)):
        nbytes = float(c.sum()) * (k64 - 1) * k64 * k64 * f8
        row[key] = nbytes / (SMS * SMEM_BYTES_PER_CLK * clk) * 1e3
        print(f"[kernels] {name}: shared-memory bound ({len(c)} W, "
              f"{nbytes / 1e9:.3f} GB at {SMS} x {SMEM_BYTES_PER_CLK} B/clk "
              f"x {clk / 1e6:.0f} MHz) {row[key]:.4f} ms "
              f"({100 * row[key] / ms_:.2f}% of {ms_:.3f} ms) [{card}]")
    del W_all, W

    # K8 on the float64 path's factors at k = 374: each CTA of a cluster
    # builds the rows its warps hold (no workspace); 4 W compared and
    # timed, the eigenvalues of all 384 against the plain version's
    name = "K8 weig [cluster rows]"
    route = k8_route_check(name, torch.float64, k64, "cluster")
    ws = kernels.workspace("K8", "slod_weig", torch.float64, dmax.device, 1,
                           k64)
    check(route is not None or ws is not None, f"{name}: a checkout without "
          "K8's route query took no global rows")
    S8 = k5_cluster(torch.float64, k64) if route == "cluster" else None
    zs, ys = ZT[sel].contiguous(), YT[sel].contiguous()
    k8_work4 = k8_work(zs, ys, sw, st)
    check_case(
        table, card, name,
        f"ZT, YT ({nsel} of {BC}, {k64}, {cD}), f64 path",
        lambda dt: (zs.to(dt), ys.to(dt)), k8, k8_plain, k5_err,
        lambda a: by(*k8_work4), None, path="elasticity-r3-weig-f64",
        time_dtype="float64", f32=False)
    second_bound(table[-1], card, *k8_work4, "bound_ms_f64_cuda_cores")
    row = table[-1]
    row["cluster_size"] = S8
    k8_sweep_report(name, lambda dt: (zs.to(dt), ys.to(dt)), sw, st,
                    dtypes=("float64",))
    lam_all = k8(ZT, YT)[0]
    lam_pl = k8_plain(ZT, YT)[0]
    e_kp = float(((lam_all - lam_pl).abs() / lam_pl[:, :1]).max())
    print(f"[kernels] {name}: eigenvalues of all {BC} W against the plain "
          f"version {e_kp:.3e} of lambda_max (<= 1e-10)")
    check(e_kp <= 1e-10, f"{name}: eigenvalues of the {BC} W off the plain "
          f"version's by {e_kp:.3e}")
    del lam_all, lam_pl
    row["ms_full_batch"] = cuda_ms(lambda: k8(ZT, YT), 1)
    row["device_ms_full_batch"] = device_ms(lambda: k8(ZT, YT), 1)
    print(f"[kernels] {name} on all {BC} W of the chunk, f64: "
          f"{row['ms_full_batch']:.3f} ms (device "
          f"{row['device_ms_full_batch']:.3f} ms) [{card}]")
    return table


def phase_e2e_f64():
    from dealii_slod_tpu_torch import ReductionControl
    runs = {"jacobi": (bench_cfg, False, dict(eig_solver="jacobi",
                                              patch_solver="fused")),
            "smallk": (bench_cfg, False, dict(eig_solver="smallk",
                                              patch_solver="fused")),
            "elasticity": (elastic_cfg, True, dict(
                eig_solver="smallk", patch_solver="fused_split"))}
    for label, (make_cfg, elastic, kw) in runs.items():
        cfg = make_cfg("float64", n_global_refinements=2, oversampling=1,
                       coef_refinement=3, patch_chunk=32,
                       coarse_solver=ReductionControl(200, 1e-12, 1e-12),
                       **kw)
        out = {}
        for dev in ("cpu", "cuda"):
            # eig_block=1: the plain Jacobi stops each matrix on its own,
            # as the kernels do
            s = make_solver(cfg, elastic, device=dev, eig_block=1)
            s.assemble_fine_rhs()
            u, _ = s.build_step()(s.coef_q, s.fem_rhs)
            out[dev] = (u.cpu(), s.prolong_lod_solution().cpu())
        e_u = rel(out["cuda"][0], out["cpu"][0])
        e_f = rel(out["cuda"][1], out["cpu"][1])
        print(f"[e2e-f64] {label}: 3D refine-2 l=1 (64 patches, C = "
              f"{s.C}, {s.solver_mode}): u rel diff {e_u:.3e}, prolonged "
              f"rel diff {e_f:.3e} (<= 1e-8)")
        check(e_u <= 1e-8 and e_f <= 1e-8,
              f"CPU and CUDA steps disagree ({label})")


def profile_step(path, step, s):
    """One more step under torch.profiler: the device-busy share of its
    wall and the device activities (kernels, copies, fills) by time.  Only
    device-side events are summed: an aten op's own device time is the
    time of the kernels it launched, which are events of their own."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(s.coef_q, s.fem_rhs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    busy = sum(dev_us(e) for e in dev) / 1e6
    dev.sort(key=dev_us, reverse=True)
    for e in dev[:25]:
        print(f"[profile {path}]   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    print(f"[profile {path}] wall {wall:.3f} s under the profiler; device "
          f"busy {busy:.3f} s ({100 * busy / wall:.1f}%), idle "
          f"{wall - busy:.3f} s")


def run_path(path, cfg, timed, profile=False, elastic=False):
    """Drive one path through ``LODSolver(cfg, problem).build_step()`` on
    the card: the launch counts are set to 0 just before the first call
    and read just after the last, and must equal what the code path
    implies (``drive``); returns (solver, per-path numbers)."""
    import torch

    s = make_solver(cfg, elastic)
    P = s.topo.n_patches
    s.assemble_fine_rhs()
    step = s.build_step()
    torch.cuda.reset_peak_memory_stats()
    u, nums = drive(path, s, lambda: step(s.coef_q, s.fem_rhs)[0],
                    calls=1 + timed)
    peak = torch.cuda.max_memory_allocated()
    first, walls = nums["walls"][0], nums["walls"][1:]
    wall = min(walls) if walls else first
    res = s.coarse_cg
    print(f"[{path}] {P} patches C={s.C} {cfg.dtype} (patch solver "
          f"{s.solver_mode}, spectral stage {s.spec_mode}): "
          f"{P / wall:.1f} patches/s; first call {first:.3f} s; steady wall "
          f"{wall:.3f} s (calls {walls}); peak {peak / 2**30:.2f} GiB; CG "
          f"{int(res.n_iter)} it converged {bool(res.converged)}")
    if s.solver_mode == "fused_split":
        from dealii_slod_tpu_torch.ops.patch_solve import split_leaves
        tab = s._tables
        rule = split_leaves(tab.nI, tab.cD, tab.panel_nb)
        print(f"[{path}] split leaves (n, k) per chunk, by the rule (the K6 "
              f"count above holds the run to their number): {rule}")
    check(bool(torch.isfinite(u).all()) and float(u.abs().max()) > 0,
          f"{path}: u is not finite and non-zero")
    check(bool(res.converged), f"{path}: coarse CG did not converge")
    if profile:
        profile_step(path, step, s)
    return s, dict(counts=nums["counts"], per_step=nums["per_step"],
                   patches_per_s=P / wall, first_call_s=first,
                   steady_wall_s=wall, peak_bytes=peak)


def phase_jacobi(profile=False):
    return run_path("jacobi", bench_cfg("float32", eig_solver="jacobi",
                                        patch_solver="fused",
                                        trace_kernel="on"),
                    timed=1, profile=profile)[1]


def phase_main(profile=False):
    """The main path in float32, then the same step in float64 (the
    ``main-f64`` path: K4 at k = 124, its columns in shared memory)."""
    s, out = run_path("main", bench_cfg("float32"), timed=2,
                      profile=profile)
    check(s.spec_mode == "smallk",
          f"eig_solver='auto' resolved to {s.spec_mode!r}, not 'smallk'")
    check(s.solver_mode == "fused",
          f"patch_solver='auto' resolved to {s.solver_mode!r}, not 'fused'")
    f32 = s.prolong_lod_solution().double().cpu()
    del s
    s64, out64 = run_path("main-f64", bench_cfg("float64",
                                                eig_solver="smallk"), timed=1)
    f64 = s64.prolong_lod_solution().cpu()
    e = rel(f32, f64)
    print(f"[main] f64 smallk step {out64['steady_wall_s']:.3f} s (first "
          f"call {out64['first_call_s']:.3f} s), CG "
          f"{int(s64.coarse_cg.n_iter)} it; prolonged f32 vs f64 rel max "
          f"diff {e:.3e} (<= 1e-2)")
    check(e <= 1e-2, "f32 and f64 prolonged fields disagree")
    return out, out64, f64


def weig_field_check(path, field, fields):
    """A weig path's prolonged field against the same dtype's path with K5
    (``WEIG_FIELD_BOUND``): the relative max difference, held to its
    bound."""
    other, bound = WEIG_FIELD_BOUND[path]
    e = rel(field, fields[other])
    print(f"[{path}] prolonged field vs {other}'s rel max diff {e:.3e} "
          f"(<= {bound:.3e})")
    check(e <= bound, f"{path}: prolonged field disagrees with {other}'s")


def phase_weig(f64, profile=False):
    """The main configuration with ``smallk_weig=True`` (K8) in float32,
    then in float64 (``weig-f64``: K8 at k = 124)."""
    s, out = run_path("weig", bench_cfg("float32", smallk_weig=True),
                      timed=1, profile=profile)
    e = rel(s.prolong_lod_solution().double().cpu(), f64)
    print(f"[weig] prolonged f32 (K8) vs main's f64 rel max diff {e:.3e} "
          f"(<= 1e-2)")
    check(e <= 1e-2, "weig path: prolonged field disagrees with f64")
    del s
    s64, out64 = run_path("weig-f64", bench_cfg(
        "float64", eig_solver="smallk", smallk_weig=True), timed=1)
    weig_field_check("weig-f64", s64.prolong_lod_solution().cpu(),
                     {"main-f64": f64})
    print(f"[weig] f64 weig step {out64['steady_wall_s']:.3f} s (first call "
          f"{out64['first_call_s']:.3f} s)")
    return out, out64


def phase_elasticity(profile=False):
    """The 4096-patch elasticity step in float32, then refine-3 l=2 in
    float32 and float64 (K4 on global columns, K5 on cluster rows);
    returns the per-path numbers by path."""
    s, out = run_path("elasticity", elastic_cfg("float32"), timed=2,
                      profile=profile, elastic=True)
    check(s.solver_mode == "fused_split" and s.spec_mode == "smallk",
          f"elasticity resolved to patch solver {s.solver_mode!r} and "
          f"spectral stage {s.spec_mode!r}, not 'fused_split' / 'smallk'")
    paths, fields = {"elasticity": out}, {}
    del s
    for weig in ("", "weig-"):
        for dtype in ("float32", "float64"):
            path = f"elasticity-r3-{weig}f{dtype[5:]}"
            kw = dict(eig_solver="smallk") if dtype == "float64" else {}
            si, paths[path] = run_path(path, elastic_cfg(
                dtype, n_global_refinements=3, smallk_weig=bool(weig), **kw),
                timed=1, elastic=True)
            fields[path] = si.prolong_lod_solution().double().cpu()
            del si
            if weig:
                weig_field_check(path, fields[path], fields)
    for weig in ("", "weig-"):
        f32, f64 = (f"elasticity-r3-{weig}f{b}" for b in (32, 64))
        e = rel(fields[f32], fields[f64])
        print(f"[elasticity] refine-3 l=2 (512 patches){' weig' * bool(weig)}"
              f": f64 step {paths[f64]['steady_wall_s']:.3f} s; prolonged "
              f"f32 vs f64 rel max diff {e:.3e} (<= 1e-2)")
        check(e <= 1e-2, f"elasticity{' weig' * bool(weig)}: f32 and f64 "
              "prolonged fields disagree")
    return paths


def run_solver(path, cfg, elastic=False):
    """Drive one path through ``LODSolver(cfg, problem).run()`` on the
    card: the launch counts are set to 0 just before the run and read just
    after, and must equal what the code path implies for one step; prints
    the stage walls, the peak memory, the tables and the launches; returns
    (solver, results, per-path numbers)."""
    import torch
    from dealii_slod_tpu_torch.utils import kernels

    s = make_solver(cfg, elastic)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = s.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    expected = expected_launches(s)
    stages = {k: round(v, 4) for k, v in sorted(s.timer.totals.items())}
    print(f"[{path}] {s.topo.n_patches} patches C={s.C} {cfg.dtype} "
          f"(LOD{' + SLOD' * s._tables.slod}, patch solver {s.solver_mode}"
          f", spectral stage {s.spec_mode if s._tables.slod else 'none'}): "
          f"run() {wall:.3f} s; stage walls (s) {stages}; peak "
          f"{peak / 2**30:.2f} GiB; basis built for {s.basis_patches} of "
          f"{s.topo.n_patches} patches (the unique window signatures of a "
          f"constant field, or all); launches {counts}, expected {expected}")
    tables = {k: t.rows[0][2] for k, t in out.items() if hasattr(t, "rows")}
    for k, t in tables.items():
        print(f"[{path}]   {k}: {t}")
    if cfg.solve_fine_problem:
        res = s.fine_cg
        print(f"[{path}]   fine CG {int(res.n_iter)} it, converged "
              f"{bool(res.converged)} (residual {float(res.residual):.3e} "
              f"of {float(res.initial_residual):.3e})")
        check(bool(res.converged), f"{path}: the fine CG did not converge")
    check(all(counts.get(k, 0) > 0 for k in PATH_KERNELS[path]),
          f"a kernel of the {path} path was not launched: {counts}")
    check(counts == expected,
          f"{path}: launches differ from the expected counts")
    check(bool(torch.isfinite(out["lod_solution"]).all())
          and float(out["lod_solution"].abs().max()) > 0,
          f"{path}: the LOD solution is not finite and non-zero")
    check(tables and all(math.isfinite(v) for t in tables.values()
                         for v in t.values()),
          f"{path}: the error tables are missing or not finite")
    return s, out, dict(counts=counts, per_step=counts, run_wall_s=wall,
                        stage_walls_s=stages, peak_bytes=peak)


def eigh_step_field(cfg, device="cuda", stage=None, pert=0.0):
    """One step of the diffusion configuration ``cfg`` (its spectral stage
    the eigh stage) on ``device``, with ``torch.linalg.eigh`` replaced by
    ``stage`` when given and the coefficients moved by ``pert`` relative
    (seeded normal noise) -> the prolonged LOD field."""
    import torch
    eigh = torch.linalg.eigh
    if stage is not None:
        torch.linalg.eigh = stage
    try:
        s = make_solver(cfg, False, device=device)
        check(s.spec_mode in ("lapack", "lax"),
              f"not the eigh stage: {s.spec_mode!r}")
        s.assemble_fine_rhs()
        return step_field(s, pert)
    finally:
        torch.linalg.eigh = eigh


def eigh_faults():
    """Faulty eigh stages, to show what the eigh checks can see: the
    decomposition in float32, and the eigenpairs left ascending (the
    basis reverses eigh's ascending order)."""
    import torch
    eigh = torch.linalg.eigh

    def in_float32(G):
        return tuple(t.to(G.dtype) for t in eigh(G.float()))

    def ascending(G):
        return tuple(t.flip(-1) for t in eigh(G))

    return {"eigh in float32": in_float32, "eigenpairs ascending": ascending}


def phase_run():
    """``LODSolver.run()`` on the card: the reference's example, the main
    grid in plain LOD and with the eigh stage (float64), the elasticity
    configuration, and the CLI; returns the per-path numbers by path."""
    import tempfile

    import torch
    from dealii_slod_tpu_torch import DiffusionProblem, LODSolver, SLODConfig
    from dealii_slod_tpu_torch import cli
    from dealii_slod_tpu_torch.utils import errors, kernels

    paths = {}
    # 1. the reference's example against the same run on the CPU
    cfg = SLODConfig()
    ref = LODSolver(cfg, DiffusionProblem(cfg), device="cpu",
                    verbose=False).run()
    s, out, paths["run-2d-default"] = run_solver("run-2d-default", cfg)
    sizes = s.topo.patch_sizes()
    norm = float(torch.linalg.norm(s.fem_rhs))
    worst = max(abs(out[k].rows[0][2][n] - v) / abs(v)
                for k, t in ref.items() if hasattr(t, "rows")
                for n, v in t.rows[0][2].items())
    print(f"[run-2d-default] fem rhs l2 norm {norm!r}, "
          f"{s.fem_solution.numel()} fine / {s.coarse_solution.numel()} "
          f"coarse dofs, "
          f"{s.topo.n_patches} patches of sizes {sizes.min()}..{sizes.max()};"
          f" tables vs the CPU run: worst rel diff {worst:.3e} (<= 1e-10)")
    check(abs(norm - 0.109375) <= 1e-12 and s.fem_solution.numel() == 81
          and s.coarse_solution.numel() == 16 and s.topo.n_patches == 16
          and (sizes.min(), sizes.max()) == (4, 9),
          "run-2d-default: the golden numbers differ")
    check(list(out) == list(ref) and worst <= 1e-10,
          "run-2d-default: the card's tables differ from the CPU's")
    del s, out, ref

    # 2. the main grid in plain LOD, float64, dense two-level fine solve
    fine = dict(solve_fine_problem=True, fine_preconditioner="two_level")
    s, _, paths["run-plain-f64"] = run_solver(
        "run-plain-f64", bench_cfg("float64", lod_stabilization=False,
                                   **fine))
    check(s.topo.n_patches * s.C <= s.cfg.two_level_dense_cap,
          "run-plain-f64: not the dense two-level route")
    del s

    # 3. the same with SLOD on the eigh stage, timed, against smallk
    eigh, spent = torch.linalg.eigh, []

    def timed_eigh(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = eigh(*a, **kw)
        torch.cuda.synchronize()
        spent.append((time.perf_counter() - t0, tuple(a[0].shape)))
        return r

    torch.linalg.eigh = timed_eigh
    try:
        se, oute, paths["run-slod-eigh-f64"] = run_solver(
            "run-slod-eigh-f64", bench_cfg("float64", **fine))
    finally:
        torch.linalg.eigh = eigh
    check(se.spec_mode == "lapack",
          f"eig_solver='auto' resolved to {se.spec_mode!r} in float64")
    print(f"[run-slod-eigh-f64] torch.linalg.eigh: {len(spent)} calls on "
          f"{sorted(set(sh for _, sh in spent))}, "
          f"{sum(t for t, _ in spent):.3f} s in all")
    check(spent, "run-slod-eigh-f64: torch.linalg.eigh was not called")
    kernels.reset_launch_counts()
    ss = make_solver(bench_cfg("float64", eig_solver="smallk"), False)
    ss.assemble_fine_rhs()
    ss.build_step()(ss.coef_q, ss.fem_rhs)
    field = ss.prolong_lod_solution()
    l2s = errors.error_norms(ss.grid, ss.et, ss.conn, field,
                             other=se.fem_solution)["L2"]
    l2e = oute["error_LOD_FEMh"].rows[0][2]["L2"]
    e_l2 = abs(l2e - l2s) / l2s
    e_f = rel(se.lod_solution, field)
    print(f"[run-slod-eigh-f64] LOD-vs-FEMh L2: eigh {l2e!r}, smallk "
          f"{l2s!r}, rel diff {e_l2:.3e} (<= {EIGH_BOUND['L2']:.1e}); "
          f"prolonged fields rel max diff {e_f:.3e} (<= "
          f"{EIGH_BOUND['field']:.1e})")
    check(e_l2 <= EIGH_BOUND["L2"] and e_f <= EIGH_BOUND["field"],
          "run-slod-eigh-f64: the eigh and smallk runs disagree")
    # what that bound can see: faulty eigh stages, the same two numbers
    for name, stage in eigh_faults().items():
        bad = eigh_step_field(bench_cfg("float64", eig_solver="lapack"),
                              stage=stage)
        l2b = errors.error_norms(ss.grid, ss.et, ss.conn, bad,
                                 other=se.fem_solution)["L2"]
        b_l2, b_f = abs(l2b - l2s) / l2s, rel(bad, field)
        seen = not (b_l2 <= EIGH_BOUND["L2"] and b_f <= EIGH_BOUND["field"])
        print(f"[run-slod-eigh-f64] faulty stage ({name}) against smallk: "
              f"L2 rel diff {b_l2:.3e}, field {b_f:.3e}; seen by the bound "
              f"{seen}")
        check(seen, "run-slod-eigh-f64: the eigh-vs-smallk check does not "
              f"see a faulty stage ({name})")
        del bad
    del se, oute, ss, field
    # the same route on the CPU, refine-3 (512 patches)
    cfg3 = bench_cfg("float64", n_global_refinements=3, eig_solver="lapack")
    t0 = time.perf_counter()
    f_cpu = eigh_step_field(cfg3, device="cpu")
    t_cpu = time.perf_counter() - t0
    f_gpu = eigh_step_field(cfg3)
    sens = rel(eigh_step_field(cfg3, pert=1e-15), f_gpu)
    bound = max(EIGH_CPU_BOUND, 10 * sens)
    e_c = rel(f_gpu.cpu(), f_cpu)
    print(f"[run-slod-eigh-f64] refine-3 (512 patches) eigh step, card vs "
          f"CPU ({t_cpu:.1f} s there): prolonged fields rel max diff "
          f"{e_c:.3e} (<= {bound:.3e}: the card's own change under a "
          f"1e-15 coefficient change {sens:.3e}, x10, >= "
          f"{EIGH_CPU_BOUND:.0e})")
    for name, stage in eigh_faults().items():
        b_c = rel(eigh_step_field(cfg3, stage=stage).cpu(), f_cpu)
        print(f"[run-slod-eigh-f64] refine-3 faulty stage ({name}) vs the "
              f"CPU: {b_c:.3e}")
        check(not b_c <= bound, "run-slod-eigh-f64: the card-vs-CPU eigh "
              f"check does not see a faulty stage ({name})")
    check(e_c <= bound,
          "run-slod-eigh-f64: the card's and the CPU's eigh routes disagree")
    del f_cpu, f_gpu

    # 4. elasticity (float32, SLOD, smallk, Schur split): the stencil
    # two-level preconditioner and the coarse FEM's CG branch
    s, out, paths["run-elasticity"] = run_solver(
        "run-elasticity", elastic_cfg("float32", **fine), elastic=True)
    check(s.topo.n_patches * s.C > s.cfg.two_level_dense_cap
          and s.solver_mode == "fused_split" and s.spec_mode == "smallk",
          "run-elasticity: not the stencil two-level / split / smallk route")
    check("error_FEMH_FEMh" in out and s.coarse_fem_solution.numel() > 6000,
          "run-elasticity: the coarse FEM comparison did not take its CG "
          "branch")
    del s, out

    # 5. the CLI once, 2D diffusion (float32 on the card), into a
    # temporary directory; the solver it builds is caught to hold its
    # launches to its code path and its results to the same configuration
    # run on the CPU
    from dealii_slod_tpu_torch.models import lod
    seen, run0 = [], lod.LODSolver.run

    def run_seen(self):
        res = run0(self)
        seen.append((self, res))
        return res

    here = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        lod.LODSolver.run = run_seen
        try:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            rc = cli.main(["diffusion", os.path.join(tmp, "parameters.prm")])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            lod.LODSolver.run = run0
            os.chdir(here)
        counts = dict(kernels.launches)
        files = sorted(os.listdir(tmp))
    print(f"[run-cli] rc {rc} in {wall:.3f} s; files {files}; launches "
          f"{counts}")
    check(rc == 0, "run-cli: the CLI failed")
    check({"used_parameters_2.prm", "solution_fine.vtu",
           "solution_coarse.vtu", "solution_coefficients.vtu"}
          <= set(files), "run-cli: an output file is missing")
    check(len(seen) == 1, "run-cli: the CLI did not run one solver")
    s, out = seen[0]
    check(s.device.type == "cuda" and s.cfg.dtype == "float32",
          f"run-cli: ran on {s.device} in {s.cfg.dtype}")
    check(all(counts.get(k, 0) > 0 for k in PATH_KERNELS["run-cli"]),
          f"a kernel of the run-cli path was not launched: {counts}")
    check(counts == expected_launches(s),
          f"run-cli: launches differ from the expected counts "
          f"{expected_launches(s)}")
    cfg = dataclasses.replace(s.cfg, write_output=False)
    ref = LODSolver(cfg, DiffusionProblem(cfg), device="cpu",
                    verbose=False).run()
    worst = max(abs(out[k].rows[0][2][n] - v) / abs(v)
                for k, t in ref.items() if hasattr(t, "rows")
                for n, v in t.rows[0][2].items())
    e_f = rel(out["lod_solution"].cpu(), ref["lod_solution"])
    print(f"[run-cli] against the float32 CPU run: tables worst rel diff "
          f"{worst:.3e}, LOD field {e_f:.3e} (<= {CLI_F32_BOUND:.0e})")
    check(list(out) == list(ref) and worst <= CLI_F32_BOUND
          and e_f <= CLI_F32_BOUND,
          "run-cli: the card's run differs from the CPU's")
    paths["run-cli"] = dict(counts=counts, per_step=counts, run_wall_s=wall)
    return paths


def drive(path, s, fn, calls=1):
    """Run ``fn()`` (one basis build or step of solver ``s``) ``calls``
    times on the card: the launch counts are set to 0 just before the first
    call and read just after the last, and per call must equal what the
    code path implies (``expected_launches``; every kernel of
    ``PATH_KERNELS[path]`` launched, none where the path names none);
    returns (the last call's result, per-path numbers)."""
    import torch
    from dealii_slod_tpu_torch.utils import kernels
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    walls = []
    for _ in range(calls):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    counts = dict(kernels.launches)
    per_step = {k: v / calls for k, v in sorted(counts.items())}
    expected = expected_launches(s)
    print(f"[{path}] walls {walls} s; basis built for {s.basis_patches} of "
          f"{s.topo.n_patches} patches; launches in {calls} calls {counts}, "
          f"per call {per_step}, expected {expected}")
    check(all(counts.get(k, 0) > 0 for k in PATH_KERNELS[path])
          and (PATH_KERNELS[path] or not counts),
          f"{path}: the path's kernels were not launched as named: {counts}")
    check(per_step == expected, f"{path}: launches per call differ from "
          "the expected counts")
    return out, dict(counts=counts, per_step=per_step, walls=walls,
                     wall_s=min(walls))


def step_field(s, pert=0.0):
    """One step of solver ``s`` on its own field, moved by ``pert``
    relative (seeded normal noise), and its rhs -> the prolonged LOD
    field."""
    import torch
    gen = torch.Generator().manual_seed(0)
    coef = {k: v * (1 + pert * torch.randn(
                v.shape, generator=gen, dtype=torch.float64).to(v))
            for k, v in s.coef_q.items()}
    s.build_step()(coef, s.fem_rhs)
    return s.prolong_lod_solution()


def phase_routes(card):
    """The remaining basis and coarse routes on the card: the classes
    oracle against the uniform kernel route (3D refine-3 l=2, float64),
    the panel LDL^T on the 4096-patch main configuration beside the fused
    step, the scatter assembly and the scan trace against the default
    route, the direct coarse solve against CG, a basis checkpoint, and the
    two examples; returns the per-path numbers by path."""
    import tempfile

    import torch
    from dealii_slod_tpu_torch.examples import convergence_study, multi_rhs
    from dealii_slod_tpu_torch.ops import patch_solve
    from dealii_slod_tpu_torch.utils import checkpoint, kernels

    paths, t_phase = {}, time.perf_counter()

    # 1. the classes oracle: uniform default route (K1, K2, K3, eigh)
    # against kernel_mode="classes" (no kernel), and a deduped constant
    # field against classes, which builds every patch
    for case, kw in CLASSES_CASES.items():
        out = {}
        for mode in ("uniform", "classes"):
            path = f"routes-{mode}-{case}"
            s = make_solver(bench_cfg("float64", n_global_refinements=3,
                                      kernel_mode=mode, **kw), False)
            out[mode], paths[path] = drive(path, s, s.compute_basis)
            if mode == "uniform":
                dd = s._patch_dedup(*s._uniform_inputs()[1:])
                check(s.basis_patches == (len(dd[0]) if dd
                                          else s.topo.n_patches),
                      f"{path}: {s.basis_patches} patches built, not the "
                      "unique window signatures of a constant field, or "
                      "all")
            P = s.topo.n_patches
            del s
        gaps = [float((a - b).abs().max())
                for a, b in zip(out["uniform"], out["classes"])]
        print(f"[routes] classes oracle ({case}, {P} patches, f64): "
              f"uniform vs classes Phi {gaps[0]:.3e} (<= "
              f"{CLASSES_BOUND[case]:.3e}), APhi {gaps[1]:.3e}")
        check(gaps[0] <= CLASSES_BOUND[case],
              f"routes: the classes oracle disagrees ({case})")
        del out

    # 2. panel on the 4096-patch main configuration, beside the fused step
    # in the same process, in turns: fused, panel, panel, fused
    fields = {}
    for dtype in ("float64", "float32"):
        kw = dict(eig_solver="smallk") if dtype == "float64" else {}
        tag = "f" + dtype[5:]
        sv = {m: make_solver(bench_cfg(dtype, patch_solver=p, **kw), False)
              for m, p in (("panel", "panel"), ("fused", "auto"))}
        walls = {m: [] for m in sv}
        for m, si in sv.items():
            si.assemble_fine_rhs()
            fields[(m, dtype)], _ = drive(f"routes-{m}-{tag}", si,
                                          lambda si=si: step_field(si))
        for m in ("fused", "panel", "panel", "fused"):
            _, paths[f"routes-{m}-{tag}"] = drive(
                f"routes-{m}-{tag}", sv[m],
                lambda si=sv[m]: si.build_step()(si.coef_q, si.fem_rhs))
            walls[m].append(paths[f"routes-{m}-{tag}"]["wall_s"])
        P, tab = sv["panel"].topo.n_patches, sv["panel"]._tables
        k2 = paths[f"routes-panel-{tag}"]["counts"].get("K2 gj_inverse", 0)
        print(f"[routes] panel vs fused, {P} patches {dtype} [{card}]: "
              f"steady wall panel {min(walls['panel']):.3f} s "
              f"({P / min(walls['panel']):.1f} patches/s; calls "
              f"{walls['panel']}), fused {min(walls['fused']):.3f} s "
              f"({P / min(walls['fused']):.1f} patches/s; calls "
              f"{walls['fused']}); K2 launches a panel step {k2} (a "
              f"chunk: {patch_solve.panel_k2_launches(tab.nI, tab.panel_nb)}"
              f" diagonal blocks, T^-1, (G + delta I)^-1)")
        if dtype == "float64":
            e = rel(fields[("panel", dtype)], fields[("fused", dtype)])
            print(f"[routes] panel vs fused prolonged field, float64: "
                  f"{e:.3e} (<= {PANEL_F64_BOUND:.0e})")
            check(e <= PANEL_F64_BOUND,
                  "routes: the panel and fused f64 fields disagree")
            sp64, sf64 = sv["panel"], sv["fused"]
        else:
            e = rel(fields[("panel", dtype)], fields[("fused", dtype)])
            print(f"[routes] panel vs fused prolonged field, float32: "
                  f"{e:.3e}")
            del sv
    # the panel's float32 X and T on every chunk, in K1's float32 gate
    tab = sp64._uniform_tables()
    f32_gate_all_chunks(sp64, tab, "panel_spd_multirhs",
                        solve=lambda a, b: patch_solve.panel_spd_multirhs(
                            a, b, nb=tab.panel_nb))
    del sp64

    # 3. the direct coarse solve against CG on the 4096-patch f64 basis
    sd = make_solver(bench_cfg("float64", eig_solver="smallk",
                               coarse_solve="direct"), False)
    sd.assemble_fine_rhs()
    (u_d, A_st), paths["routes-direct-f64"] = drive(
        "routes-direct-f64", sd,
        lambda: sd.build_step()(sd.coef_q, sd.fem_rhs))
    check(sd.coarse_cg is None, "routes: the direct route ran CG")
    rhs = sd._coarse_rhs(sd.Phi, sd.fem_rhs)
    walls = {}
    for name, fn in (("direct", lambda: sd._coarse_direct_fn(A_st)(rhs)),
                     ("cg", lambda: sf64._coarse_cg(A_st, rhs).x)):
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = fn()
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
        walls[name + "_x"] = x
    from dealii_slod_tpu_torch.ops.solvers import cg
    tight = cg(sf64._coarse_matvec_fn(A_st), rhs, max_steps=4000,
               tolerance=1e-12, reduce=1e-12,
               precond=lambda r: r / torch.einsum(
                   "pdd->pd", A_st[:, sf64.center_offset_idx]))
    e_d = rel(u_d, tight.x)
    e_cg = rel(walls["cg_x"], tight.x)
    print(f"[routes] direct coarse solve, {A_st.shape[0]} coarse dofs f64 "
          f"[{card}]: factor + solve {walls['direct']:.4f} s, CG "
          f"(reduce {sf64.cfg.coarse_solver.reduce:g}) "
          f"{walls['cg']:.4f} s; against CG to 1e-12 ({int(tight.n_iter)} "
          f"it): direct {e_d:.3e} (<= {DIRECT_BOUND:.0e}), the bench CG "
          f"{e_cg:.3e}")
    check(e_d <= DIRECT_BOUND, "routes: the direct and CG coarse "
          "solutions disagree")

    # 4. a checkpoint saved on the card loads into a new solver, whose
    # solve_coarse gives the same solution
    with tempfile.TemporaryDirectory() as tmp:
        path = checkpoint.save_basis(sd, os.path.join(tmp, "basis.npz"))
        fresh = make_solver(sd.cfg, False)
        check(checkpoint.load_basis(fresh, path),
              "routes: the checkpoint did not load")
        for si in (fresh, sd):
            si.fem_rhs = sd.fem_rhs
        e_c = rel(fresh.solve_coarse(), sd.solve_coarse())
        print(f"[routes] checkpoint ({os.path.getsize(path) / 2**20:.1f} "
              f"MiB) saved and loaded on the card: solve_coarse rel max "
              f"diff {e_c:.3e} (<= 1e-12)")
        check(e_c <= 1e-12, "routes: the loaded basis solves differently")
    del sd, sf64, fresh

    # 5. scatter and the scan trace against the default route, refine-3
    # f64 (eigh)
    cfg3 = dict(n_global_refinements=3)
    f3 = {}
    for name, kw in (("default", {}), ("scatter", dict(assembly_mode=
                                                       "scatter")),
                     ("off", dict(trace_kernel="off"))):
        si = make_solver(bench_cfg("float64", **cfg3, **kw), False)
        si.assemble_fine_rhs()
        f3[name], paths[f"routes-{name}-r3-f64"] = drive(
            f"routes-{name}-r3-f64", si, lambda si=si: step_field(si))
        if name == "scatter":
            again = rel(step_field(si), f3[name])
        del si
    print(f"[routes] scatter run to run on the same inputs, refine-3 f64: "
          f"prolonged field {again:.3e}")
    for name, bound in ROUTE_FIELD_BOUND.items():
        e = rel(f3[name], f3["default"])
        print(f"[routes] {name} vs the default route, refine-3 f64: "
              f"prolonged field {e:.3e} (<= {bound:.1e})")
        check(e <= bound, f"routes: {name} disagrees with the default")

    # 6. the examples on the card, in this process
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    convergence_study.main(["--refinements", "3", "4", "5"])
    print(f"[routes] convergence_study --refinements 3 4 5 on the card in "
          f"{time.perf_counter() - t0:.2f} s; launches "
          f"{dict(kernels.launches)}")
    res = multi_rhs.main([])
    walls = res["serve_s"]
    print(f"[routes] multi_rhs (defaults) [{card}]: basis "
          f"{res['basis_s']:.3f} s, median serve "
          f"{1e3 * sorted(walls)[len(walls) // 2]:.3f} ms over "
          f"{len(walls)} load cases ({res['mode']})")
    check(all(bool(torch.isfinite(u).all()) for u in res["solutions"]),
          "routes: multi_rhs served a non-finite solution")
    print(f"[routes] phase done in {time.perf_counter() - t_phase:.1f} s")
    return paths


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="also profile one step of the jacobi, main, weig "
                    "and elasticity paths (torch.profiler)")
    ap.add_argument("--root", default=HERE,
                    help="a directory inside this checkout that holds "
                    "another commit's dealii_slod_tpu_torch (for example "
                    "one unpacked by git archive): its package and kernels "
                    "run under this script's phases and timing")
    args = ap.parse_args()
    phases = args.phases.split(",")
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    root = os.path.realpath(args.root)
    if os.path.commonpath([root, HERE]) != HERE:
        print(f"chip_smoke: --root must lie inside {HERE}", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(root, "dealii_slod_tpu_torch")):
        print("chip_smoke: the port package is not in "
              f"{os.path.relpath(root, HERE)}", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name, table, paths = None, [], {}
    try:
        name, card = phase_device()
        if "build" in phases:
            phase_build()
        if "kernels" in phases:
            table += phase_kernels(card)
        if "el-kernels" in phases:
            table += phase_el_kernels(card)
        if "e2e-f64" in phases:
            phase_e2e_f64()
        if "jacobi" in phases:
            paths["jacobi"] = phase_jacobi(args.profile)
        f64 = None
        if "main" in phases:
            paths["main"], paths["main-f64"], f64 = phase_main(args.profile)
        if "weig" in phases and f64 is not None:
            paths["weig"], paths["weig-f64"] = phase_weig(f64, args.profile)
        if "elasticity" in phases:
            paths.update(phase_elasticity(args.profile))
        if "run" in phases:
            paths.update(phase_run())
        if "routes" in phases:
            paths.update(phase_routes(card))
    except Exception as exc:                     # any phase failure
        print(f"chip_smoke: FAILED: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        import traceback
        traceback.print_exc()
        return 1
    print(f"chip_smoke: phases {','.join(phases)} done in "
          f"{time.perf_counter() - t_start:.1f} s")
    for row in table:
        by_path = {p: out["counts"].get(row["kernel"], 0)
                   for p, out in paths.items() if out is not None}
        row["launches"] = by_path.get(row["path"], 0)
        row["launches_by_path"] = by_path
        if row["kernel"] == "K4 mgs_qr" and row["path"] in paths:
            per = paths[row["path"]]["per_step"].get(row["kernel"], 0)
            print(f"[K4] {row['name']}: device time per {row['path']} step "
                  f"{per:g} x {row['device_ms']:.4f} ms = "
                  f"{per * row['device_ms']:.3f} ms [{card}]")
        if "device_ms_full_batch" in row and row["path"] in paths:
            # the row's full batch is the path's launch (all W of a chunk)
            per = paths[row["path"]]["per_step"].get(row["kernel"], 0)
            dev = row["device_ms_full_batch"]
            print(f"[{row['kernel'][:2]}] {row['name']}: device time per "
                  f"{row['path']} step {per:g} x {dev:.3f} ms = "
                  f"{per * dev:.3f} ms [{card}]")
    print(json.dumps({"kernels": [
        {k: row[k] for k in ("name", "route", "source", "replaces",
                             "launches", "max_abs_err", "ms", "plain_ms",
                             "bound_ms", "bound_by", "library_ms", "shape",
                             "dtype", "launches_by_path", "ms_full_batch",
                             "library_ms_full_batch", "bound_ms_3xtf32",
                             "bound_ms_f64_cuda_cores", "bound_ms_smem",
                             "bound_ms_smem_full_batch", "cluster_size",
                             "device_ms", "kernel_ms",
                             "device_ms_full_batch")
         if k in row}
        for row in table]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
