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
   chunk of the configuration, K1's on the whole block of every chunk
   (the card's float32 route), K7's on every chunk's X), and K4 / K5 at
   the float64 path's Gram size (n = 375, k = 374: K4's global-memory
   columns, K5's thread-block cluster, held in float64 only, the one
   dtype that runs them; K5 on 4 of the W against the plain version, its
   eigenvalues on all 384 W against ``torch.linalg.eigh``'s, both timed
   on all 384, with the cluster size, a second bound at the rows'
   shared-memory traffic and, at the end, its device time per float64
   refine-3 step); K8 at the float32 path's shape (384, 32, 375) and, in
   float64, at k = 374 (a cluster per W, no workspace: 4 W compared and
   timed, the eigenvalues of all 384 against the plain version's), each
   with the route it took; the float64 configuration must resolve to the
   Schur split (the reference's rule) and the float32 one to K1 on the
   whole block (the card's rule); K1 on the whole 2187 block, factored in
   place on its padded operand, is timed beside the split on the chunk,
   and both routes' per-chunk times are printed side by side at the two
   padded-2240 blocks (3D l=2 elasticity, 3D l=3 diffusion:
   ``patch_route_times``, which set ``K1_WHOLE_MAX_N``);
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
   ``patch_solver="auto"`` must resolve to K1 on the whole block (the
   card's float32 rule) and the spectral stage to smallk; one first call
   and 2 timed calls, K1, K2, K4, K5, K7 launched as often as the code
   path implies; then refine-3
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
   a basis checkpoint saved and loaded on the card, refused by solvers
   whose settings key differs (``smallk_power``, the reaction problem)
   and loaded by the same configuration's solver on the CPU; the scatter
   assembly
   and ``trace_kernel="off"`` (no K3) against the default route at
   refine-3 float64; and the examples ``convergence_study
   --refinements 3 4 5`` and ``multi_rhs`` on the card;
12. reaction: ``ReactionDiffusionProblem`` with c = 1 + x (a mass term
   that varies in space: no dedup, no stiffness cache) on the main
   configuration: the step in float32 (one first call, 2 timed; the main
   path's launches, K1 32, K2 64, K3 64, K4 96, K5 32) and float64
   (prolonged fields within 1e-2), K1's and K3's float32 gates on every
   chunk, K1 and K3 against their plain versions on the first chunk's
   reaction operator (rows of the kernel table), the float64 3D refine-2
   l=1 step on the CPU against the card (1e-8), ``run()`` of the
   manufactured problem of ``tests/test_reaction.py`` (2D refine-3 l=2,
   float64) against the same run on the CPU (tables to 1e-10 of
   max(|value|, 1), the LOD field to 1e-10), and the CLI's ``reaction``
   into a temporary directory;
13. monte-carlo: the Monte-Carlo example at the JAX script's accelerator
   configuration (3D refine-4, 4096 patches, 32 samples, coefficient
   refinement 4, contrast 1e2, float32, the script's one chunk of all
   patches) with lognormal fields drawn on the card, then 8 samples of
   the host's random field: first call, per-sample walls, samples/s,
   peak memory, QoI spread and (samples + 1) steps' launches; the
   sampler's log-statistics, its seed and the same noise's field on the
   CPU and the card (1e-12); ``sweep_step`` on 4 of the samples (their
   QoIs as the example's lone steps) and, in float64 at refine-3,
   against lone steps (1e-10); K1's and K3's float32 gates on every chunk
   of a lognormal sample, of the channel field (2D refine-6) and of the
   random field at coef_max = 1e4;
14. scale: the JAX package's largest configurations, one first call and
   one timed call each: ``r5-diffusion`` (3D refine-5, 32768 patches; its
   prolonged field within 1e-2 of float64 with the float32 smallk
   choices; the relative L2 and energy errors of the float32, float64
   and float64-with-the-float32-rule fields, each coarse system solved
   exactly, against the float64 fine FEM solution, the float32 one held
   to ``R5_F32_FEM_BOUND``; with ``--profile``, its first call split
   into its parts),
   ``r5-elasticity`` (the same grid with C = 3; the plane-chunked coarse
   build, no float64 twin), ``l3-diffusion`` (refine-4, l = 3: K1 on the
   whole 2197 block in float32, the Schur split at C = 1 in float64) and
   ``l3-elasticity-r3`` (refine-3, l = 3, chunks of
   32: the per-patch Cholesky solve), each l = 3 path within 1e-2 of its
   float64 twin on the eigh stage; per path the routes, the stencil build
   the byte rule picks (whole / K-chunked / planes) and its wall, and
   whether the coefficient windows are cut per chunk; the whole,
   K-chunked and plane-chunked builds against each other on the
   4096-patch elasticity basis (1e-5) and the float64 refine-3 one
   (1e-12), each build's wall and memory; the kernels at the new shapes
   against their plain versions (K6 at the l = 3 leaves, K2 on pivots of
   the 343 and 1029 T, K3 / K7 at 343 / 1029 columns, K4 at (343, 32)
   and (1029, 32)) and K6's / K1's / K3's float32 gates on every chunk
   of l3-diffusion.  The el-kernels phase also reads K6's / K7's gates on
   every chunk of the elasticity configuration with lognormal Lame
   fields, and K8's on every chunk of the 4096-patch elasticity weig
   step;
15. shard: the scaling axes over ``torch.distributed``, ranks started by
   ``parallel.mesh.spawn`` (one process each) on the one card: the main
   path's step through ``build_step(make_mesh(1))`` at world size 1 over
   NCCL against ``build_step()`` in the same process; at world size 2
   over gloo, both ranks on cuda:0, the main step and the 4096-patch
   elasticity step (K1 on the whole block / K7 / K2 / K4 / K5), gathered on
   rank 0 and held to the single-card steps of this process (A_st 1e-4,
   u 1e-3 relative: the JAX dry run's bounds, ``__graft_entry__.py``),
   and the sample-sharded sweep on 4 of the Monte-Carlo configuration's
   random fields, each held to the single-card step on its field; then
   ``MC_SHARD=2`` through the example's ``main`` (its QoIs against the
   same steps').  Per path: backend, world size, patches a rank, halo
   bytes a rank, first-call and steady walls, peak memory a rank and
   each rank's launches (which must be what the rank's share of the code
   path implies).  Two ranks on one card measure the cost of the
   communication, not scaling.

Every path counts its kernel launches from 0, set just before its first
call and read just after its last; each K4 row's device time per step of
its path (launches x device ms) is printed, and K5's and K8's on the
float64 refine-3 paths (launches x device ms on all 384 W of a chunk).  The
second-to-last line is the JSON kernel table, the last line ``{"ok":
true, "device": {...}}``.  No JAX is imported.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "kernels", "el-kernels", "e2e-f64", "jacobi",
          "main", "weig", "elasticity", "run", "routes", "reaction",
          "monte-carlo", "scale", "shard")
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
# elasticity in float64 on the Schur split (K6 leaves); in float32 on the
# card K1 takes the whole block (``_K1``)
_ELASTIC = ("K2 gj_inverse", "K4 mgs_qr", "K5 jacobi_eigh",
            "K6 spd_multirhs_solve", "K7 stencil_trace")
_ELASTIC_WEIG = ("K2 gj_inverse", "K4 mgs_qr", "K6 spd_multirhs_solve",
                 "K7 stencil_trace", "K8 weig")
_ELASTIC_K1 = ("K1 fused_spd_multirhs", "K2 gj_inverse", "K4 mgs_qr",
               "K5 jacobi_eigh", "K7 stencil_trace")
_ELASTIC_WEIG_K1 = ("K1 fused_spd_multirhs", "K2 gj_inverse", "K4 mgs_qr",
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
    "elasticity": _ELASTIC_K1,
    "elasticity-r3-f32": _ELASTIC_K1,
    "elasticity-r3-f64": _ELASTIC,
    "main-f64": _MAIN,
    "weig-f64": _WEIG,
    "elasticity-r3-weig-f32": _ELASTIC_WEIG_K1,
    "elasticity-r3-weig-f64": _ELASTIC_WEIG,
    # LODSolver.run(): plain LOD and the eigh stage skip K4 / K5
    "run-2d-default": _MAIN[:3],
    "run-plain-f64": _MAIN[:3],
    "run-slod-eigh-f64": _MAIN[:3],
    "run-elasticity": _ELASTIC_K1,
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
    # the reaction phase: the main route with the mass term; run() and the
    # CLI on the eigh stage / plain LOD
    "reaction": _MAIN,
    "reaction-f64": _MAIN,
    "reaction-run": _MAIN[:3],
    "reaction-cli": _MAIN[:3],
    # the monte-carlo phase: the example's steps and the sweep's
    "monte-carlo": _MAIN,
    "monte-carlo-random": _MAIN,
    "sweep-f32": _MAIN,
    # the scale phase: refine-5 on the main and the elasticity routes; l = 3
    # diffusion on K1 whole (float32; its float64 twin on the Schur split,
    # K6 leaves at C = 1) and l = 3 elasticity on the per-patch Cholesky
    # solve (no K1 / K6); their float64 twins on the eigh stage skip K4 / K5
    "r5-diffusion": _MAIN,
    "r5-diffusion-f64": _MAIN,
    "r5-elasticity": _ELASTIC_K1,
    "l3-diffusion": _MAIN,
    "l3-diffusion-eigh-f64": ("K2 gj_inverse", "K3 stencil_trace",
                              "K6 spd_multirhs_solve"),
    "l3-elasticity-r3": ("K2 gj_inverse", "K4 mgs_qr", "K5 jacobi_eigh",
                         "K7 stencil_trace"),
    "l3-elasticity-r3-eigh-f64": ("K2 gj_inverse", "K7 stencil_trace"),
}
# float64 with the float32 path's smallk choices: the path's own kernels
PATH_KERNELS["r5-diffusion-f64-f32-rule"] = _MAIN
# the shard phase: the main and the elasticity route on each rank's share
PATH_KERNELS.update({"shard-main-ws1": _MAIN, "shard-main-ws2": _MAIN,
                     "shard-elasticity-ws2": _ELASTIC_K1,
                     "shard-sweep-ws2": _MAIN, "shard-mc": _MAIN})
# a sharded step against the single-card step: the JAX dry run's bounds
# (__graft_entry__.py:82-83), relative max differences
SHARD_BOUND = {"A_st": 1e-4, "u": 1e-3}
# the main path's launches a step (32 chunks of 128 patches)
MAIN_LAUNCHES = {"K1 fused_spd_multirhs": 32, "K2 gj_inverse": 64,
                 "K3 stencil_trace": 64, "K4 mgs_qr": 96,
                 "K5 jacobi_eigh": 32}
# the reaction phase's coefficient c(x): varying in space, so the patch
# dedup and the stiffness cache must not fire
REACTION = dict(reaction="1 + x")
# run() of tests/test_reaction.py's manufactured problem (u = sin(pi x)
# sin(pi y), alpha = c = 1) at refine 3, l = 2, float64
MANUFACTURED = dict(
    dim=2, n_global_refinements=3, n_subdivisions=2, oversampling=2,
    lod_stabilization=True, constant_coefficients=True, reaction="1",
    rhs="(2*pi^2 + 1)*sin(pi*x)*sin(pi*y)",
    exact_solution="sin(pi*x)*sin(pi*y)", bc="0", dtype="float64",
    solve_fine_problem=True, write_output=False)
# the JAX Monte-Carlo script's accelerator configuration
# (examples/monte_carlo.py:16), with its default contrast and coefficient
# refinement
MC_ENV = dict(MC_DIM="3", MC_REFINE="4", MC_COEF_REFINE="4",
              MC_CONTRAST="1e2")
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


# the r5-diffusion comparison with fine FEM: the float64 fine solve's CG
# (max_steps, tolerance, reduce), Jacobi, to 1e-10 of its first residual
# (201 iterations on an NVIDIA H100 80GB HBM3 at 700 W), far below the LOD
# fields' distances from it.  A regression guard on the float32 rule, not
# a proof of float32 accuracy: the float32 field's relative L2 and energy
# errors are each held to this factor times the float64 field's, 1.5x the
# larger float32 / float64 error ratio of the first run (43.80 in L2, 32.54
# in energy, on an NVIDIA H100 80GB HBM3 at 700 W)
FINE_FEM_CONTROL = (20000, 1e-30, 1e-10)
R5_F32_FEM_BOUND = 66.0


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


def make_solver(cfg, elastic, reaction=False, **kw):
    """``LODSolver`` of ``cfg``'s diffusion problem, or its elasticity or
    reaction-diffusion problem (c = ``cfg.reaction``)."""
    from dealii_slod_tpu_torch import (DiffusionProblem, ElasticityProblem,
                                       LODSolver, ReactionDiffusionProblem)
    problem = (ElasticityProblem if elastic else ReactionDiffusionProblem
               if reaction else DiffusionProblem)(cfg)
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


def chunk_inputs(elastic=False, chunk=128, reaction=False):
    """Real operators of one chunk of patches, float64: the first chunk of
    the main-path configuration (with ``reaction``, of the reaction path's:
    the mass term of c = 1 + x in the operator), or the chunk at the
    middle of the
    elasticity configuration's patch range (its first chunk lies in the
    z = 0 layer, where the leading block of the Schur split is masked dofs
    only: an identity block with zero right-hand sides).  Returns the
    solver, its tables, the coefficient windows and the window data."""
    import torch
    from dealii_slod_tpu_torch.models import basis
    cfg = (elastic_cfg if elastic else bench_cfg)(
        "float64", eig_solver="smallk", **REACTION if reaction else {})
    s = make_solver(cfg, elastic, reaction)
    tab = s._uniform_tables()
    _, nlo, nhi, sides = s._uniform_inputs()
    p0 = (s.topo.n_patches // 2 // chunk) * chunk if elastic else 0
    sel = slice(p0, p0 + chunk)
    cw = {k: basis.coef_windows(cfg, s.grid, s.coef_q[k])[sel]
          for k in tab.coef_names}
    lo = torch.as_tensor(nlo[sel], device="cuda")
    hi = torch.as_tensor(nhi[sel], device="cuda")
    sd = torch.as_tensor(sides[sel], device="cuda")
    which = "elasticity" if elastic else "reaction" if reaction else "main"
    print(f"[kernels] chunk of patches {p0}..{p0 + chunk - 1} of "
          f"{s.topo.n_patches} ({which})")
    return s, tab, cw, lo, hi, sd


def prep_block(tab, cw, lo, hi):
    """``basis.prep`` with A cut to its leading (nI, nI) block: where the
    tables assemble K1's padded operand (the card's "fused" route), the
    phases compare the block itself."""
    from dealii_slod_tpu_torch.models import basis
    band, A, PT_m, cvd = basis.prep(tab, cw, lo, hi)
    return band, A[:, :tab.nI, :tab.nI], PT_m, cvd


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


def k8_gate_all_chunks(sweeps, tol, cfg=None, elastic=False, label="weig"):
    """K8's float32 gate (error against the float64 plain version <= 4x the
    float32 plain version's + 1e-6, ``k5_err``) on the real ZT / YT of
    every chunk of a float32 weig step (default the weig path's; ``cfg``
    and ``elastic`` name another), recorded from one step (the float64
    plain version runs on them cast to float64); beside it, per chunk, the
    sweeps each matrix ran in the kernel, the float32 and the float64
    plain versions (block=1).  Prints the worst error-to-gate ratio and
    the count differences; fails where a ratio exceeds 1."""
    import torch
    from dealii_slod_tpu_torch.ops import eig
    s = make_solver(cfg or bench_cfg("float32", smallk_weig=True), elastic)
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
    print(f"[kernels] K8 weig: float32 gate on every chunk of the {label} "
          f"step ({len(seen)} chunks, {n_mat} W): worst error / gate "
          f"{worst[0]:.4f} at chunk {worst[1]} (err {worst[2]:.3e}, gate "
          f"{worst[3]:.3e}); sweeps per matrix: the kernel differs from the "
          f"float32 plain version on {diff_k32} W and from the float64 one "
          f"on {diff_k64}, the two plain versions on {diff_32_64}")
    check(len(seen) == -(-s.topo.n_patches // s.cfg.patch_chunk),
          f"K8 weig: {len(seen)} chunks recorded from the {label} step")
    check(worst[0] <= 1.0, f"K8 weig: float32 error over the gate at chunk "
          f"{worst[1]} of the {label} step")


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


def f32_gate_all_chunks(s, tab, name, chunk=128, solve=None, split=None):
    """The float32 gate of ``check_case`` (error against the float64 plain
    version <= 4x the float32 plain version's + 1e-6) on the real
    operators of every chunk of the configuration: K1's X and T, or,
    where the solver ``s`` takes the Schur split (``split`` None) or
    ``split`` is True, K6's X at every leaf of the split;
    and the trace (K3, or K7) on the chunk's band and the X that solve
    gives (the split's X assembled from its plain leaves).  With ``solve``
    (A, B) -> (X, T) in place of K1 (the panel route), that solve's X and
    T alone.  Prints the worst error-to-gate ratio of each; fails where
    one exceeds 1."""
    import torch
    from dealii_slod_tpu_torch.models import basis
    from dealii_slod_tpu_torch.ops import assembly, patch_solve
    if split is None:
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
        band, A, PT_m, _ = prep_block(
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
    band, A, PT_m, cvd = prep_block(tab, cw, lo, hi)
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


def lognormal_elasticity_gates():
    """K6's and K7's float32 gates on every chunk of the 4096-patch
    elasticity configuration with lognormal Lame fields (two samples of
    the device sampler at the Monte-Carlo script's refinement 4 and
    contrast 1e2, the field family PR 13 read K1 on)."""
    import torch
    from dealii_slod_tpu_torch.examples import monte_carlo
    from dealii_slod_tpu_torch.models.coefficients import (
        lognormal_lattice_batch)
    t0 = time.perf_counter()
    refine = int(MC_ENV["MC_COEF_REFINE"])
    s = make_solver(elastic_cfg("float64", eig_solver="smallk"), True)
    idx = monte_carlo.lattice_index(s.qpts, refine, "cuda")
    lam, mu = lognormal_lattice_batch(
        torch.Generator(device="cuda").manual_seed(3), 2, refine, 3, 1.0,
        1e2, device="cuda")
    s.coef_q = {"lam": lam[idx], "mu": mu[idx]}
    print("[kernels] K6 / K7 float32 gates on every chunk of the elasticity "
          "configuration with lognormal lam / mu:")
    f32_gate_all_chunks(s, s._uniform_tables(), "K6 spd_multirhs_solve")
    print(f"[kernels]   ({time.perf_counter() - t0:.1f} s)")


def k1_in_place_ms(Ap, B, reps=3):
    """CUDA-event ms of K1 on the padded operand ``Ap`` factored in place
    (the card's "fused" route): each call on a fresh copy made outside the
    timed span."""
    import torch
    from dealii_slod_tpu_torch.ops import patch_solve
    patch_solve.fused_spd_multirhs(Ap.clone(), B, in_place=True)
    total = 0.0
    for _ in range(reps):
        a = Ap.clone()
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        patch_solve.fused_spd_multirhs(a, B, in_place=True)
        t1.record()
        torch.cuda.synchronize()
        total += t0.elapsed_time(t1)
        del a
    return total / reps


# the two blocks of padded n 2240 that the port runs: (n, k, what)
ROUTE_SHAPES = [(2187, 375, "3D l=2 elasticity"),
                (2197, 343, "3D l=3 diffusion")]


def patch_route_times(card, P=128, dtype=None):
    """Per-chunk times of the two patch-solve routes beside each other at
    each block of ``ROUTE_SHAPES``, in ``dtype`` (float32 by default),
    128 patches of seeded SPD blocks (the factor's work does not depend on the values): K1 on the
    whole block factored in place on its padded operand, and the Schur
    split on K6 leaves (``fused_spd_multirhs_split``).  Both X against a
    float64 Cholesky solve.  These set ``models/lod.py: K1_WHOLE_MAX_N``."""
    import torch
    from dealii_slod_tpu_torch.ops import patch_solve
    dtype = dtype or torch.float32
    tag = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    gen = torch.Generator(device="cuda").manual_seed(22)
    for n0, k0, what in ROUTE_SHAPES:
        n = patch_solve.k1_operand_n(n0)
        M = torch.randn((P, n0, n0), generator=gen, device="cuda",
                        dtype=dtype)
        A = M @ M.mT / n0 + torch.eye(n0, device="cuda", dtype=dtype)
        del M
        B = torch.randn((P, n0, k0), generator=gen, device="cuda",
                        dtype=dtype)
        Ap = patch_solve._pad_spd(A, n)
        ms_whole = k1_in_place_ms(Ap, B)
        ms_split = cuda_ms(lambda: patch_solve.fused_spd_multirhs_split(
            A, B), 3)
        ref = torch.cholesky_solve(B.double(), torch.linalg.cholesky(
            A.double()))
        e_whole = rel(patch_solve.fused_spd_multirhs(Ap.clone(), B,
                                                     in_place=True)[0], ref)
        e_split = rel(patch_solve.fused_spd_multirhs_split(A, B)[0], ref)
        leaves = patch_solve.split_leaves(n0, k0, 128)
        print(f"[routes] {what} ({P}, {n0} -> {n}, k {k0}), {tag}, per "
              f"chunk: "
              f"K1 whole block in place {ms_whole:.3f} ms (X err "
              f"{e_whole:.3e}) | Schur split, K6 leaves {leaves} "
              f"{ms_split:.3f} ms (X err {e_split:.3e}) | split / whole "
              f"{ms_split / ms_whole:.3f} [{card}]", flush=True)
        del A, B, Ap, ref


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
    from dealii_slod_tpu_torch.models.lod import patch_solver_mode
    from dealii_slod_tpu_torch.ops import assembly, eig, patch_solve

    s, tab, cw, lo, hi, sd = chunk_inputs(elastic=True)
    card_f32 = patch_solver_mode(elastic_cfg("float32"), s.C,
                                 s.canvas_class, "cuda")
    check(s.solver_mode == "fused_split" and card_f32 == "fused",
          f"3D elasticity resolved to patch_solver {s.solver_mode!r} in "
          f"float64 and {card_f32!r} in float32 on the card, not "
          "'fused_split' (the reference's rule) and 'fused' (K1 on the "
          "whole block, the card's rule)")
    band, A, PT_m, cvd = prep_block(tab, cw, lo, hi)
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
    # the card's float32 route: K1 on the whole block of every chunk
    f32_gate_all_chunks(s, tab, "K1 fused_spd_multirhs", split=False)
    lognormal_elasticity_gates()
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

    # K1 on the whole (2187 -> 2240) block, factored in place on the padded
    # operand the card's float32 route assembles, beside the split
    A32, P32 = A.float(), PT_m.float()
    Ap32 = basis.prep(dataclasses.replace(
        tab, k1_n=patch_solve.k1_operand_n(tab.nI)), cw, lo, hi)[1].float()
    check(torch.equal(Ap32[:, :tab.nI, :tab.nI], A32),
          "the padded operand's leading block is not the patch block")
    ms_whole = k1_in_place_ms(Ap32, P32)
    ms_split = cuda_ms(lambda: patch_solve.fused_spd_multirhs_split(
        A32, P32, nb=tab.panel_nb), 1)
    e_whole = rel(patch_solve.fused_spd_multirhs(Ap32.clone(), P32,
                                                 in_place=True)[0], X64)
    e_split = rel(patch_solve.fused_spd_multirhs_split(
        A32, P32, nb=tab.panel_nb)[0], X64)
    print(f"[kernels] patch solve of the elasticity chunk, f32: K1 on the "
          f"whole block in place {ms_whole:.3f} ms (X err {e_whole:.3e}); "
          f"Schur split on K6 leaves {ms_split:.3f} ms (X err "
          f"{e_split:.3e}) [{card}]")
    del A32, P32, Ap32, A, X64
    patch_route_times(card)
    # float64 stays on the reference's rule (the split) on the card
    patch_route_times(card, dtype=torch.float64)

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
    k8_gate_all_chunks(sw, st, elastic_cfg("float32", smallk_weig=True),
                       True, "4096-patch elasticity weig")

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


def e2e_pair(label, make_cfg, elastic, kw, reaction=False):
    """One 3D refine-2 l=1 step in float64 on the CPU (plain versions) and
    on the card (kernels): u and the prolonged field within 1e-8."""
    from dealii_slod_tpu_torch import ReductionControl
    cfg = make_cfg("float64", n_global_refinements=2, oversampling=1,
                   coef_refinement=3, patch_chunk=32,
                   coarse_solver=ReductionControl(200, 1e-12, 1e-12), **kw)
    out = {}
    for dev in ("cpu", "cuda"):
        # eig_block=1: the plain Jacobi stops each matrix on its own, as
        # the kernels do
        s = make_solver(cfg, elastic, reaction, device=dev, eig_block=1)
        s.assemble_fine_rhs()
        u, _ = s.build_step()(s.coef_q, s.fem_rhs)
        out[dev] = (u.cpu(), s.prolong_lod_solution().cpu())
    e_u = rel(out["cuda"][0], out["cpu"][0])
    e_f = rel(out["cuda"][1], out["cpu"][1])
    print(f"[e2e-f64] {label}: 3D refine-2 l=1 (64 patches, C = {s.C}, "
          f"{s.solver_mode}): u rel diff {e_u:.3e}, prolonged rel diff "
          f"{e_f:.3e} (<= 1e-8)")
    check(e_u <= 1e-8 and e_f <= 1e-8,
          f"CPU and CUDA steps disagree ({label})")


def phase_e2e_f64():
    runs = {"jacobi": (bench_cfg, False, dict(eig_solver="jacobi",
                                              patch_solver="fused")),
            "smallk": (bench_cfg, False, dict(eig_solver="smallk",
                                              patch_solver="fused")),
            "elasticity": (elastic_cfg, True, dict(
                eig_solver="smallk", patch_solver="fused_split"))}
    for label, (make_cfg, elastic, kw) in runs.items():
        e2e_pair(label, make_cfg, elastic, kw)


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


def run_path(path, cfg, timed, profile=False, elastic=False,
             reaction=False):
    """Drive one path through ``LODSolver(cfg, problem).build_step()`` on
    the card: the launch counts are set to 0 just before the first call
    and read just after the last, and must equal what the code path
    implies (``drive``); returns (solver, per-path numbers)."""
    import torch

    s = make_solver(cfg, elastic, reaction)
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
    coarse = ("direct coarse solve" if res is None else
              f"CG {int(res.n_iter)} it converged {bool(res.converged)}")
    print(f"[{path}] {P} patches C={s.C} {cfg.dtype} (patch solver "
          f"{s.solver_mode}, spectral stage {s.spec_mode}): "
          f"{P / wall:.1f} patches/s; first call {first:.3f} s; steady wall "
          f"{wall:.3f} s (calls {walls}); peak {peak / 2**30:.2f} GiB; "
          f"{coarse}")
    if s.solver_mode == "fused_split":
        from dealii_slod_tpu_torch.ops.patch_solve import split_leaves
        tab = s._tables
        rule = split_leaves(tab.nI, tab.cD, tab.panel_nb)
        print(f"[{path}] split leaves (n, k) per chunk, by the rule (the K6 "
              f"count above holds the run to their number): {rule}")
    check(bool(torch.isfinite(u).all()) and float(u.abs().max()) > 0,
          f"{path}: u is not finite and non-zero")
    check(res is None or bool(res.converged),
          f"{path}: coarse CG did not converge")
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
    check(s.solver_mode == "fused" and s.spec_mode == "smallk",
          f"elasticity resolved to patch solver {s.solver_mode!r} and "
          f"spectral stage {s.spec_mode!r}, not 'fused' (K1 on the whole "
          "block) / 'smallk'")
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


def run_solver(path, cfg, elastic=False, reaction=False):
    """Drive one path through ``LODSolver(cfg, problem).run()`` on the
    card: the launch counts are set to 0 just before the run and read just
    after, and must equal what the code path implies for one step; prints
    the stage walls, the peak memory, the tables and the launches; returns
    (solver, results, per-path numbers)."""
    import torch
    from dealii_slod_tpu_torch.utils import kernels

    s = make_solver(cfg, elastic, reaction)
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
    import torch
    from dealii_slod_tpu_torch import DiffusionProblem, LODSolver, SLODConfig
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

    # 4. elasticity (float32, SLOD, smallk, K1 on the whole block): the stencil
    # two-level preconditioner and the coarse FEM's CG branch
    s, out, paths["run-elasticity"] = run_solver(
        "run-elasticity", elastic_cfg("float32", **fine), elastic=True)
    check(s.topo.n_patches * s.C > s.cfg.two_level_dense_cap
          and s.solver_mode == "fused" and s.spec_mode == "smallk",
          "run-elasticity: not the stencil two-level / whole-block K1 / "
          "smallk route")
    check("error_FEMH_FEMh" in out and s.coarse_fem_solution.numel() > 6000,
          "run-elasticity: the coarse FEM comparison did not take its CG "
          "branch")
    del s, out

    # 5. the CLI once, 2D diffusion (float32 on the card), into a
    # temporary directory; its results against the same configuration run
    # on the CPU
    s, out, counts, wall = run_cli("run-cli", ["diffusion"])
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


def run_cli(path, argv):
    """``cli.main(argv)`` (the function ``python -m dealii_slod_tpu_torch.cli``
    runs) once in a temporary directory, on the card: rc 0, the parameter
    dump and the three VTU files, one solver run on the card in float32
    (caught by wrapping ``LODSolver.run``) and the launches its code path
    implies; returns (solver, results, launches, wall)."""
    import tempfile

    import torch
    from dealii_slod_tpu_torch import cli
    from dealii_slod_tpu_torch.models import lod
    from dealii_slod_tpu_torch.utils import kernels
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
            rc = cli.main(argv[:1] + [os.path.join(tmp, "parameters.prm")]
                          + argv[1:])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            lod.LODSolver.run = run0
            os.chdir(here)
        counts = dict(kernels.launches)
        files = sorted(os.listdir(tmp))
    print(f"[{path}] rc {rc} in {wall:.3f} s; files {files}; launches "
          f"{counts}")
    check(rc == 0, f"{path}: the CLI failed")
    check({"used_parameters_2.prm", "solution_fine.vtu",
           "solution_coarse.vtu", "solution_coefficients.vtu"}
          <= set(files), f"{path}: an output file is missing")
    check(len(seen) == 1, f"{path}: the CLI did not run one solver")
    s, out = seen[0]
    check(s.device.type == "cuda" and s.cfg.dtype == "float32",
          f"{path}: ran on {s.device} in {s.cfg.dtype}")
    check(all(counts.get(k, 0) > 0 for k in PATH_KERNELS[path]),
          f"a kernel of the {path} path was not launched: {counts}")
    check(counts == expected_launches(s),
          f"{path}: launches differ from the expected counts "
          f"{expected_launches(s)}")
    return s, out, counts, wall


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
    from dealii_slod_tpu_torch.models.coarse import CoarseSystem
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
    rhs = CoarseSystem(sd, A_st).rhs(sd.Phi, sd.fem_rhs)
    walls = {}
    for name, fn in (("direct",
                      lambda: CoarseSystem(sd, A_st).direct_solve(rhs)),
                     ("cg", lambda: CoarseSystem(sf64, A_st).cg(rhs).x)):
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = fn()
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
        walls[name + "_x"] = x
    from dealii_slod_tpu_torch.ops.solvers import cg
    tight = cg(CoarseSystem(sf64, A_st).matvec, rhs, max_steps=4000,
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
        # the settings key: a solver whose smallk stage or problem differs
        # refuses the file; the same configuration's CPU solver loads it
        t0 = time.perf_counter()
        for label, other in (
                ("smallk_power=1", make_solver(dataclasses.replace(
                    sd.cfg, smallk_power=1), False)),
                ("the reaction problem", make_solver(sd.cfg, False,
                                                     reaction=True))):
            check(not checkpoint.load_basis(other, path),
                  f"routes: the checkpoint loaded into a solver with {label}")
            del other
        cpu = make_solver(sd.cfg, False, device="cpu")
        check(checkpoint.load_basis(cpu, path)
              and cpu.Phi.device.type == "cpu"
              and bool((cpu.A_stencil == sd.A_stencil.cpu()).all()),
              "routes: the card's checkpoint did not load on the CPU as "
              "saved")
        del cpu
        print(f"[routes] checkpoint settings: refused by smallk_power=1 and "
              f"by the reaction problem, loaded on the CPU bit for bit "
              f"({time.perf_counter() - t0:.1f} s)")
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


def reaction_kernel_rows(card):
    """K1 and K3 against their plain versions on the first chunk of the
    reaction path's real operator (the band and SPD block with the mass
    term of c = 1 + x): float64 within 1e-10, float32 by ``check_case``'s
    rule, timed; the rows count the reaction path's launches."""
    from dealii_slod_tpu_torch.models import basis
    from dealii_slod_tpu_torch.ops import assembly, patch_solve

    _, tab, cw, lo, hi, _ = chunk_inputs(reaction=True)
    band, A, PT_m, _ = prep_block(tab, cw, lo, hi)
    Xp = trace_operand(tab, patch_solve.fused_spd_multirhs_plain(A, PT_m)[0])
    B, n, kk = A.shape[0], A.shape[-1], PT_m.shape[-1]
    nN, n_off, nNp = band.shape[1], band.shape[2], Xp.shape[2]
    f4 = 4
    k1_work = (B * (n ** 3 / 3 + 2 * n * n * kk + 2 * n * kk * kk),
               B * f4 * (n * n + 2 * n * kk + kk * kk))
    k3_lib = trace_spmm(band.float(), nNp, tab.shiftN, tab.offs_flat)
    args = (tab.shiftN, tab.offs_flat)
    table = []
    check_case(table, card, "K1 fused_spd_multirhs [reaction]",
               f"A ({B}, {n}, {n}), B ({B}, {n}, {kk}), c = 1 + x",
               lambda dt: (A.to(dt), PT_m.to(dt)),
               patch_solve.fused_spd_multirhs,
               patch_solve.fused_spd_multirhs_plain,
               lambda o, r: max(rel(o[0], r[0]), rel(o[1], r[1])),
               lambda a: by(*k1_work), None, path="reaction")
    second_bound(table[-1], card, *k1_work, "bound_ms_3xtf32")
    name = "K3 stencil_trace [reaction]"
    spmm_check(name, k3_lib, band, Xp, tab)
    check_case(table, card, name,
               f"band ({B}, {nN}, {n_off}), X ({B}, 1, {nNp}, {kk}), "
               f"c = 1 + x",
               lambda dt: (band.to(dt), Xp.to(dt).contiguous()),
               lambda b, x: assembly.stencil_trace(b, x, *args),
               lambda b, x: assembly.stencil_trace_plain(b, x, *args), rel,
               lambda a: by(B * 2 * n_off * nN * kk,
                            B * f4 * (nN * n_off + nNp * kk + nN * kk)),
               k3_lib, path="reaction")
    return table


def table_diff(out, ref):
    """The worst difference of two ``run()`` results' tables, relative to
    max(|value|, 1): the norms measure fields of unit size."""
    return max(abs(out[k].rows[0][2][n] - v) / max(abs(v), 1.0)
               for k, t in ref.items() if hasattr(t, "rows")
               for n, v in t.rows[0][2].items())


def phase_reaction(card, profile=False):
    """Reaction-diffusion on the card (c = 1 + x, a mass term that varies
    in space): the main configuration's step in float32 (the main path's
    launches) and float64, K1's and K3's float32 gates on every chunk, K1
    and K3 against their plain versions on the first chunk's operator, a
    float64 refine-2 step against the CPU, ``run()`` of the manufactured
    problem against the CPU's, and the CLI's ``reaction``; returns (kernel
    rows, per-path numbers by path)."""
    from dealii_slod_tpu_torch import (LODSolver, ReactionDiffusionProblem,
                                       ReductionControl, SLODConfig)

    paths, t_phase = {}, time.perf_counter()
    s, paths["reaction"] = run_path("reaction", bench_cfg(
        "float32", **REACTION), timed=2, profile=profile, reaction=True)
    check(s.spec_mode == "smallk" and s.solver_mode == "fused",
          f"reaction: spectral stage {s.spec_mode!r}, patch solver "
          f"{s.solver_mode!r}, not the main path's")
    check(not s.problem.is_constant() and s.coef_names == ["alpha",
                                                           "creact"],
          "reaction: c = 1 + x is not a varying creact coefficient")
    check(paths["reaction"]["per_step"] == MAIN_LAUNCHES,
          f"reaction: launches a step differ from the main path's "
          f"{MAIN_LAUNCHES}")
    f32 = s.prolong_lod_solution().double().cpu()
    del s
    s64, paths["reaction-f64"] = run_path("reaction-f64", bench_cfg(
        "float64", eig_solver="smallk", **REACTION), timed=1, reaction=True)
    e = rel(f32, s64.prolong_lod_solution().cpu())
    print(f"[reaction] prolonged f32 vs f64 rel max diff {e:.3e} (<= 1e-2)")
    check(e <= 1e-2, "reaction: f32 and f64 prolonged fields disagree")
    print("[reaction] K1 / K3 float32 gates on every chunk, c = 1 + x:")
    f32_gate_all_chunks(s64, s64._uniform_tables(), "K1 fused_spd_multirhs")
    del s64
    table = reaction_kernel_rows(card)
    e2e_pair("reaction", bench_cfg, False, dict(
        eig_solver="smallk", patch_solver="fused", **REACTION),
        reaction=True)

    # run() of the manufactured problem against the same run on the CPU
    cfg = SLODConfig(**MANUFACTURED,
                     fine_solver=ReductionControl(8000, 1e-12, 1e-12),
                     coarse_solver=ReductionControl(4000, 1e-12, 1e-12))
    ref = LODSolver(cfg, ReactionDiffusionProblem(cfg), device="cpu",
                    verbose=False).run()
    s, out, paths["reaction-run"] = run_solver("reaction-run", cfg,
                                               reaction=True)
    worst = table_diff(out, ref)
    e_f = rel(out["lod_solution"].cpu(), ref["lod_solution"])
    print(f"[reaction-run] against the CPU run: tables worst diff "
          f"{worst:.3e} (relative to max(|v|, 1); <= 1e-10), LOD field "
          f"{e_f:.3e} (<= 1e-10)")
    check(list(out) == list(ref) and worst <= 1e-10 and e_f <= 1e-10,
          "reaction-run: the card's run differs from the CPU's")
    del s, out, ref

    _, out, counts, wall = run_cli("reaction-cli", ["reaction", "--device",
                                                    "cuda"])
    check(all(math.isfinite(v) for t in out.values() if hasattr(t, "rows")
              for v in t.rows[0][2].values()),
          "reaction-cli: a table is not finite")
    paths["reaction-cli"] = dict(counts=counts, per_step=counts,
                                 run_wall_s=wall)
    print(f"[reaction] phase done in {time.perf_counter() - t_phase:.1f} s")
    return table, paths


def env_run(fn, **env):
    """``fn()`` with the environment variables ``env`` set, the caller's
    restored after."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def phase_monte_carlo(card):
    """The Monte-Carlo example on the card at the JAX script's TPU
    configuration (``MC_DIM=3 MC_REFINE=4 MC_SAMPLES=32``, coefficient
    refinement 4, contrast 1e2, float32) with the device sampler's
    lognormal fields, then 8 samples of the host's random field; the
    sampler's statistics, seed and CPU-vs-card noise-to-field; the sweep
    at full size and, in float64 at refine-3, against lone steps; and
    K1's / K3's float32 gates on every chunk of a lognormal sample, the
    channel field and the random field at coef_max = 1e4; returns the
    per-path numbers by path."""
    import numpy as np
    import torch
    from dealii_slod_tpu_torch.examples import monte_carlo
    from dealii_slod_tpu_torch.models.coefficients import (
        lognormal_from_noise, lognormal_lattice_batch)
    from dealii_slod_tpu_torch.parallel import stack_fields, sweep_step
    from dealii_slod_tpu_torch.utils import kernels

    paths, runs, t_phase = {}, {}, time.perf_counter()
    for path, field, n in (("monte-carlo", "lognormal", 32),
                           ("monte-carlo-random", "random", 8)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = env_run(lambda: monte_carlo.main([]), **MC_ENV,
                      MC_SAMPLES=str(n), MC_FIELD=field)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kernels.launches)
        peak = torch.cuda.max_memory_allocated()
        s, walls, q = res["solver"], res["walls"], np.array(res["qoi"])
        per = expected_launches(s)
        print(f"[{path}] {n} samples, {s.topo.n_patches} patches "
              f"{s.cfg.dtype} ({s.spec_mode}, {s.solver_mode}) [{card}]: "
              f"sampler {1e3 * res['sampler_s']:.1f} ms; first call "
              f"{res['first_s']:.3f} s; per sample median "
              f"{1e3 * np.median(walls):.1f} ms (min {1e3 * min(walls):.1f}"
              f", max {1e3 * max(walls):.1f}); {n / sum(walls):.2f} "
              f"samples/s; peak {peak / 2**30:.2f} GiB; QoI mean "
              f"{q.mean():.6e} std {q.std():.3e}; wall {wall:.2f} s; "
              f"launches {counts} ({n + 1} steps of {per}: chunks of "
              f"{s.cfg.patch_chunk or s.topo.n_patches} patches)")
        check(s.device.type == "cuda" and s.cfg.dtype == "float32"
              and s.spec_mode == "smallk" and s.solver_mode == "fused",
              f"{path}: not the main path's route on the card in float32")
        # the script's default patch_chunk = 0: all 4096 patches in one
        # chunk, so a step launches each kernel once per chunk-level call
        check(s.cfg.patch_chunk == 0 and counts == {
            k: v * (n + 1) for k, v in per.items()}
            and set(per) == set(MAIN_LAUNCHES),
            f"{path}: launches differ from {n + 1} steps of the main "
            "route in one chunk")
        check(bool(np.isfinite(q).all()) and bool((q != 0).all()),
              f"{path}: a QoI is not finite and non-zero")
        paths[path] = dict(counts=counts, per_step=per, first_call_s=res[
            "first_s"], samples_per_s=n / sum(walls), peak_bytes=peak)
        runs[field] = res

    # the device sampler: statistics, its seed, and noise to field on the
    # card against the CPU
    res = runs["lognormal"]
    lat, refine = res["lattice"], int(MC_ENV["MC_COEF_REFINE"])
    lg = torch.log(lat)
    mu, sigma = 0.5 * math.log(1e2), 0.25 * math.log(1e2)
    d_mu, d_sig = abs(float(lg.mean()) - mu), abs(float(lg.std(
        correction=0)) - sigma)
    gen = torch.Generator(device="cuda")

    def draw():
        return lognormal_lattice_batch(gen.manual_seed(0), lat.shape[0],
                                       refine, 3, 1.0, 1e2, device="cuda")

    same = torch.equal(draw(), lat)
    w = torch.randn((4,) + (2 ** refine,) * 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    e_n = rel(lognormal_from_noise(w.cuda(), 1.0, 1e2).cpu(),
              lognormal_from_noise(w, 1.0, 1e2))
    print(f"[monte-carlo] sampler {tuple(lat.shape)} {lat.dtype}: log-mean "
          f"off by {d_mu:.3f} (< 0.6), log-std by {d_sig:.3f} (< 0.3); "
          f"the same seed again equal {same}; {cuda_ms(draw):.3f} ms a "
          f"draw [{card}]; CPU noise on the card vs the CPU {e_n:.3e} "
          f"(<= 1e-12)")
    check(d_mu < 0.6 and d_sig < 0.3 and same and e_n <= 1e-12,
          "monte-carlo: the device sampler fails a check")

    # the sweep at full size on the example's first 4 fields: the same
    # QoIs as the example's lone steps
    s, field = res["solver"], res["field"]
    batch = stack_fields([field(i + 1) for i in range(4)])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    u, _ = sweep_step(s)(batch, s.fem_rhs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    e_q = max(abs(float(u[i].mean()) - res["qoi"][i]) / abs(res["qoi"][i])
              for i in range(4))
    print(f"[sweep-f32] 4 samples in {wall:.3f} s; launches {counts}; QoIs "
          f"vs the example's lone steps rel {e_q:.3e} (<= 1e-6)")
    check(counts == {k: 4 * v for k, v in expected_launches(s).items()},
          "sweep-f32: launches differ from 4 of the example's steps")
    check(e_q <= 1e-6, "sweep-f32: the sweep's QoIs differ from the lone "
          "steps'")
    paths["sweep-f32"] = dict(counts=counts, per_step={
        k: v / 4 for k, v in counts.items()})
    del runs, res, s, field, batch, u

    # the sweep against lone steps, 3D refine-3 float64
    s3 = make_solver(bench_cfg("float64", n_global_refinements=3,
                               eig_solver="smallk", coef_refinement=refine),
                     False)
    s3.assemble_fine_rhs()
    idx = monte_carlo.lattice_index(s3.qpts, refine, "cuda")
    fields = [{"alpha": f[idx]} for f in lognormal_lattice_batch(
        gen.manual_seed(2), 3, refine, 3, 1.0, 1e2, device="cuda")]
    u, A_st = sweep_step(s3)(stack_fields(fields), s3.fem_rhs)
    e_s = 0.0
    for i, f in enumerate(fields):
        ui, Ai = s3.build_step()(f, s3.fem_rhs)
        e_s = max(e_s, rel(u[i], ui), rel(A_st[i], Ai))
    print(f"[sweep-r3-f64] 3 lognormal samples, {s3.topo.n_patches} "
          f"patches: sweep vs lone steps, u and A_st rel {e_s:.3e} "
          f"(<= 1e-10)")
    check(e_s <= 1e-10, "sweep-r3-f64: the sweep differs from lone steps")
    del s3, fields, u, A_st

    # K1's and K3's float32 gates on every chunk of other fields
    sample = lat[1]
    gates = {
        "a lognormal sample of the run": (bench_cfg(
            "float64", eig_solver="smallk", coef_refinement=refine), sample),
        "the channel field (2D refine-6, 4096 patches)": (bench_cfg(
            "float64", dim=2, n_global_refinements=6, eig_solver="smallk",
            coef_field="channel"), None),
        "the random field at coef_max = 1e4": (bench_cfg(
            "float64", eig_solver="smallk", coef_max=1e4), None)}
    for label, (cfg, lattice) in gates.items():
        t0 = time.perf_counter()
        sg = make_solver(cfg, False)
        if lattice is not None:
            sg.coef_q = {"alpha": lattice[monte_carlo.lattice_index(
                sg.qpts, refine, "cuda")]}
        print(f"[monte-carlo] K1 / K3 float32 gates on every chunk, "
              f"{label}:")
        f32_gate_all_chunks(sg, sg._uniform_tables(), "K1 fused_spd_multirhs")
        print(f"[monte-carlo]   ({time.perf_counter() - t0:.1f} s)")
        del sg
    print(f"[monte-carlo] phase done in {time.perf_counter() - t_phase:.1f} "
          f"s")
    return paths


def scale_paths():
    """The scale phase's paths: name -> (configuration, elasticity, its
    float64 twin (None: none) and the bound on their prolonged fields,
    each coarse system solved exactly (None: printed, not held), the patch
    solver and spectral stage the rules must pick, the stencil plan, and
    whether the coefficient windows are cut per chunk).

    At refine-5 the float32 and float64 smallk stages part by more than
    rounding: float32 regularizes the Grams by 1e-6 of their largest
    diagonal entry and keeps 32 directions, float64 by 1e-13 with all of
    them (both the reference's rule), and the two bases part by 1.76e-2
    at 32768 patches (2.4e-3 at 4096).  That path is held instead to
    float64 with the float32 choices (``f32_spectral_rule``) within
    1e-2.  The l = 3 twins solve their coarse systems directly: the
    float64 eigh stage's l = 3 elasticity operator did not converge in
    the bench's 500 CG steps."""
    r5 = dict(n_global_refinements=5)
    l3 = dict(oversampling=3, coarse_solve="direct")
    l3e = dict(n_global_refinements=3, oversampling=3, patch_chunk=32)
    return {
        # BASELINE.json configs[3]: 3D Poisson, 32^3 coarse cells
        "r5-diffusion": (bench_cfg("float32", **r5), False,
                         bench_cfg("float64", eig_solver="smallk", **r5),
                         None, ("fused", "smallk"), ("cells", 4), True),
        # VERDICT missing #2: refine-5 3D elasticity
        "r5-elasticity": (elastic_cfg("float32", **r5), True, None, None,
                          ("fused", "smallk"), ("planes", 1, 1), True),
        "l3-diffusion": (bench_cfg("float32", oversampling=3), False,
                         bench_cfg("float64", eig_solver="lapack", **l3),
                         1e-2, ("fused", "smallk"), ("cells", 3),
                         True),
        # BASELINE.json configs[4] at one card's scale
        "l3-elasticity-r3": (elastic_cfg("float32", **l3e), True,
                             elastic_cfg("float64", eig_solver="lapack",
                                         **dict(l3e, **l3)),
                             1e-2, ("lax", "smallk"), ("cells", 4), False),
    }


def timed_build(fn):
    """``fn()`` (a coarse-operator build) on the card -> (result, wall s,
    the peak it allocated beyond what was live before it)."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() - base)


def plan_text(plan):
    return ("whole" if plan == ("cells", 1) else
            f"K-chunked {plan[1]}" if plan[0] == "cells" else
            f"planes {plan[1]} x {plan[2]} z-planes a chunk")


def build_variants(label, s, tol, card):
    """The coarse operator of solver ``s``'s basis by the whole build, the
    K-chunked one (4 chunks) and the plane-chunked one at a 1-byte budget
    and at one that gives two phi planes a chunk (a partial tail): each
    against the whole build (relative max difference <= ``tol``), with
    its wall and the memory it allocated."""
    from dealii_slod_tpu_torch.models import stencil
    P, C, cfg = s.topo.n_patches, s.C, s.cfg
    Phi, APhi = s.Phi, s.APhi
    tab = s._stencil_tables
    item = Phi.element_size()
    kappa, dim, O = tab["kappa"], tab["dim"], tab["O"]
    two = 4 * P * 2 * kappa ** (dim - 1) * O * C * C * item
    builds = {
        "whole": lambda: stencil.stencil_build_cells(Phi, APhi, tab, 1),
        "K-chunked 4": lambda: stencil.stencil_build_cells(Phi, APhi, tab,
                                                           4),
        "planes, budget 1 B": lambda: stencil.stencil_build_cells_planes(
            Phi, APhi, tab, 1),
        f"planes, budget {two} B": lambda: stencil.stencil_build_cells_planes(
            Phi, APhi, tab, two)}
    chunks = {"planes, budget 1 B": stencil.planes_chunks(
        P, C * C, kappa, dim, O, item, 1),
        f"planes, budget {two} B": stencil.planes_chunks(
            P, C * C, kappa, dim, O, item, two)}
    plan = stencil.stencil_plan(cfg, P, C, item)
    ref = None
    for name, fn in builds.items():
        A, wall, peak = timed_build(fn)
        e = 0.0 if ref is None else rel(A, ref)
        ref = A if ref is None else ref
        extra = f" (zk x zm {chunks[name]})" if name in chunks else ""
        print(f"[scale] {label} build {name}{extra}: {wall:.3f} s, "
              f"{peak / 2**30:.2f} GiB allocated; vs whole {e:.3e} "
              f"(<= {tol:g}) [{card}]")
        check(e <= tol, f"{label}: the {name} build disagrees with the "
              "whole one")
        del A
    print(f"[scale] {label}: the rule picks {plan_text(plan)}")


def scale_kernel_rows(card):
    """The kernels the scale paths launch at shapes no other phase holds,
    against their plain versions on one chunk's real operands (float64
    basis chunk at the middle of the patch range): on l3-diffusion K6 at
    each leaf of the split, K2 on T's first 128-pivot (T 343 x 343), K3
    at 343 columns and K4 at (343, 32); on l3-elasticity-r3 K2 on T's
    first pivot (T 1029 x 1029), K7 at 1029 columns and K4 at (1029,
    32).  Returns the rows."""
    import torch
    from dealii_slod_tpu_torch.models import basis
    from dealii_slod_tpu_torch.ops import assembly, eig, patch_solve
    table, f4 = [], 4
    k3 = {"l3-diffusion": (bench_cfg("float64", eig_solver="smallk",
                                     oversampling=3), False),
          "l3-elasticity-r3": (elastic_cfg(
              "float64", eig_solver="smallk", n_global_refinements=3,
              oversampling=3, patch_chunk=32), True)}
    for path, (cfg, elastic) in k3.items():
        s = make_solver(cfg, elastic)
        tab = s._uniform_tables()
        chunk = cfg.patch_chunk
        _, nlo, nhi, sides = s._uniform_inputs()
        p0 = (s.topo.n_patches // 2 // chunk) * chunk
        sel = slice(p0, p0 + chunk)
        cw = {k: basis.coef_windows(cfg, s.grid, s.coef_q[k])[sel]
              for k in tab.coef_names}
        lo, hi, sd = (torch.as_tensor(a[sel], device="cuda")
                      for a in (nlo, nhi, sides))
        band, A, PT_m, cvd = prep_block(tab, cw, lo, hi)
        B, C, cD, nN = band.shape[0], tab.C, tab.cD, tab.n_nodes
        print(f"[scale] {path} chunk of patches {p0}..{p0 + chunk - 1}: A "
              f"({B}, {A.shape[-1]}, {A.shape[-1]}), PT ({B}, "
              f"{PT_m.shape[1]}, {PT_m.shape[2]}), patch solver "
              f"{s.solver_mode}")
        if s.solver_mode == "fused_split":
            (X64, Traw), leaves = split_leaf_operands(A, PT_m, tab.panel_nb)
            for i, (a, b) in enumerate(leaves):
                n, k = a.shape[-1], b.shape[-1]
                work = (B * (n ** 3 / 3 + 2 * n * n * k),
                        B * f4 * (n * n + 2 * n * k))
                check_case(
                    table, card, f"K6 spd_multirhs_solve [l3 leaf {i + 1}]",
                    f"A ({B}, {n}, {n}), B ({B}, {n}, {k})",
                    lambda dt, a=a, b=b: (a.to(dt), b.to(dt)),
                    patch_solve.spd_multirhs_solve,
                    patch_solve.spd_multirhs_solve_plain, rel,
                    lambda a_, w=work: by(*w),
                    lambda a, b: torch.linalg.solve(a, b), path=path)
                second_bound(table[-1], card, *work, "bound_ms_3xtf32")
            del leaves
        else:
            X64, Traw = patch_solve.fused_spd_multirhs_plain(A, PT_m)
        del A
        T = Traw / tab.Hdim + torch.diag_embed(1.0 - cvd)
        piv = T[:, :patch_solve.GJ_PAD, :patch_solve.GJ_PAD].contiguous()
        m = piv.shape[-1]
        check_case(
            table, card, f"K2 gj_inverse [T pivot, cD {cD}]",
            f"first pivot of T ({B}, {m}, {m}) (T {tuple(T.shape)})",
            lambda dt: (piv.to(dt),), patch_solve.gj_inverse,
            patch_solve.gj_inverse_plain, rel,
            lambda a: by(B * 2 * m ** 3, B * f4 * 2 * m * m),
            lambda a: torch.linalg.inv(a), path=path)
        Xp = trace_operand(tab, X64)
        kk, nNp, n_off = Xp.shape[-1], Xp.shape[2], len(tab.offs_flat)
        kname = "K3 stencil_trace" if C == 1 else "K7 stencil_trace"
        lib = trace_spmm(band.float(), nNp, tab.shiftN, tab.offs_flat)
        check_case(
            table, card, f"{kname} [l3]",
            f"band ({B}, {nN}, {band.shape[2]}), X ({B}, {C}, {nNp}, {kk})",
            lambda dt: (band.to(dt).contiguous(), Xp.to(dt).contiguous()),
            lambda b, x: assembly.stencil_trace(b, x, tab.shiftN,
                                                tab.offs_flat),
            lambda b, x: assembly.stencil_trace_plain(b, x, tab.shiftN,
                                                      tab.offs_flat),
            rel,
            lambda a: by(B * nN * kk * 2 * n_off * C * C,
                         B * f4 * (nN * n_off * C * C + C * nNp * kk
                                   + C * nN * kk)),
            lib, path=path)
        spmm_check(f"{kname} [l3]", lib, band, Xp, tab)
        del lib, Xp
        S99, is99d = basis.trace_S_chunk(tab, band, X64, lo, hi, sd)
        del X64, band
        Tinv = torch.linalg.inv(T)
        G, _ = basis.finish_pre_from_S(tab, S99, Tinv, cvd, is99d)
        del S99, T, Tinv
        G = G.reshape(B * C, cD, cD)
        BC = G.shape[0]
        k = basis.smallk_k_eff(cD, torch.float32, s.cfg.smallk_dirs)
        dmax = torch.diagonal(G, dim1=-2, dim2=-1).abs().amax(-1)
        Gj = G + (1e-6 * torch.where(dmax > 0, dmax, 1.0))[:, None, None] \
            * torch.eye(cD, dtype=G.dtype, device=G.device)
        X_it = torch.linalg.solve(Gj, eig.smallk_start(
            cD, k, G.dtype, G.device).expand(BC, cD, k).contiguous())
        del G, Gj
        check_case(
            table, card, f"K4 mgs_qr [l3, n {cD}]",
            f"X ({BC}, {cD}, {k}) = Ginv Z0",
            lambda dt: (X_it.to(dt),), eig.mgs_qr, eig.mgs_qr_plain, None,
            lambda a: by(BC * 4 * cD * k * k, BC * f4 * 2 * cD * k),
            lambda x: torch.linalg.qr(x), path=path,
            contract=lambda q, a: qr_contract_err(q, a[0]))
        del X_it, s, cw
        torch.cuda.empty_cache()
    return table


@contextlib.contextmanager
def f32_spectral_rule():
    """Inside the block a float64 solver's smallk stage makes the float32
    path's choices: the Tikhonov jitter 1e-6 of max |diag G| and
    ``smallk_dirs`` directions (float64 takes 1e-13 and all of them)."""
    import torch
    from dealii_slod_tpu_torch.models import basis
    from dealii_slod_tpu_torch.ops import eig
    k_eff, jitter = basis.smallk_k_eff, eig.JITTER[torch.float64]
    basis.smallk_k_eff = lambda cD, dtype, dirs: k_eff(cD, torch.float32,
                                                       dirs)
    eig.JITTER[torch.float64] = eig.JITTER[torch.float32]
    try:
        yield
    finally:
        basis.smallk_k_eff, eig.JITTER[torch.float64] = k_eff, jitter


def exact_field(s):
    """The prolonged LOD field of solver ``s``'s last step with its coarse
    system solved exactly: the step's A_st and basis in float64, a dense
    Cholesky solve (no CG stop), on the card; returned on the host."""
    import torch
    from dealii_slod_tpu_torch.models.coarse import CoarseSystem
    from dealii_slod_tpu_torch.ops.solvers import cholesky_solve
    Phi = s.Phi.double()
    A = s.coarse_dense_matrix(s.A_stencil.double())
    if len(A) <= s.cfg.coarse_dense_cap:
        lam = torch.linalg.eigvalsh(A)
        print(f"[exact solve] {s.cfg.dtype} coarse operator "
              f"{tuple(A.shape)}: eigenvalues {float(lam[0]):.3e} .. "
              f"{float(lam[-1]):.3e}, condition "
              f"{float(lam[-1] / lam[0]):.3e}")
    L = torch.linalg.cholesky(A)
    del A
    rhs = CoarseSystem(s, s.A_stencil).rhs(Phi, s.fem_rhs.double())
    x = cholesky_solve(L, rhs.reshape(-1, 1)).reshape(rhs.shape)
    del L
    out = torch.zeros((s.grid.n_nodes, s.C), dtype=torch.float64,
                      device=Phi.device)
    out.index_add_(0, s.canvas_gidx.reshape(-1),
                   torch.einsum("pncd,pd->pnc", Phi, x).reshape(-1, s.C))
    return (out + s.fine_bc_values.double()).cpu()


def scale_path(card, paths, path, cfg, elastic, twin, bound, route, plan,
               per_chunk):
    """One path of the scale phase (``scale_paths``), its numbers into
    ``paths``: the step, its routes, the stencil build and the windows,
    and the prolonged field, each coarse system solved exactly, against
    the float64 twin (within ``bound``) or, where that is None, against
    float64 with the float32 path's smallk choices
    (``f32_spectral_rule``, within 1e-2)."""
    import torch
    from dealii_slod_tpu_torch.models import stencil
    s, paths[path] = run_path(path, cfg, timed=1, elastic=elastic)
    P, C = s.topo.n_patches, s.C
    got = stencil.stencil_plan(cfg, P, C, s.Phi.element_size())
    rows = s._window_chunk_rows(s.coef_q, P, cfg.patch_chunk)
    _, wall, peak = timed_build(s.assemble_coarse_operator)
    print(f"[{path}] stencil build: {plan_text(got)}, {wall:.3f} s, "
          f"{peak / 2**30:.2f} GiB allocated; coefficient windows "
          + (f"cut per chunk ({rows} x-rows a chunk)" if rows else "whole")
          + f" [{card}]")
    paths[path].update(stencil_build_s=wall, stencil_build_bytes=peak)
    check((s.solver_mode, s.spec_mode) == route,
          f"{path}: patch solver {s.solver_mode!r} and spectral stage "
          f"{s.spec_mode!r}, not {route}")
    check(got == plan and bool(rows) == per_chunk,
          f"{path}: stencil build {got} and windows {rows}, not {plan} and "
          f"{'per chunk' if per_chunk else 'whole'}")
    check(paths[path]["peak_bytes"] < 80e9, f"{path}: peak over 80 GB")
    if twin is None:
        return
    # each step's field and the same with its coarse system solved
    # exactly, which takes the coarse CG's stop out of the comparison
    field, ex = s.prolong_lod_solution().double().cpu(), exact_field(s)
    del s
    torch.cuda.empty_cache()
    twin_path = path + ("-f64" if twin.eig_solver == "smallk"
                        else "-eigh-f64")
    s64, paths[twin_path] = run_path(twin_path, twin, timed=0,
                                     elastic=elastic)
    field64, ex64 = s64.prolong_lod_solution().cpu(), exact_field(s64)
    judge = fine_fem_judge(path, s64, card) if bound is None else None
    del s64
    torch.cuda.empty_cache()
    e = rel(ex, ex64)
    print(f"[{path}] prolonged fields, each coarse system solved exactly: "
          f"f32 vs {twin_path} {e:.3e} ("
          + ("not held" if bound is None else f"<= {bound:g}")
          + f"); the steps' own fields "
          f"(coarse CG, reduce {cfg.coarse_solver.reduce:g}, or the direct "
          f"solve): {rel(field, field64):.3e}, each against its exact solve "
          f"f32 {rel(field, ex):.3e}, f64 {rel(field64, ex64):.3e}")
    if bound is not None:
        check(e <= bound, f"{path}: f32 and {twin_path} prolonged fields "
              "disagree")
        return
    rule_path = path + "-f64-f32-rule"
    with f32_spectral_rule():
        sr, paths[rule_path] = run_path(rule_path, dataclasses.replace(
            cfg, dtype="float64", eig_solver="smallk"), timed=0,
            elastic=elastic)
        ex_rule = exact_field(sr)
    del sr
    torch.cuda.empty_cache()
    e_rule = rel(ex, ex_rule)
    print(f"[{path}] prolonged fields, each coarse system solved exactly: "
          f"f32 vs {rule_path} {e_rule:.3e} (<= 1e-2); {rule_path} vs "
          f"{twin_path} {rel(ex_rule, ex64):.3e}")
    check(e_rule <= 1e-2, f"{path}: f32 and {rule_path} prolonged fields "
          "disagree")
    fem_errors(path, paths, judge, {"float32": ex, "float64": ex64,
                                    "float64, float32 rule": ex_rule})


def fine_fem_judge(path, s, card):
    """The float64 fine FEM solution of solver ``s`` (``solve_fine_fem``,
    CG with Jacobi under ``FINE_FEM_CONTROL``), timed, and a function
    that gives a prolonged field's relative L2 and energy errors against
    it (the energy from the fine operator; the Dirichlet data is 0)."""
    import torch
    from dealii_slod_tpu_torch import ReductionControl
    from dealii_slod_tpu_torch.ops.assembly import FineOperator
    from dealii_slod_tpu_torch.utils import errors
    check(s.dtype == torch.float64 and s.cfg.bc == "0",
          f"{path}: the fine FEM comparison needs float64 and bc 0")
    s.cfg = dataclasses.replace(
        s.cfg, fine_solver=ReductionControl(*FINE_FEM_CONTROL))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u = s.solve_fine_fem()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = s.fine_cg
    print(f"[{path}] fine FEM (float64, {s.grid.n_nodes} nodes): CG with "
          f"Jacobi {int(res.n_iter)} it, converged {bool(res.converged)}, "
          f"reduce {FINE_FEM_CONTROL[2]:g}, {wall:.1f} s [{card}]")
    check(bool(res.converged), f"{path}: the fine FEM CG did not converge")
    op = FineOperator(s.et, s.conn, s.coef_q, dirichlet_mask=s.fine_bnd)
    grid, et, conn = s.grid, s.et, s.conn
    l2_u = errors.error_norms(grid, et, conn, u,
                              other=torch.zeros_like(u))["L2"]
    en_u = float((u * op(u)).sum()) ** 0.5

    def judge(field):
        f = field.to(u.device, u.dtype)
        e = f - u
        l2 = errors.error_norms(grid, et, conn, f, other=u)["L2"]
        return l2 / l2_u, float((e * op(e)).sum()) ** 0.5 / en_u

    return judge


def fem_errors(path, paths, judge, fields):
    """Each prolonged field's relative L2 and energy errors against fine
    FEM; which of the float32 and float64 bases is nearer; the float32
    one held to ``R5_F32_FEM_BOUND``."""
    errs = {label: judge(f) for label, f in fields.items()}
    for label, (l2, en) in errs.items():
        print(f"[{path}] {label} basis against fine FEM: relative L2 "
              f"{l2:.4e}, energy {en:.4e}")
    for i, norm in enumerate(("L2", "energy")):
        e32, e64 = errs["float32"][i], errs["float64"][i]
        nearer = "float32" if e32 < e64 else "float64"
        print(f"[{path}] nearer fine FEM in {norm}: the {nearer} basis "
              f"(float32 / float64 error {e32 / e64:.4f})")
        factor = R5_F32_FEM_BOUND
        print(f"[{path}] float32 {norm} error {e32:.4e} <= {factor:g} x "
              f"{e64:.4e} = {factor * e64:.4e}")
        check(e32 <= factor * e64, f"{path}: the float32 basis's "
              f"{norm} error against fine FEM is over its bound")
    paths[path]["fem_errors"] = errs


def first_call_breakdown(card, cfg):
    """r5-diffusion's solver built and stepped once with its parts timed,
    each ending in a device sync, and printed: the constructor (the patch
    table, the window folds, the coefficients at the quadrature points,
    the rest; the StageTimer sections), the kernel library's load, the
    fine rhs, and the first step (canvas tables, per-patch inputs,
    coefficient windows, the chunk loop, the coarse build and its tables,
    the coarse rhs and solve, the rest).  It wraps the port's internal
    names, so it runs only with ``--profile``."""
    import collections

    import torch
    from dealii_slod_tpu_torch import DiffusionProblem, LODSolver
    from dealii_slod_tpu_torch.models import basis, lod, stencil
    from dealii_slod_tpu_torch.models.coarse import CoarseSystem
    from dealii_slod_tpu_torch.utils import kernels
    t_all = time.perf_counter()
    times, saved = collections.defaultdict(float), []

    def timed(label, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.synchronize()
                times[label] += time.perf_counter() - t0
        return call

    problem = DiffusionProblem(cfg)
    targets = [
        (problem, "coefficients", "ctor: coefficients at quadrature points"),
        (lod, "PatchTopology", "ctor: patch table (PatchTopology)"),
        (lod, "clipped_window_index", "ctor: window folds"),
        (LODSolver, "_uniform_tables", "step: canvas tables"),
        (LODSolver, "_uniform_inputs_t", "step: per-patch inputs"),
        (basis, "coef_windows", "step: coefficient windows"),
        (basis, "coef_lattice", "step: coefficient windows"),
        (basis, "window_stack_chunk", "step: coefficient windows"),
        (basis, "uniform_chunk", "step: chunk loop"),
        (LODSolver, "assemble_coarse_operator", "step: coarse build"),
        (stencil, "stencil_tables", "step: coarse build, of it the tables"),
        (CoarseSystem, "solve", "step: coarse rhs and solve")]
    try:
        for obj, attr, label in targets:
            fn = getattr(obj, attr)
            saved.append((obj, attr, fn))
            setattr(obj, attr, timed(label, fn))
        s = timed("ctor", LODSolver)(cfg, problem, verbose=False)
        sections = dict(s.timer.totals)
        kernels._lib = None
        timed("kernel library load", kernels.library)()
        timed("fine rhs", s.assemble_fine_rhs)()
        step = s.build_step()
        timed("first step", step)(s.coef_q, s.fem_rhs)
    finally:
        for obj, attr, fn in reversed(saved):
            setattr(obj, attr, fn)
    del s
    torch.cuda.empty_cache()
    for part, whole in (("ctor", "ctor: "), ("first step", "step: ")):
        times[whole + "rest"] = times[part] - sum(
            v for k, v in list(times.items())
            if k.startswith(whole) and "of it" not in k)
    times.update({f"ctor section {k!r}": v for k, v in sections.items()})
    print(f"[r5-diffusion first call] parts in s (each ends in a device "
          f"sync) [{card}]:")
    for label, v in times.items():
        print(f"[r5-diffusion first call]   {label:48s} {v:8.3f}")
    print(f"[r5-diffusion first call] {time.perf_counter() - t_all:.1f} s")


def phase_scale(card, profile=False):
    """The JAX package's largest configurations through
    ``LODSolver(cfg, problem).build_step()``: refine-5 diffusion and
    elasticity (32768 patches), l = 3 diffusion (4096 patches) and l = 3
    elasticity at refine-3 (512 patches); for each the routes, the stencil
    build the byte rule picks and its wall, the per-chunk coefficient
    windows, and the prolonged field against a float64 twin; the three
    builds on the 4096-patch elasticity basis and the float64 refine-3
    one; the kernel rows at the new shapes and K6's float32 gate on every
    chunk of l3-diffusion; with ``profile``, r5-diffusion's first call
    split into its parts.  Returns (rows, per-path numbers)."""
    import torch
    paths, t_phase, failed = {}, time.perf_counter(), []
    for path, args in scale_paths().items():
        t0 = time.perf_counter()
        try:
            scale_path(card, paths, path, *args)
        except PhaseError as exc:
            # the other paths still run; the phase fails at its end
            print(f"[{path}] FAILED: {exc}")
            failed.append(str(exc))
        torch.cuda.empty_cache()
        print(f"[{path}] {time.perf_counter() - t0:.1f} s")
        if profile and path == "r5-diffusion":
            first_call_breakdown(card, args[0])
    # the builds where the whole one still fits
    for label, cfg, tol in (
            ("elasticity (4096 patches, f32)", elastic_cfg("float32"), 1e-5),
            ("elasticity refine-3 (512 patches, f64)", elastic_cfg(
                "float64", n_global_refinements=3, eig_solver="smallk"),
             1e-12)):
        s = make_solver(cfg, True)
        s.compute_basis()
        s.assemble_coarse_operator()
        try:
            build_variants(label, s, tol, card)
        except PhaseError as exc:
            print(f"[scale] FAILED: {exc}")
            failed.append(str(exc))
        del s
        torch.cuda.empty_cache()
    table = scale_kernel_rows(card)
    t0 = time.perf_counter()
    sg = make_solver(bench_cfg("float64", eig_solver="smallk",
                               oversampling=3), False)
    print("[scale] K6 / K1 / K3 float32 gates on every chunk of "
          "l3-diffusion:")
    f32_gate_all_chunks(sg, sg._uniform_tables(), "K6 spd_multirhs_solve")
    # the card's float32 route: K1 on the whole (2197 -> 2240) block
    f32_gate_all_chunks(sg, sg._uniform_tables(), "K1 fused_spd_multirhs",
                        split=False)
    del sg
    print(f"[scale]   ({time.perf_counter() - t0:.1f} s)")
    print(f"[scale] phase done in {time.perf_counter() - t_phase:.1f} s")
    check(not failed, "; ".join(failed))
    return table, paths


def shard_drive(path, s, step, calls):
    """One rank's share of driving a sharded ``step`` ``calls`` times: the
    ranks start each call together and its wall ends when every rank is
    done; the rank's launch counts are set to 0 just before the first call
    and read just after the last, and must be ``calls`` times what the
    rank's share of the code path implies (``expected_launches`` on the
    patches it built), every kernel of ``PATH_KERNELS[path]`` launched."""
    import torch
    import torch.distributed as dist
    from dealii_slod_tpu_torch.utils import kernels
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    walls = []
    for _ in range(calls):
        dist.barrier()
        t0 = time.perf_counter()
        out = step(s.coef_q, s.fem_rhs)
        torch.cuda.synchronize()
        dist.barrier()
        walls.append(time.perf_counter() - t0)
    counts = dict(kernels.launches)
    expected = {k: v * calls for k, v in expected_launches(s).items()}
    check(counts == expected and all(counts.get(k, 0) > 0
                                     for k in PATH_KERNELS[path]),
          f"{path} rank {dist.get_rank()}: launches {counts}, expected "
          f"{expected}")
    res = s.coarse_cg
    return out, dict(
        counts=counts, walls=walls, rank=dist.get_rank(),
        backend=dist.get_backend(), world=dist.get_world_size(),
        rows=s.basis_patches, halo_bytes=s.halo_bytes,
        peak_bytes=torch.cuda.max_memory_allocated(),
        cg=None if res is None else (int(res.n_iter), bool(res.converged)),
        gather_bytes=s.topo.n_patches * s.C * s.Phi.element_size())


def shard_rank_ws1(timed):
    """World size 1 (NCCL): the main path through ``build_step(
    make_mesh(1))``, then ``build_step()`` in this process; both held."""
    from dealii_slod_tpu_torch.parallel import make_mesh
    from dealii_slod_tpu_torch.parallel.mesh import full_tensor
    s = make_solver(bench_cfg("float32"), False)
    s.assemble_fine_rhs()
    step = s.build_step(make_mesh(1, device="cuda"))
    (u, A_st), nums = shard_drive("shard-main-ws1", s, step, 1 + timed)
    u, A_st = full_tensor(u), full_tensor(A_st)
    u1, A1 = s.build_step()(s.coef_q, s.fem_rhs)
    return dict(nums, e_u=rel(u, u1), e_A=rel(A_st, A1),
                finite=bool(u.isfinite().all() and A_st.isfinite().all()))


def shard_rank_ws2(timed):
    """One of two ranks (gloo, one card): the main and the elasticity
    path through ``build_step(make_mesh(2))`` and the sample-sharded sweep
    on 4 of the Monte-Carlo configuration's fields (MC_* set by the
    caller); rank 0 returns the gathered outputs."""
    import torch
    import torch.distributed as dist
    from dealii_slod_tpu_torch.examples import monte_carlo
    from dealii_slod_tpu_torch.parallel import (make_mesh, stack_fields,
                                                sweep_step)
    from dealii_slod_tpu_torch.parallel.mesh import full_tensor
    from dealii_slod_tpu_torch.utils import kernels
    rank0, out = dist.get_rank() == 0, {}
    for path, cfg, elastic in (
            ("shard-main-ws2", bench_cfg("float32"), False),
            ("shard-elasticity-ws2", elastic_cfg("float32"), True)):
        s = make_solver(cfg, elastic)
        s.assemble_fine_rhs()
        step = s.build_step(make_mesh(2, device="cuda"))
        (u, A_st), nums = shard_drive(path, s, step, 1 + timed)
        u, A_st = full_tensor(u), full_tensor(A_st)
        out[path] = dict(nums, u=u.cpu() if rank0 else None,
                         A_st=A_st.cpu() if rank0 else None,
                         solver_mode=s.solver_mode, spec_mode=s.spec_mode)
        del s, u, A_st
        torch.cuda.empty_cache()
    run = monte_carlo.setup("cuda")
    s = run["solver"]
    batch = stack_fields([run["field"](i + 1) for i in range(4)])
    sweep = sweep_step(s, make_mesh(2, axis="samples", device="cuda"),
                       axis="samples")
    torch.cuda.synchronize()
    dist.barrier()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    u, A_st = sweep(batch, s.fem_rhs)
    torch.cuda.synchronize()
    dist.barrier()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    n_local = u.to_local().shape[0]
    expected = {k: v * n_local for k, v in expected_launches(s).items()}
    check(counts == expected and n_local == 2,
          f"shard-sweep-ws2 rank {dist.get_rank()}: launches {counts}, "
          f"expected {expected} for {n_local} samples")
    u, A_st = full_tensor(u), full_tensor(A_st)
    out["shard-sweep-ws2"] = dict(
        counts=counts, walls=[wall], rank=dist.get_rank(),
        backend=dist.get_backend(), world=2, rows=n_local,
        peak_bytes=torch.cuda.max_memory_allocated(),
        u=u.cpu() if rank0 else None, A_st=A_st.cpu() if rank0 else None)
    return out


def shard_report(path, ranks, card):
    """Print a shard path's numbers, rank by rank; the path's summed
    launches and per-rank figures for the kernels line."""
    walls = ranks[0]["walls"]
    first, steady = walls[0], (min(walls[1:]) if len(walls) > 1 else None)
    print(f"[{path}] {ranks[0]['backend']}, world size {ranks[0]['world']}"
          f" [{card}]: first call {first:.3f} s" + (
              f", steady {steady:.3f} s (calls {walls})" if steady else ""))
    counts = {}
    for r in ranks:
        extra = ""
        if "halo_bytes" in r:
            extra = (f"; halo in {r['halo_bytes']} B; u gathered "
                     f"{r['gather_bytes']} B a coarse matvec; CG {r['cg']}")
        print(f"[{path}]   rank {r['rank']}: {r['rows']} "
              f"{'samples' if 'sweep' in path else 'patches'}; peak "
              f"{r['peak_bytes'] / 2**30:.2f} GiB{extra}; launches "
              f"{r['counts']}")
        for k, v in r["counts"].items():
            counts[k] = counts.get(k, 0) + v
    return dict(counts=counts, first_call_s=first, steady_wall_s=steady)


def phase_shard(card):
    """The scaling axes on the one card (see the module docstring, 15):
    single-card references in this process, then world size 1 over NCCL,
    world size 2 over gloo (main, elasticity, the sample sweep) and
    MC_SHARD=2 through the example; returns the per-path numbers."""
    import numpy as np
    import torch
    from dealii_slod_tpu_torch.examples import monte_carlo
    from dealii_slod_tpu_torch.parallel import stack_fields, sweep_step
    from dealii_slod_tpu_torch.parallel.mesh import spawn
    t_phase = time.perf_counter()
    print(f"[shard] ranks share one card [{card}]: the two-rank walls "
          "measure the cost of the communication (gloo, staged through "
          "host memory where it must be), not scaling")
    mc_env = dict(MC_ENV, MC_SAMPLES="4", MC_FIELD="random")
    refs, single = {}, {}
    for path, cfg, elastic in (
            ("shard-main-ws2", bench_cfg("float32"), False),
            ("shard-elasticity-ws2", elastic_cfg("float32"), True)):
        s = make_solver(cfg, elastic)
        s.assemble_fine_rhs()
        step = s.build_step()
        refs[path] = tuple(v.cpu() for v in step(s.coef_q, s.fem_rhs))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(s.coef_q, s.fem_rhs)
        torch.cuda.synchronize()
        single[path] = time.perf_counter() - t0
        print(f"[{path}] the single-card step in this process: steady "
              f"{single[path]:.3f} s [{card}]")
        del s, step
    run = env_run(lambda: monte_carlo.setup("cuda"), **mc_env)
    batch = stack_fields([run["field"](i + 1) for i in range(4)])
    refs["shard-sweep-ws2"] = tuple(v.cpu() for v in sweep_step(
        run["solver"])(batch, run["solver"].fem_rhs))
    per_sample = expected_launches(run["solver"])
    del run, batch
    torch.cuda.empty_cache()
    print(f"[shard] single-card references in "
          f"{time.perf_counter() - t_phase:.1f} s")

    paths = {}
    t0 = time.perf_counter()
    ws1 = spawn(shard_rank_ws1, 1, "cuda", 1)[0].value
    print(f"[shard-main-ws1] spawn to end {time.perf_counter() - t0:.1f} s;"
          f" sharded vs build_step() in the rank: A_st rel "
          f"{ws1['e_A']:.3e} (<= {SHARD_BOUND['A_st']:g}), u rel "
          f"{ws1['e_u']:.3e} (<= {SHARD_BOUND['u']:g})")
    check(ws1["backend"] == "nccl" and ws1["finite"]
          and ws1["e_A"] <= SHARD_BOUND["A_st"]
          and ws1["e_u"] <= SHARD_BOUND["u"],
          "shard-main-ws1: the world-size-1 step differs from the step")
    paths["shard-main-ws1"] = shard_report("shard-main-ws1", [ws1], card)

    t0 = time.perf_counter()
    ws2 = [r.value for r in env_run(
        lambda: spawn(shard_rank_ws2, 2, "cuda", 1), **mc_env)]
    print(f"[shard] world size 2: spawn to end "
          f"{time.perf_counter() - t0:.1f} s")
    for path in ("shard-main-ws2", "shard-elasticity-ws2",
                 "shard-sweep-ws2"):
        ranks = [r[path] for r in ws2]
        u, A_st = ranks[0]["u"], ranks[0]["A_st"]
        u1, A1 = refs[path]
        e_A, e_u = rel(A_st, A1), rel(u, u1)
        if path == "shard-sweep-ws2":
            e_A = max(rel(A_st[i], A1[i]) for i in range(len(A1)))
            e_u = max(rel(u[i], u1[i]) for i in range(len(u1)))
        paths[path] = shard_report(path, ranks, card)
        print(f"[{path}] gathered on rank 0 vs the single-card step"
              f"{' (each sample)' if 'sweep' in path else ''}: A_st rel "
              f"{e_A:.3e} (<= {SHARD_BOUND['A_st']:g}), u rel {e_u:.3e} "
              f"(<= {SHARD_BOUND['u']:g})")
        check(all(r["backend"] == "gloo" for r in ranks)
              and u.shape == u1.shape and bool(torch.isfinite(u).all())
              and e_A <= SHARD_BOUND["A_st"] and e_u <= SHARD_BOUND["u"],
              f"{path}: the sharded result differs from the single card's")
        check(path == "shard-sweep-ws2" or all(
            r["cg"] is None or r["cg"][1] for r in ranks),
            f"{path}: a rank's coarse CG did not converge")
    el = ws2[0]["shard-elasticity-ws2"]
    check(el["solver_mode"] == "fused" and el["spec_mode"] == "smallk",
          "shard-elasticity-ws2: not K1 on the whole block and smallk")

    t0 = time.perf_counter()
    mc = env_run(lambda: monte_carlo.main([]), **mc_env, MC_SHARD="2")
    wall = time.perf_counter() - t0
    q_ref = refs["shard-sweep-ws2"][0].double().mean(dim=(1, 2)).numpy()
    e_q = float(np.max(np.abs(np.array(mc["qoi"]) - q_ref)
                       / np.abs(q_ref)))
    expected = {k: 2 * 2 * v for k, v in per_sample.items()}
    print(f"[shard-mc] MC_SHARD=2 [{card}]: spawn to end {wall:.1f} s; "
          f"first call {mc['first_s']:.3f} s, batch of 4 {mc['wall']:.3f} "
          f"s; QoIs vs the single-card steps rel {e_q:.3e} (<= "
          f"{SHARD_BOUND['u']:g}); launches by rank {mc['launches']} "
          f"(expected {expected} each: 2 calls of 2 samples)")
    check(e_q <= SHARD_BOUND["u"] and all(
        dict(c) == expected for c in mc["launches"]),
        "shard-mc: MC_SHARD=2's QoIs or launches are off")
    counts = {}
    for c in mc["launches"]:
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    paths["shard-mc"] = dict(counts=counts, first_call_s=mc["first_s"],
                             steady_wall_s=mc["wall"])
    print(f"[shard] phase done in {time.perf_counter() - t_phase:.1f} s")
    return paths


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="also profile one step of the jacobi, main, weig, "
                    "elasticity and reaction paths (torch.profiler) and "
                    "split r5-diffusion's first call into its parts")
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
        if "reaction" in phases:
            rows, more = phase_reaction(card, args.profile)
            table += rows
            paths.update(more)
        if "monte-carlo" in phases:
            paths.update(phase_monte_carlo(card))
        if "scale" in phases:
            rows, more = phase_scale(card, args.profile)
            table += rows
            paths.update(more)
        if "shard" in phases:
            paths.update(phase_shard(card))
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
