#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``dealii_slod_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

Phases (each prints its numbers; any failure exits non-zero):

1. device: torch's device name and nvidia-smi's name / power limit;
2. build: nvcc builds ``dealii_slod_tpu_torch/csrc`` (timed);
3. kernels: K1, K2, K3, K5 against their plain PyTorch versions on one
   128-patch chunk of the main-path configuration (real assembled
   operators), in float64 (relative max error <= 1e-10) and float32
   (error against the f64 plain version <= 4x the f32 plain version's
   own error + 1e-6), each timed with CUDA events beside its plain
   version;
4. e2e-f64: the small 3D refine-2, l=1 step in float64 on the CPU (plain
   versions) and on the card (kernels): u and the prolonged field agree
   to 1e-8 relative;
5. main: the main-path step (3D, 16^3 coarse cells = 4096 patches, l=2,
   s=2, coef_refinement=5, float32, chunks of 128) through the kernels:
   one first call and 2 timed calls, every kernel launched, finite
   non-zero u, converged CG; then once in float64, prolonged fields
   within 1e-2.

The second-to-last line is the JSON kernel table, the last line
``{"ok": true, "device": {...}}``.  No JAX is imported.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "kernels", "e2e-f64", "main")
SOURCE = {
    "K1 fused_spd_multirhs": ("dealii_slod_tpu_torch/csrc/patch_solve.cu",
                              "dealii_slod_tpu/ops/patch_solve.py:894"),
    "K2 gj_inverse": ("dealii_slod_tpu_torch/csrc/patch_solve.cu",
                      "dealii_slod_tpu/ops/patch_solve.py:474"),
    "K3 stencil_trace": ("dealii_slod_tpu_torch/csrc/stencil_trace.cu",
                         "dealii_slod_tpu/ops/assembly.py:409"),
    "K5 jacobi_eigh": ("dealii_slod_tpu_torch/csrc/jacobi_eigh.cu",
                       "dealii_slod_tpu/ops/eig.py:408"),
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
    from dealii_slod_tpu_torch import ReductionControl, SLODConfig
    base = dict(dim=3, n_global_refinements=4, n_subdivisions=2,
                oversampling=2, lod_stabilization=True,
                constant_coefficients=False, coef_seed=0, coef_refinement=5,
                rhs="1", bc="0", dtype=dtype, patch_chunk=128,
                solve_fine_problem=False,
                coarse_solver=ReductionControl(500, 1e-6, 1e-6),
                eig_solver="jacobi", patch_solver="fused",
                trace_kernel="on", eig_sweeps=12, eig_tol=3e-6)
    base.update(kw)
    return SLODConfig(**base)


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

def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(f"[device] torch: {name}; count {torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi.stdout.strip().splitlines()[0])
    return name


def phase_build():
    from dealii_slod_tpu_torch.utils import kernels
    t0 = time.perf_counter()
    path = kernels.library()._name
    dt = time.perf_counter() - t0
    print(f"[build] {dt:.2f} s  {os.path.relpath(path, HERE)}")


def chunk_inputs(dtype_name, chunk=128):
    """Real main-path operators of the first chunk of patches."""
    import torch
    from dealii_slod_tpu_torch import DiffusionProblem, LODSolver
    from dealii_slod_tpu_torch.models import basis
    cfg = bench_cfg(dtype_name)
    s = LODSolver(cfg, DiffusionProblem(cfg), device="cuda", verbose=False)
    tab = s._uniform_tables()
    _, nlo, nhi, sides = s._uniform_inputs()
    cw = basis.coef_windows(cfg, s.grid, s.coef_q["alpha"])[:chunk]
    lo = torch.as_tensor(nlo[:chunk], device="cuda")
    hi = torch.as_tensor(nhi[:chunk], device="cuda")
    sd = torch.as_tensor(sides[:chunk], device="cuda")
    return s, tab, cw, lo, hi, sd


def phase_kernels():
    """Each kernel against its plain version at the main-path shapes."""
    import torch
    from dealii_slod_tpu_torch.models import basis
    from dealii_slod_tpu_torch.ops import assembly, eig, patch_solve

    s, tab, cw, lo, hi, sd = chunk_inputs("float64")
    band, A, PT_m, cvd = basis.prep(tab, cw, lo, hi)
    X64, Traw = patch_solve.fused_spd_multirhs_plain(A, PT_m)
    T = Traw / tab.Hdim + torch.diag_embed(1.0 - cvd)
    Tinv = patch_solve.gj_inverse_plain(T)
    Xz = basis.scatter_interior(tab, X64)
    Xp = torch.nn.functional.pad(Xz, (0, 0, tab.shiftN, tab.shiftN))[:, None]
    S99, is99d = basis.trace_S_chunk(tab, band, X64, lo, hi, sd)
    G, _ = basis.finish_pre_from_S(tab, S99, Tinv, cvd, is99d)
    G = G[:, 0]
    dmax = torch.diagonal(G, dim1=-2, dim2=-1).abs().amax(-1, keepdim=True)
    eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)

    def factor_rows(dt):
        jit = 1e-13 if dt == torch.float64 else 1e-6
        Gd = G.to(dt)
        L = torch.linalg.cholesky(Gd + (jit * dmax.to(dt))[..., None]
                                  * eye.to(dt))
        n0 = L.shape[-1]
        Gp = L.new_zeros((L.shape[0], n0 + n0 % 2, n0 + n0 % 2))
        Gp[:, :n0, :n0] = L.mT
        return Gp

    def k5(Gp, kernel):
        # (B, 126, 126) padded factor rows -> sorted eigenvalues, vectors
        if kernel:
            XT, XB = eig._jacobi_rows_cuda(Gp, tab.sweeps, tab.eig_tol,
                                           eig._default_null_rel(Gp.dtype))
        else:
            XT, XB = eig.jacobi_rows_plain(Gp, tab.sweeps, 1, tab.eig_tol,
                                           eig._default_null_rel(Gp.dtype))
        return eig._finalize_rows(XT, XB, tab.cD, (Gp.shape[0],))

    def k5_err(out, ref):
        """Eigenvalue error relative to lambda_max, and the eigenvector
        error of eigenpairs separated from their neighbours by more than
        1e-6 (f64) / 1e-2 (f32) of lambda_max: vectors of tighter clusters
        are determined only up to a rotation within the cluster, which
        rounding picks."""
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

    cases = {
        "K1 fused_spd_multirhs": (
            lambda dt: (A.to(dt), PT_m.to(dt)),
            lambda a, b: patch_solve.fused_spd_multirhs(a, b),
            lambda a, b: patch_solve.fused_spd_multirhs_plain(a, b),
            lambda o, r: max(rel(o[0], r[0]), rel(o[1], r[1]))),
        "K2 gj_inverse": (
            lambda dt: (T.to(dt),),
            patch_solve.gj_inverse, patch_solve.gj_inverse_plain, rel),
        "K3 stencil_trace": (
            lambda dt: (band.to(dt), Xp.to(dt).contiguous()),
            lambda b, x: assembly.stencil_trace(b, x, tab.shiftN,
                                                tab.offs_flat),
            lambda b, x: assembly.stencil_trace_plain(b, x, tab.shiftN,
                                                      tab.offs_flat),
            rel),
        "K5 jacobi_eigh": (
            lambda dt: (factor_rows(dt),),
            lambda g: k5(g, True), lambda g: k5(g, False), k5_err),
    }
    table = []
    for name, (make, kern, plain, err) in cases.items():
        args64, args32 = make(torch.float64), make(torch.float32)
        ref = plain(*args64)
        e64 = err(kern(*args64), ref)
        out32 = kern(*args32)
        e32 = err(out32, ref)
        base32 = err(plain(*args32), ref)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: kern(*args32))
        plain_ms = cuda_ms(lambda: plain(*args32))
        o32 = out32[0] if isinstance(out32, tuple) else out32
        r64 = ref[0] if isinstance(ref, tuple) else ref
        abs_err = float((o32.double() - r64.double()).abs().max())
        ok64, ok32 = e64 <= 1e-10, e32 <= 4 * base32 + 1e-6
        print(f"[kernels] {name}: f64 err {e64:.3e} (<= 1e-10: {ok64}); "
              f"f32 err {e32:.3e} vs plain-f32 {base32:.3e} "
              f"(bound {4 * base32 + 1e-6:.3e}: {ok32}); "
              f"{ms:.3f} ms vs plain {plain_ms:.3f} ms (f32, B=128)")
        check(ok64 and ok32, f"{name} disagrees with its plain version")
        src, rep = SOURCE[name]
        table.append(dict(name=name, route="cuda", source=src, replaces=rep,
                          max_abs_err=abs_err, ms=ms, plain_ms=plain_ms))
    return table


def phase_e2e_f64():
    import torch
    from dealii_slod_tpu_torch import (DiffusionProblem, LODSolver,
                                       ReductionControl)
    cfg = bench_cfg("float64", n_global_refinements=2, oversampling=1,
                    coef_refinement=3, patch_chunk=32,
                    coarse_solver=ReductionControl(200, 1e-12, 1e-12))
    out = {}
    for dev in ("cpu", "cuda"):
        # eig_block=1: the plain Jacobi stops each matrix on its own, as
        # the kernel does
        s = LODSolver(cfg, DiffusionProblem(cfg), device=dev, verbose=False,
                      eig_block=1)
        s.assemble_fine_rhs()
        u, _ = s.build_step()(s.coef_q, s.fem_rhs)
        out[dev] = (u.cpu(), s.prolong_lod_solution().cpu())
    e_u = rel(out["cuda"][0], out["cpu"][0])
    e_f = rel(out["cuda"][1], out["cpu"][1])
    print(f"[e2e-f64] 3D refine-2 l=1 (64 patches): u rel diff {e_u:.3e}, "
          f"prolonged rel diff {e_f:.3e} (<= 1e-8)")
    check(e_u <= 1e-8 and e_f <= 1e-8, "CPU and CUDA steps disagree")


def profile_step(step, s):
    """One more main-path step under torch.profiler: the device-busy share
    of its wall and the op table, sorted by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(s.coef_q, s.fem_rhs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    busy = sum(dev_us(e) for e in ka) / 1e6
    print(ka.table(sort_by="self_cuda_time_total", row_limit=30))
    top = sorted(ka, key=dev_us, reverse=True)[:8]
    print(f"[profile] wall {wall:.3f} s under the profiler; device busy "
          f"{busy:.3f} s ({100 * busy / wall:.1f}%); top: " + "; ".join(
              f"{e.key[:40]} {dev_us(e) / 1e3:.1f} ms x{e.count}"
              for e in top))


def phase_main(profile=False):
    import torch
    from dealii_slod_tpu_torch import DiffusionProblem, LODSolver
    from dealii_slod_tpu_torch.utils import kernels

    cfg = bench_cfg("float32")
    s = LODSolver(cfg, DiffusionProblem(cfg), device="cuda", verbose=False)
    P = s.topo.n_patches
    s.assemble_fine_rhs()
    step = s.build_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    u, _ = step(s.coef_q, s.fem_rhs)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        u, _ = step(s.coef_q, s.fem_rhs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    counts = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    wall = min(walls)
    res = s.coarse_cg
    print(f"[main] {P} patches f32: {P / wall:.1f} patches/s; first call "
          f"{first:.3f} s; steady wall {wall:.3f} s (calls {walls}); peak "
          f"{peak / 2**30:.2f} GiB; CG {int(res.n_iter)} it converged "
          f"{bool(res.converged)}; launches {counts}")
    check(all(counts.get(k, 0) > 0 for k in SOURCE),
          f"a kernel of the path was not launched: {counts}")
    check(bool(torch.isfinite(u).all()) and float(u.abs().max()) > 0,
          "main-path u is not finite and non-zero")
    check(bool(res.converged), "coarse CG did not converge")
    f32 = s.prolong_lod_solution().double().cpu()
    if profile:
        profile_step(step, s)

    cfg64 = bench_cfg("float64")
    s64 = LODSolver(cfg64, DiffusionProblem(cfg64), device="cuda",
                    verbose=False)
    s64.assemble_fine_rhs()
    t0 = time.perf_counter()
    s64.build_step()(s64.coef_q, s64.fem_rhs)
    torch.cuda.synchronize()
    t64 = time.perf_counter() - t0
    f64 = s64.prolong_lod_solution().cpu()
    e = rel(f32, f64)
    print(f"[main] f64 step {t64:.3f} s, CG {int(s64.coarse_cg.n_iter)} it; "
          f"prolonged f32 vs f64 rel max diff {e:.3e} (<= 1e-2)")
    check(e <= 1e-2, "f32 and f64 prolonged fields disagree")
    return counts, dict(patches_per_s=P / wall, first_call_s=first,
                        steady_wall_s=wall, peak_bytes=peak)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="also profile one main-path step (torch.profiler)")
    args = ap.parse_args()
    phases = args.phases.split(",")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "dealii_slod_tpu_torch")):
        print("chip_smoke: the port package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name, table, counts = None, [], {}
    try:
        name = phase_device()
        if "build" in phases:
            phase_build()
        if "kernels" in phases:
            table = phase_kernels()
        if "e2e-f64" in phases:
            phase_e2e_f64()
        if "main" in phases:
            counts, _ = phase_main(args.profile)
    except Exception as exc:                     # any phase failure
        print(f"chip_smoke: FAILED: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        import traceback
        traceback.print_exc()
        return 1
    for row in table:
        row["launches"] = counts.get(row["name"], 0)
    print(json.dumps({"kernels": [
        {k: row[k] for k in ("name", "route", "source", "replaces",
                             "launches", "max_abs_err", "ms", "plain_ms")}
        for row in table]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
