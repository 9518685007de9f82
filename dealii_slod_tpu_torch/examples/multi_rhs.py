"""Serving-style workflow: build the SLOD basis ONCE, then answer many
right-hand sides at coarse-solve latency (counterpart of
``examples/multi_rhs.py``).

The expensive stage is basis construction (patch solves + stabilization).
The coarse operator and the basis canvases are plain tensors afterwards, so
each new load case costs one (C^T f -> coarse solve) pass, and with
``utils.checkpoint`` the basis survives process restarts, so a serving
process can answer load cases without ever re-running the basis stage.

    python -m dealii_slod_tpu_torch.examples.multi_rhs            # the card
    MR_DIM=3 MR_REFINE=4 python -m dealii_slod_tpu_torch.examples.multi_rhs
    python -m dealii_slod_tpu_torch.examples.multi_rhs --device cpu

Environment: MR_DIM (2), MR_REFINE (4), MR_RHS (16 load cases), MR_DTYPE
(float32 on the card, float64 on the CPU), MR_COARSE ("direct" when the
system fits ``coarse_dense_cap``, else "cg").
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def serve_fn(solver, mode):
    """fem load vector (n_nodes, C) -> coarse solution (P, C): C^T f over
    the rhs's canvas windows, then the direct solve (its Cholesky factor
    made here, once) or the coarse CG."""
    from dealii_slod_tpu_torch.models import basis
    from dealii_slod_tpu_torch.models.lod import full_f32_matmuls

    cfg = solver.cfg
    if mode == "direct":
        solve = solver._coarse_direct_fn(solver.A_stencil)
    else:
        def solve(rhs_c):
            return solver._coarse_cg(solver.A_stencil, rhs_c).x

    def serve(fem_rhs):
        with full_f32_matmuls():
            f_at = basis.rhs_windows(cfg, solver.grid, fem_rhs)
            return solve(torch.einsum("pncd,pnc->pd", solver.Phi, f_at))

    return serve


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="torch device to run on (default: the card)")
    args = ap.parse_args(argv)
    from dealii_slod_tpu_torch import (DiffusionProblem, LODSolver,
                                       ReductionControl, SLODConfig)

    dim = int(os.environ.get("MR_DIM", 2))
    refine = int(os.environ.get("MR_REFINE", 4))
    n_rhs = int(os.environ.get("MR_RHS", 16))
    dtype = os.environ.get("MR_DTYPE", "float64" if args.device == "cpu"
                           else "float32")
    dev = torch.device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cfg = SLODConfig(
        dim=dim, n_global_refinements=refine, n_subdivisions=2,
        oversampling=2, lod_stabilization=True,
        constant_coefficients=False, coef_seed=0, coef_refinement=4,
        rhs="1", bc="0", dtype=dtype, solve_fine_problem=False,
        coarse_solver=ReductionControl(500, 1e-8, 1e-8))
    solver = LODSolver(cfg, DiffusionProblem(cfg), device=dev,
                       verbose=False)

    t0 = time.perf_counter()
    solver.compute_basis()
    solver.assemble_coarse_operator()
    sync()
    t_basis = time.perf_counter() - t0
    P = solver.topo.n_patches

    fits_cap = P * solver.C <= cfg.coarse_dense_cap
    mode = os.environ.get("MR_COARSE", "direct" if fits_cap else "cg")
    if mode == "direct" and not fits_cap:
        # the library's own direct path refuses above the cap (an uncapped
        # dense factor is a multi-GB allocation); mirror that here
        print(f"MR_COARSE=direct: {P * solver.C} coarse dofs exceed "
              f"coarse_dense_cap={cfg.coarse_dense_cap}; using cg")
        mode = "cg"
    serve = serve_fn(solver, mode)

    rng = np.random.default_rng(0)
    n_nodes = solver.grid.n_nodes
    loads = [torch.as_tensor(rng.standard_normal((n_nodes, 1)),
                             dtype=solver.dtype, device=dev)
             for _ in range(n_rhs + 1)]
    solutions = [serve(loads[0])]
    float(solutions[0].sum())                   # first call + fetch
    walls = []
    for f in loads[1:]:
        t0 = time.perf_counter()
        u = serve(f)
        float(u.sum())                          # syncs the card
        walls.append(time.perf_counter() - t0)
        solutions.append(u)

    print(f"config: dim={dim} refine={refine} patches={P} coarse={mode} "
          f"device={dev.type} dtype={dtype}")
    print(f"basis + operator (once): {t_basis:.2f} s")
    print(f"serve latency per rhs: median {np.median(walls) * 1e3:.1f} ms "
          f"(min {min(walls) * 1e3:.1f}) over {n_rhs} load cases "
          f"-> {t_basis / np.median(walls):.0f}x cheaper than rebuilding")
    return dict(solutions=solutions, mode=mode, basis_s=t_basis,
                serve_s=walls)


if __name__ == "__main__":
    main()
