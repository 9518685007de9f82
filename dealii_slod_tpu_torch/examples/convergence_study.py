"""Convergence study: LOD / SLOD / FEM errors over mesh refinement
(counterpart of ``examples/convergence_study.py``).

Reproduces the reference's intended workflow (the five
ParsedConvergenceTables accumulated over runs, include/LOD.h:111-115):
runs the pipeline over a sequence of refinements and prints multi-row
convergence tables with observed rates, and each run's basis time.

    python -m dealii_slod_tpu_torch.examples.convergence_study --dim 2
    python -m dealii_slod_tpu_torch.examples.convergence_study --device cpu

The run goes on the card in float32 unless ``--device cpu`` is given (then
float64).  By default oversampling scales with refinement (l = refine - 1 ~
log N, the coupling the LOD theory requires) and the SLOD-stabilized basis
is used; pin --oversampling L / pass --no-stabilization to reproduce
fixed-l localization decay instead (at fixed l the LOD-vs-FEMh tables
rightly diverge under refinement; that is the method, not a bug).
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--dim", type=int, default=2)
    p.add_argument("--refinements", type=int, nargs="+", default=[2, 3, 4])
    p.add_argument("--subdivisions", type=int, default=2)
    p.add_argument("--oversampling", type=int, default=None,
                   help="fixed oversampling l; default scales l = refine-1 "
                        "(the l ~ log N the method needs: at FIXED l the "
                        "e^{-cl} localization error dominates under mesh "
                        "refinement and the LOD tables rightly diverge)")
    p.add_argument("--no-stabilization", dest="slod", action="store_false",
                   help="plain LOD candidates (default runs the SLOD "
                        "stabilized basis, the reference's production path)")
    p.add_argument("--elasticity", action="store_true")
    p.add_argument("--random-coefficients", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device to run on (default: the card)")
    return p


def study(args) -> tuple:
    """Run the pipeline at each refinement -> (the multi-row tables by
    result key, the basis stage's wall in seconds by refinement)."""
    from dealii_slod_tpu_torch import (DiffusionProblem, ElasticityProblem,
                                       LODSolver, ReductionControl,
                                       SLODConfig)
    from dealii_slod_tpu_torch.utils.errors import ConvergenceTable

    if args.dim == 2:
        exact = "sin(pi*x)*sin(pi*y)"
        rhs = "2*pi^2*sin(pi*x)*sin(pi*y)"
    else:
        exact = "sin(pi*x)*sin(pi*y)*sin(pi*z)"
        rhs = "3*pi^2*sin(pi*x)*sin(pi*y)*sin(pi*z)"
    if args.elasticity:
        rhs = "; ".join([rhs] * args.dim)
        exact = "0"

    tables, basis_s = {}, {}
    for r in args.refinements:
        cfg = SLODConfig(
            dim=args.dim, n_global_refinements=r,
            n_subdivisions=args.subdivisions,
            oversampling=(args.oversampling if args.oversampling
                          else max(1, r - 1)),
            lod_stabilization=args.slod,
            constant_coefficients=not args.random_coefficients,
            rhs=rhs, exact_solution=exact, bc="0",
            dtype="float64" if args.device == "cpu" else "float32",
            coarse_solver=ReductionControl(2000, 1e-13, 1e-12),
            fine_solver=ReductionControl(4000, 1e-11, 1e-11),
        )
        prob = (ElasticityProblem(cfg) if args.elasticity
                else DiffusionProblem(cfg))
        s = LODSolver(cfg, prob, device=args.device, verbose=False)
        res = s.run()
        basis_s[r] = s.timer.totals["2: compute basis functions"]
        for key, t in res.items():
            if not key.startswith("error_"):
                continue
            tables.setdefault(key, ConvergenceTable(t.label, dim=args.dim))
            tables[key].rows.extend(t.rows)
    return tables, basis_s


def main(argv=None):
    args = build_parser().parse_args(argv)
    tables, basis_s = study(args)
    for key, t in tables.items():
        print(f"\n== {key} ==")
        print(t)  # multi-row tables print per-norm rate columns
    print("\nbasis time (s) by refinement: "
          + ", ".join(f"{r}: {t:.3f}" for r, t in basis_s.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
