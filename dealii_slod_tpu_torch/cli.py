"""Command-line applications of the port: ``diffusion``, ``elasticity`` and
``reaction`` (reaction-diffusion, beyond the reference set; counterpart of
``dealii_slod_tpu/cli.py``).

One executable per problem family, taking an optional ``.prm`` parameter
file; a first run with a missing parameter file writes the defaults.  The
run goes on the card unless ``--device cpu`` is given.

Usage:
    python -m dealii_slod_tpu_torch.cli diffusion  [parameters.prm] [options]
    python -m dealii_slod_tpu_torch.cli elasticity [parameters.prm] [options]
    python -m dealii_slod_tpu_torch.cli reaction   [parameters.prm] [options]
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dealii_slod_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("problem",
                   choices=["diffusion", "elasticity", "reaction"])
    p.add_argument("prm", nargs="?", default="parameters.prm",
                   help="deal.II-style parameter file (created with defaults "
                        "if missing, like the reference apps)")
    p.add_argument("--dim", type=int, default=2, choices=[2, 3],
                   help="mesh dimension (the reference supports 2 only)")
    p.add_argument("--dtype", default=None, choices=["float32", "float64"],
                   help="compute dtype (default: float64 on the CPU, "
                        "float32 on the card)")
    p.add_argument("--chunk", type=int, default=None,
                   help="patches per chunk")
    p.add_argument("--no-output", action="store_true",
                   help="skip VTU fields + used-parameters dump (the "
                        "reference apps always write output; this is an "
                        "opt-out for benchmarking)")
    p.add_argument("--reference-parity", action="store_true",
                   help="bit-mirror the reference coefficient sampling "
                        "(glibc rand) and cache semantics")
    p.add_argument("--no-fine-solve", action="store_true",
                   help="skip the fine reference FEM solve")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device to run on (default: the card)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from dealii_slod_tpu_torch.config import SLODConfig

    dtype = args.dtype or ("float64" if args.device == "cpu"
                           else "float32")
    overrides = dict(dim=args.dim, dtype=dtype,
                     write_output=not args.no_output)
    if args.chunk is not None:
        overrides["patch_chunk"] = args.chunk
    if args.reference_parity:
        overrides["reference_parity"] = True
    if args.no_fine_solve:
        overrides["solve_fine_problem"] = False

    if not os.path.exists(args.prm):
        # first run creates the parameter file (reference README:3)
        cfg = SLODConfig(**overrides)
        with open(args.prm, "w") as f:
            f.write(cfg.to_prm())
        print(f"Wrote default parameter file {args.prm}; running with "
              "defaults.")
    else:
        cfg = SLODConfig.from_prm(args.prm, **overrides)

    from dealii_slod_tpu_torch.models import (DiffusionProblem,
                                              ElasticityProblem, LODSolver,
                                              ReactionDiffusionProblem)

    try:
        prob = {"diffusion": DiffusionProblem,
                "elasticity": ElasticityProblem,
                "reaction": ReactionDiffusionProblem}[args.problem](cfg)
        LODSolver(cfg, prob, device=args.device, verbose=True).run()
    except Exception as exc:  # mirror the reference's exception report
        print("----------------------------------------------------",
              file=sys.stderr)
        print(f"Exception on processing: {exc}\nAborting!", file=sys.stderr)
        print("----------------------------------------------------",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
