"""The readings the cell's limits are set from, at the cell's own sizes on
the card (``PERF.md`` gives them with each limit):

- lower: the program's ``field_gap`` from the float64 reference on each
  of ``--seeds`` (the solves a run's check keeps: ``keep`` answers, here
  solves 0 .. keep-1 of each seed), the solver set up once;
- upper: the control's on each of ``--control-seeds``: the reference put
  in the program's place and computed in the next precision down from the
  configuration's float32 with TF32 off, which is float32 with TF32 on.
  ``--variants float32 control`` adds the reference's own float32 (TF32
  off) beside it: the control's gap has to come from TF32.

    python3 slodbench/control.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 7 8 9 [--variants float32 control]

One JSON object a reading on standard output."""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


# the reference in float32: tf32 off (the configuration's own type) and
# on (the control)
VARIANTS = {"float32": False, "control": True}


def program_gaps(spec, conf, seeds, device):
    """The program's field_gap on each seed, one solver for all."""
    import harness
    import torch
    mix, keep, bench = spec["stream"], spec["limits"]["keep"], spec["bench"]
    dtype = harness.dtype_of(conf)
    device = torch.device(device)
    solver = harness.make_solver(conf, device, bench)
    for seed in seeds:
        inputs = harness.Inputs(conf, seed, device, dtype, bench)
        stream = mix.Stream(solver, inputs)
        answers = []
        for i in range(keep):
            answers.append((i, stream.solve(mix.draw(inputs, i)).cpu()))
        harness.sync(device)
        refs = harness.reference_fields(conf, inputs, mix,
                                        [i for i, _ in answers], device,
                                        bench=bench)
        for (i, u), v in zip(answers, refs):
            yield dict(side="program", seed=seed, solve=i,
                       field_gap=harness.gap(u, v))
        del refs, stream
        torch.cuda.empty_cache()


def control_gaps(spec, conf, seeds, device, variants=("control",)):
    """The reference in float32 against the reference in float64, on
    the first two solves of each seed, one reading per variant."""
    import harness
    mix, keep, bench = spec["stream"], spec["limits"]["keep"], spec["bench"]
    dtype = harness.dtype_of(conf)
    for seed in seeds:
        inputs = harness.Inputs(conf, seed, device, dtype, bench)
        idx = list(range(min(keep, 2)))
        refs = harness.reference_fields(conf, inputs, mix, idx, device,
                                        bench=bench)
        for name in variants:
            low = harness.reference_fields(conf, inputs, mix, idx, device,
                                           dtype=dtype, tf32=VARIANTS[name],
                                           bench=bench)
            for i, u, v in zip(idx, low, refs):
                yield dict(side=name, seed=seed, solve=i,
                           field_gap=harness.gap(u, v))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--variants", nargs="*", default=["control"],
                    choices=sorted(VARIANTS))
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, HERE]
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    import harness
    spec = harness.resolve(args.workload)
    conf = spec["config"]
    t0 = time.perf_counter()
    for r in control_gaps(spec, conf, args.control_seeds, "cuda",
                          args.variants):
        print(json.dumps(dict(r, cell=args.workload,
                              t=time.perf_counter() - t0)), flush=True)
    for r in program_gaps(spec, conf, args.seeds, "cuda"):
        print(json.dumps(dict(r, cell=args.workload,
                              t=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
