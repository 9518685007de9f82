"""The benchmark of ``dealii_slod_tpu_torch`` on one NVIDIA card.

    python3 slodbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` once and prints, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``compared``: each number held to the plain reference, with its limit.
Without a CUDA card it exits non-zero and prints no result."""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # caches of anything that compiles stay inside the checkout
    cache = os.path.join(ROOT, ".slodbench_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    sys.path[:0] = [ROOT, HERE]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("slodbench: no CUDA card; the benchmark runs only on one",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    import harness
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", t_process=T_PROCESS)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
