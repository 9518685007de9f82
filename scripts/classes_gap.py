"""The gap between the port's classes route (``kernel_mode="classes"``)
and its uniform default route on the CPU, float64, at the configuration
that ``chip_smoke.py``'s ``routes`` phase holds the two to on the card:
3D refine-3 l=2 (512 patches), SLOD and plain LOD on the random field, and
SLOD on a constant field (the uniform route deduped).  Prints the largest
absolute Phi and APhi differences of each; the card's bound is 10x the
Phi gap where that exceeds ``tests/test_uniform.py``'s 3e-7 (SLOD) /
1e-11 (plain LOD) (``chip_smoke.py: CLASSES_BOUND``).

    python scripts/classes_gap.py [--chunk 32] [--threads 4]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    import torch
    torch.set_num_threads(args.threads)
    from chip_smoke import CLASSES_CASES, bench_cfg, make_solver
    for name, kw in CLASSES_CASES.items():
        out = {}
        for mode in ("classes", "uniform"):
            t0 = time.perf_counter()
            s = make_solver(bench_cfg("float64", n_global_refinements=3,
                                      patch_chunk=args.chunk,
                                      kernel_mode=mode, **kw), False,
                            device="cpu")
            out[mode] = s.compute_basis()
            print(f"{name} {mode}: {s.basis_patches} patches built in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        gaps = [float((a - b).abs().max())
                for a, b in zip(out["classes"], out["uniform"])]
        print(f"{name}: classes vs uniform on the CPU: Phi {gaps[0]:.3e}, "
              f"APhi {gaps[1]:.3e}", flush=True)


if __name__ == "__main__":
    main()
