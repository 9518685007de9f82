#!/usr/bin/env python3
"""Time the port's patch-solve kernels K1 and K6 through their wrappers, in
float32 and float64, on seeded random SPD blocks at the padded shapes of
the 128-patch chunks (K1 (128, 768, 128); K6 leaves (128, 768, 1856),
(128, 1152, 704), (128, 320, 384)) and two small batches: the shapes and
the dtype that ``chip_smoke.py``'s kernel phases do not time.

    python3 scripts/ldl_bench.py [--root DIRECTORY_IN_THIS_CHECKOUT]

``--root`` names a directory inside this checkout that holds another
commit's ``dealii_slod_tpu_torch`` (unpacked there with ``git archive``),
so two commits can be timed in turns on one card with the same loop.  Only
the wrappers' public functions are called.  Needs an NVIDIA GPU and nvcc;
imports no JAX.  Each line gives the wrapper's time per call (CUDA events,
mean of 5 after one warm-up, operands' padding included), the X error
against a float64 Cholesky solve, and the card's name and power limit.
"""

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 5
SHAPES = [  # (P, n, k, with the triple product)
    (128, 768, 128, True),
    (128, 768, 1856, False),
    (128, 1152, 704, False),
    (128, 320, 384, False),
    (16, 768, 1856, False),
    (4, 768, 128, True),
]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    root = os.path.realpath(ap.parse_args().root)
    if os.path.commonpath([root, HERE]) != HERE:
        print(f"ldl_bench: --root must lie inside {HERE}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("ldl_bench: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    from dealii_slod_tpu_torch.ops import patch_solve as ps
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    tag = os.path.relpath(root, HERE)

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(REPS):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / REPS

    gen = torch.Generator(device="cuda").manual_seed(0)
    for P, n, k, with_T in SHAPES:
        M = torch.randn((P, n, n), generator=gen, device="cuda",
                        dtype=torch.float64)
        A64 = M @ M.mT / n + torch.eye(n, device="cuda", dtype=torch.float64)
        B64 = torch.randn((P, n, k), generator=gen, device="cuda",
                          dtype=torch.float64)
        del M
        ref = torch.cholesky_solve(B64, torch.linalg.cholesky(A64))
        for dt in (torch.float32, torch.float64):
            A, B = A64.to(dt), B64.to(dt)
            if with_T:
                name, fn = "K1", lambda: ps.fused_spd_multirhs(A, B)[0]
            else:
                name, fn = "K6", lambda: ps.spd_multirhs_solve(A, B)
            err = float((fn().double() - ref).abs().max() / ref.abs().max())
            print(f"[ldl_bench {tag}] {name} ({P}, {n}, {k}) "
                  f"{str(dt)[6:]}: {ms(fn):.3f} ms, X err {err:.3e} [{card}]",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
