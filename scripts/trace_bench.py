#!/usr/bin/env python3
"""Time variants of the stencil-trace kernel (K3 at C = 1, K7 at C = 3,
``dealii_slod_tpu_torch/csrc/stencil_trace.cu``) at the 128-patch chunk
shapes of the main path (band (128, 1331, 27), Xp (128, 1, 1597, 125)) and
of elasticity (band (128, 1331, 243), Xp (128, 3, 1597, 375)), float32 and
float64, on seeded random operands.

    python3 scripts/trace_bench.py [VARIANT ...]

A variant is ``R:J:WARPS:MIN_BLOCKS`` (the tile of ``Tile<T, C>``, the
same for every C; J is float32's, float64 keeps J = 2) or ``shipped`` (the
source as it is), optionally followed by ``/copies`` (the stages' copies
and waits without the FMAs) or ``/fmas`` (the FMAs on unfilled stages,
without the copies): the two halves of the kernel's time.  Each variant is
a patched copy of the source built with the port's nvcc flags into
``dealii_slod_tpu_torch/_build/trace_bench/`` (all builds in parallel),
loaded with ctypes and timed in its own process (CUDA events over 10 calls
queued behind a spin kernel, after one warm-up).  A full variant's result
is held against the float64 plain version on 4 patches.  Needs an NVIDIA
GPU and nvcc; imports no JAX.  Default: ``shipped shipped/copies
shipped/fmas``.
"""

import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(HERE, "dealii_slod_tpu_torch", "csrc")
OUT = os.path.join(HERE, "dealii_slod_tpu_torch", "_build", "trace_bench")
TILE = re.compile(r"(struct Tile \{\n).*?(\n\};)", re.S)
MODES = {   # source edits of each mode
    "copies": [("for (int u = 0; u < 3; ++u) triple(t0 + u);",
                "for (int u = 0; u < 3 && k < 0; ++u) triple(t0 + u);"),
               ("for (int t = t0; t < t1; ++t) triple(t);",
                "for (int t = t0; t < t1 && k < 0; ++t) triple(t);")],
    "fmas": [("mbar_arrive_tx(&bar[s % NBUF], n_bulk * ROW_BYTES);",
              "mbar_arrive_tx(&bar[s % NBUF], 0);"),
             ("      if (row < n_bulk) {", "      if (row < 0) {"),
             ("      } else if (n0 + lo + row < nNp) {",
              "      } else if (row < 0) {"),
             ("for (int i = warp; i < TN; i += WARPS) {",
              "for (int i = warp; i < 0; i += WARPS) {")],
}


def variant_source(name):
    with open(os.path.join(SRC, "stencil_trace.cu")) as fh:
        src = fh.read()
    tile, _, mode = name.partition("/")
    if tile != "shipped":
        R, J, W, M = tile.split(":")
        body = (f"  static constexpr int R = {R}, "
                f"J = sizeof(T) == 4 ? {J} : 2;\n  static constexpr int "
                f"WARPS = {W}, MIN_BLOCKS = {M};")
        src, n = TILE.subn(lambda m: m.group(1) + body + m.group(2), src)
        assert n == 1, "struct Tile not found"
    for old, new in MODES.get(mode, []):
        assert old in src, f"{mode}: {old!r} not in the source"
        src = src.replace(old, new)
    return src


def build(names):
    sys.path.insert(0, HERE)
    from dealii_slod_tpu_torch.utils import kernels
    nvcc, procs = kernels._find_nvcc(), {}
    for name in names:
        d = os.path.join(OUT, name.replace(":", "_").replace("/", "-"))
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "stencil_trace.cu"), "w") as fh:
            fh.write(variant_source(name))
        cmd = [nvcc, *kernels.NVCC_FLAGS, f"-I{SRC}", "-shared", "-o",
               os.path.join(d, "lib.so"), os.path.join(d, "stencil_trace.cu"),
               os.path.join(SRC, "common.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    built = {}
    for name, (d, p) in procs.items():
        out = p.communicate()[0]
        regs = re.findall(r"Used (\d+) registers, used 1 barriers", out)
        print(f"[trace_bench] {name}: build rc {p.returncode}, trace_tiled "
              f"registers {regs}", flush=True)
        if p.returncode:
            print(out[-2000:])
        else:
            built[name] = os.path.join(d, "lib.so")
    return built


def run(name, lib_path):
    import numpy as np
    import torch
    sys.path.insert(0, HERE)
    from dealii_slod_tpu_torch.grid import cartesian_coords
    from dealii_slod_tpu_torch.ops import assembly
    lib = ctypes.CDLL(lib_path)
    dims = np.full(3, 11)
    strides = np.concatenate([[1], np.cumprod(dims[:-1])])
    offs0 = [int(o) for o in (cartesian_coords(np.full(3, 3)) - 1) @ strides]
    shiftN, nN = int(strides.sum()), int(dims.prod())
    offs = np.asarray([o + shiftN for o in offs0], np.int32)
    g = torch.Generator(device="cuda").manual_seed(0)
    for C, k, dt in ((1, 125, torch.float32), (3, 375, torch.float32),
                     (3, 375, torch.float64)):
        fn = getattr(lib, "slod_stencil_trace_f" + str(dt)[-2:])
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        B = 128
        band = torch.randn((B, nN, 27 * C * C), device="cuda",
                           generator=g).to(dt)
        Xp = torch.nn.functional.pad(
            torch.randn((B, C, nN, k), device="cuda", generator=g),
            (0, 0, shiftN, shiftN)).to(dt).contiguous()
        S = torch.empty((B, C, nN, k), device="cuda", dtype=dt)

        def call():
            rc = fn(band.data_ptr(), Xp.data_ptr(), S.data_ptr(), B, C, nN,
                    Xp.shape[2], k, 27, offs.ctypes.data,
                    torch.cuda.current_stream().cuda_stream)
            assert rc == 0, f"launch returned {rc}"
        call()
        torch.cuda.synchronize()
        err = "-"
        if "/" not in name:
            ref = assembly.stencil_trace_plain(band[-4:].double(),
                                               Xp[-4:].double(), shiftN,
                                               offs0)
            err = (f"{float((S[-4:].double() - ref).abs().max()):.2e} "
                   f"abs, max |S| {float(ref.abs().max()):.2e}")
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(50_000_000)
        t0.record()
        for _ in range(10):
            call()
        t1.record()
        torch.cuda.synchronize()
        print(f"[trace_bench] {name} C={C} k={k} {str(dt)[6:]}: "
              f"{t0.elapsed_time(t1) / 10:.4f} ms (err {err})", flush=True)


def main():
    if sys.argv[1:2] == ["--run"]:
        run(sys.argv[2], sys.argv[3])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("trace_bench: torch sees no CUDA device", file=sys.stderr)
        return 2
    names = sys.argv[1:] or ["shipped", "shipped/copies", "shipped/fmas"]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"[trace_bench] {card}")
    rc = 0
    for name, path in build(names).items():
        p = subprocess.run([sys.executable, __file__, "--run", name, path],
                           timeout=120)
        rc = rc or p.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
