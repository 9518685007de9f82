"""device.h2d_mib: MiB per solve that the port uploads from host arrays
on the solve path (its ``h2d_bytes`` counter / 2^20; 0 where the
window's solves uploaded none)."""

import program_trace


def read(ctx):
    return program_trace.counter_per_solve(ctx, "h2d_bytes", 2.0 ** -20)
