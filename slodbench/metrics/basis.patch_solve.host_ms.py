"""basis.patch_solve.host_ms: host milliseconds per solve inside the
port's ``patch_solve`` chunk-stage spans (X = A^-1 PT, T and T^-1:
K1 / K6, K2)."""

import program_trace


def read(ctx):
    return program_trace.span_host_ms(ctx, "patch_solve")
