"""coarse_solve.host_ms: host milliseconds per solve inside the
port's ``coarse_solve`` span (C^T f, then the coarse CG or the direct
solve, on every route)."""

import program_trace


def read(ctx):
    return program_trace.span_host_ms(ctx, "coarse_solve")
