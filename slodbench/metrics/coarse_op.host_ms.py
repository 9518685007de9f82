"""coarse_op.host_ms: host milliseconds per solve inside the port's
``coarse_op`` span (the stencil build of A_LOD)."""

import program_trace


def read(ctx):
    return program_trace.span_host_ms(ctx, "coarse_op")
