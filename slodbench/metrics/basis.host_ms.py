"""basis.host_ms: host milliseconds per solve inside the port's
``basis`` span (``compute_basis``, inclusive; enqueue time, no sync)."""

import program_trace


def read(ctx):
    return program_trace.span_host_ms(ctx, "basis")
