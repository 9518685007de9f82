"""basis.assemble.host_ms: host milliseconds per solve inside the
port's ``assemble`` chunk-stage spans (each chunk's coefficient windows,
its bands, A and PT)."""

import program_trace


def read(ctx):
    return program_trace.span_host_ms(ctx, "assemble")
