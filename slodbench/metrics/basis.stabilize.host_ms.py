"""basis.stabilize.host_ms: host milliseconds per solve inside the
port's ``stabilize`` chunk-stage spans (the trace S, the Grams and the
spectral stage)."""

import program_trace


def read(ctx):
    return program_trace.span_host_ms(ctx, "stabilize")
