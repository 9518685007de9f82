"""prolong.host_ms: host milliseconds per solve inside the port's
``prolong`` span (``prolong_lod_solution``)."""

import program_trace


def read(ctx):
    return program_trace.span_host_ms(ctx, "prolong")
