"""basis.windows.host_ms: host milliseconds per solve inside the port's
``windows`` spans (on the per-chunk window route: the padded coefficient
lattice's build and each chunk's cut of its windows)."""

import program_trace


def read(ctx):
    return program_trace.span_host_ms(ctx, "windows")
