"""basis.canvas.host_ms: host milliseconds per solve inside the
port's ``canvas`` chunk-stage spans (the candidates, A phi and their
copy into Phi / APhi)."""

import program_trace


def read(ctx):
    return program_trace.span_host_ms(ctx, "canvas")
