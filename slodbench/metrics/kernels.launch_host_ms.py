"""kernels.launch_host_ms: host milliseconds per solve inside the
port's ``launch`` spans (each hand-kernel launch through
``utils/kernels.launch``)."""

import program_trace


def read(ctx):
    return program_trace.span_host_ms(ctx, "launch")
