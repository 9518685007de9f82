"""device.kernels_per_solve: device kernels the profiler saw in the
traced window, per solve: the launches behind a host-bound step."""


def read(ctx):
    return ctx["trace"]["kernels"] / ctx["solves"] if ctx["solves"] else None
