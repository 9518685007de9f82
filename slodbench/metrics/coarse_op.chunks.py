"""coarse_op.chunks: the stencil build's chunks a solve (the port's
``stencil.chunks`` counter: K-chunks of the cells build, or pairs of
plane ranges of the planes build), which shows the byte rule's branch.
None where the port counted none (no stencil build ran, or a port
without the counter)."""

import program_trace


def read(ctx):
    total = program_trace.counter_total("stencil.chunks")
    if not total or not ctx["solves"]:
        return None
    return total / ctx["solves"]
