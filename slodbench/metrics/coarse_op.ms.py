"""coarse_op.ms: the median over the traced solves of the synced span around
the call into the coarse op layer, in ms (None where the cell's traced
calls open no such span)."""

import statistics


def read(ctx):
    v = ctx["spans"].get("coarse_op")
    return statistics.median(v) * 1e3 if v else None
