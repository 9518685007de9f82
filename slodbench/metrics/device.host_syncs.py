"""device.host_syncs: the port's host reads of device state per solve
(its ``host_syncs`` counter: the coarse CG's stop tests and the library
checks that wait for the card; 0 where the window's solves made none)."""

import program_trace


def read(ctx):
    return program_trace.counter_per_solve(ctx, "host_syncs")
