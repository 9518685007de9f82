"""coarse_solve_roofline: the coarse solve's share of its roofline, in %:
the least time of C^T f and of the CG's issued iterations a solve
(``roofline_coarse.coarse_solve_work``, iterations from the port's
``cg.enqueued`` counter) over the device-busy time inside the
``coarse_solve`` spans a solve.  None where no coarse_solve span ran, no
CG iteration was counted, or the port keeps no counters."""

import program_trace
import roofline_coarse as rc


def read(ctx):
    enq = program_trace.counter_total("cg.enqueued")
    if not enq or not ctx["solves"]:
        return None
    conf = ctx["conf"]
    work = rc.coarse_solve_work(**rc.args(conf),
                                iterations=enq / ctx["solves"])
    return rc.share(ctx, "coarse_solve", rc.least_s(conf, work))
