"""coarse_solve.cg_waste_pct: the share of the coarse CG's issued
iterations that were masked no-ops after convergence, in %: 100 (sum of
``cg.enqueued`` - sum of ``cg.iterations``) / sum of ``cg.enqueued``
(None where no CG ran)."""

import program_trace


def read(ctx):
    enq = program_trace.counter_total("cg.enqueued")
    if not enq:
        return None
    it = program_trace.counter_total("cg.iterations")
    return 100.0 * (enq - it) / enq
