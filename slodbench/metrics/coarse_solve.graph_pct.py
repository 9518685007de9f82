"""coarse_solve.graph_pct: the share of the coarse CG's issued iterations
that ran as replays of a captured CUDA graph, in %: 100 (sum of
``cg.graph_iterations``) / sum of ``cg.enqueued``.  None where no CG ran,
and on a port whose CG has no graph plan (``ops/solvers.CGGraph``), which
never counts replays."""

import program_trace


def _port_replays() -> bool:
    try:
        from dealii_slod_tpu_torch.ops import solvers
    except ImportError:
        return False
    return hasattr(solvers, "CGGraph")


def read(ctx):
    enq = program_trace.counter_total("cg.enqueued")
    if not enq or not _port_replays():
        return None
    return 100.0 * program_trace.counter_total("cg.graph_iterations") / enq
