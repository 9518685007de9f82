"""What the per-layer metrics read from the port's own spans and counters
(``dealii_slod_tpu_torch/utils/timers.py``).  The port records them while
a profiler runs, so after the traced window its buffer holds exactly the
window's spans and counts.  Each function returns None where the port
keeps no such buffer (a port without the tracer) or recorded nothing."""


def _timers():
    try:
        from dealii_slod_tpu_torch.utils import timers
    except ImportError:
        return None
    if not all(hasattr(timers, f) for f in ("records", "counters")):
        return None
    return timers


def span_host_ms(ctx, *names):
    """Inclusive host milliseconds of the spans named ``names``, summed
    and divided by the traced solves (None where none ran)."""
    timers = _timers()
    if timers is None or not ctx["solves"]:
        return None
    ns = [r.t1_ns - r.t0_ns for r in timers.records() if r.name in names]
    return sum(ns) / 1e6 / ctx["solves"] if ns else None


def counter_total(name: str):
    """The counter's total over the window: 0 where the port recorded
    spans but never this count, None where it recorded nothing."""
    timers = _timers()
    if timers is None or not timers.records():
        return None
    return sum(timers.counters().get(name, {}).values())


def counter_per_solve(ctx, name: str, scale: float = 1.0):
    total = counter_total(name)
    if total is None or not ctx["solves"]:
        return None
    return total * scale / ctx["solves"]
