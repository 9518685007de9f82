"""solve_ms_p95: the 95th percentile of every solve latency in the
window, in ms, linear between order statistics."""

import math


def percentile(values, q: float) -> float:
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def read(ctx):
    return percentile(ctx["latencies"], 95) * 1e3
