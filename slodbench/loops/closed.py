"""Closed loop, one solve in flight: solve after solve, each input drawn
just before its clock starts, until ``seconds`` have passed (or ``limit``
solves); the window ends when the solve running at the deadline
completes.  A latency runs from the input handed to ``solve`` to the
sync after its answer."""

import time

import torch


def window(solve, inputs, draw, seconds, device, keep, sync, first=0,
           limit=None):
    """Solves ``first``, ``first + 1``, ...; returns (latencies, window
    seconds, solves, device count of non-finite answers)."""
    lat, i = [], first
    bad = torch.zeros((), dtype=torch.int64, device=device)
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        x = draw(inputs, i)
        sync(device)
        t0 = time.perf_counter()
        u = solve(x)
        sync(device)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        bad += (~torch.isfinite(u).all()).to(torch.int64)
        keep.offer(i, u)
        i += 1
        if t1 >= deadline or (limit and i - first >= limit):
            break
    return lat, t1 - t_start, i - first, bad
