"""Reduce a ``torch.profiler`` chrome trace of the traced window to what
the per-layer metrics and the breakdown read.

Device activity is every kernel, copy and fill on the card; the window is
the ``slodbench/window`` range, and the spans are the ``slodbench/<layer>``
ranges that ``harness.Spans`` opened (each ends in a device sync, so the
device work a span launched lies inside it).  A hand-kernel launch is the
``slodbench/launch/<n>`` range around its call: the runtime launch events
inside it carry the correlation ids of its kernels."""

from __future__ import annotations

import bisect
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NOT_LAYERS = ("window", "solve")


def merge(intervals):
    """Union of [start, end) intervals, sorted and disjoint."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap(merged, a, b):
    """Length of [a, b) covered by the disjoint sorted intervals."""
    starts = [m[0] for m in merged]
    i = max(0, bisect.bisect_right(starts, a) - 1)
    total = 0.0
    while i < len(merged) and merged[i][0] < b:
        total += max(0.0, min(b, merged[i][1]) - max(a, merged[i][0]))
        i += 1
    return total


def reduce(chrome: dict, records: list) -> dict:
    """-> window_s, busy_s, kernels, busy_in {layer: s}, launch_s (device
    seconds of each recorded launch), device_ops, idle_gaps (seconds)."""
    events = [e for e in chrome.get("traceEvents", []) if e.get("ph") == "X"]
    win = [e for e in events if e.get("cat") == "user_annotation"
           and e["name"] == "slodbench/window"]
    if not win:
        raise RuntimeError("the trace holds no slodbench/window range")
    w0 = win[0]["ts"]
    w1 = w0 + win[0]["dur"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and w0 <= e["ts"] < w1]
    busy = merge([(e["ts"], min(w1, e["ts"] + e["dur"])) for e in dev])
    kernels = [e for e in dev if e["cat"] == "kernel"]

    spans = defaultdict(list)
    launches = {}
    for e in events:
        if e.get("cat") != "user_annotation":
            continue
        name = e["name"]
        if name.startswith("slodbench/launch/"):
            launches[int(name.rsplit("/", 1)[1])] = e
        elif name.startswith("slodbench/"):
            spans[name[len("slodbench/"):]].append((e["ts"],
                                                    e["ts"] + e["dur"]))
    busy_in = {k: sum(overlap(busy, a, b) for a, b in v) / 1e6
               for k, v in spans.items() if k not in NOT_LAYERS}

    # launch -> its kernels' device time, through the correlation ids
    kdur = defaultdict(float)
    for e in kernels:
        c = e.get("args", {}).get("correlation")
        if c is not None:
            kdur[c] += e["dur"]
    runtime = sorted((e["ts"], e.get("tid"), e.get("args", {})
                      .get("correlation")) for e in events
                     if e.get("cat") in ("cuda_runtime", "cuda_driver"))
    rts = [r[0] for r in runtime]
    launch_s = [None] * len(records)
    for n, e in launches.items():
        if n >= len(records):
            continue
        lo = bisect.bisect_left(rts, e["ts"])
        hi = bisect.bisect_right(rts, e["ts"] + e["dur"])
        t = sum(kdur.get(c, 0.0) for _, tid, c in runtime[lo:hi]
                if tid == e.get("tid"))
        launch_s[n] = t / 1e6 if t > 0 else None

    by_name = defaultdict(float)
    for e in dev:
        by_name[e["name"][:160]] += e["dur"] / 1e6
    device_ops = sorted(([k, v] for k, v in by_name.items()),
                        key=lambda kv: -kv[1])[:10]

    layer_spans = sorted((a, b, k) for k, v in spans.items()
                         if k not in ("window",) for a, b in v)

    def label(t):
        inner = [(b - a, k) for a, b, k in layer_spans if a <= t < b]
        if not inner:
            return "between solves"
        return min(inner)[1]

    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i + 1] - edges[i], edges[i])
            for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
    gaps.sort(reverse=True)
    idle_gaps = [[label(t + d / 2), d / 1e6] for d, t in gaps[:10]]
    return dict(window_s=(w1 - w0) / 1e6,
                busy_s=sum(b - a for a, b in busy) / 1e6,
                kernels=len(kernels), busy_in=busy_in, launch_s=launch_s,
                device_ops=device_ops, idle_gaps=idle_gaps)
