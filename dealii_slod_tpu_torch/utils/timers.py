"""Stage wall-clock timers (counterpart of ``dealii_slod_tpu/utils/
timers.py``) and the solver's spans and counters.

``StageTimer``: synced sections; on a CUDA device each section ends with
``torch.cuda.synchronize`` so the numbers include the device's work
(``run()``'s timing table).

``span(name, **attrs)`` (or the decorator ``spanned(name)``) and
``count(name, n)`` record where the solver's work happens, only while a
``torch.profiler`` session is active (``cfg.profile_dir``, or the
caller's own ``torch.profiler.profile``).  With no profiler running
``span`` returns one shared null context and ``count`` returns at once:
no record, no clock read, no sync.  With one
running, a span appends a record ``(id, parent, root, name, t0_ns, t1_ns,
attrs)`` of host ``perf_counter_ns`` times and opens a
``torch.profiler.record_function`` range of the same name, so each span
also sits in the profiler's trace beside the device work it enqueued.  A
span opened with no open parent is a root; its descendants carry its id.
Host times are enqueue times: nothing here synchronises the device.

``count`` adds ``n`` under the innermost open span's name; ``n`` may be a
device scalar, kept as it is and turned into an int only when read, so
counting never syncs.  ``records()``, ``counters()`` and ``clear()`` read
and reset the in-memory buffer, which keeps the newest ``MAX_RECORDS``
spans and as many counts."""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time
from collections import defaultdict
from typing import NamedTuple

import torch

MAX_RECORDS = 10 ** 6

_enabled = torch.autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_ids = itertools.count(1)
_spans: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_counts: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_local = threading.local()


class Record(NamedTuple):
    id: int
    parent: int | None          # the enclosing span's id, None at a root
    root: int                   # the root span's id (its own at a root)
    name: str
    t0_ns: int
    t1_ns: int
    attrs: dict


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Span:
    __slots__ = ("name", "attrs", "rec", "rf", "stack")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.stack = st = _stack()
        top = st[-1] if st else None
        sid = next(_ids)
        # [id, parent, root, name, t0, t1, attrs], t1 filled on exit
        self.rec = [sid, top[0] if top else None, top[2] if top else sid,
                    self.name, 0, None, self.attrs]
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        st.append(self.rec)
        _spans.append(self.rec)
        self.rec[4] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.rec[5] = time.perf_counter_ns()
        self.stack.pop()
        self.rf.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """A context manager that records the block as the span ``name``
    while a profiler is active, else the shared null context."""
    if not _enabled():
        return _NULL
    return _Span(name, attrs)


def spanned(name: str):
    """Decorator: each call of the function is a ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def count(name: str, n) -> None:
    """Add ``n`` (an int or a device scalar) to the counter ``name`` under
    the innermost open span's name, while a profiler is active."""
    if not _enabled():
        return
    st = _stack()
    _counts.append((name, st[-1][3] if st else None, n))


def records() -> list:
    """The finished spans in the buffer, in the order they opened."""
    return [Record(*r) for r in _spans if r[5] is not None]


def counters() -> dict:
    """{counter name: {enclosing span name (None outside any): total}}
    of the counts in the buffer, as ints (device scalars are read
    here)."""
    out: dict = defaultdict(lambda: defaultdict(int))
    for name, scope, n in list(_counts):
        out[name][scope] += int(n)
    return {k: dict(v) for k, v in out.items()}


def clear() -> None:
    _spans.clear()
    _counts.clear()


class StageTimer:
    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        if not self.totals:
            return ""
        width = max(len(k) for k in self.totals)
        lines = ["+---------------------------------------------+",
                 "| wall-clock timing summary                   |",
                 "+---------------------------------------------+"]
        total = sum(self.totals.values())
        for k in sorted(self.totals):
            lines.append(f"| {k:<{width}} | {self.counts[k]:4d} | "
                         f"{self.totals[k]:10.4f}s |")
        lines.append(f"| {'TOTAL':<{width}} |      | {total:10.4f}s |")
        lines.append("+---------------------------------------------+")
        return "\n".join(lines)
