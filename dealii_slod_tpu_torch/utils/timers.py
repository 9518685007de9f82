"""Stage wall-clock timers (counterpart of ``dealii_slod_tpu/utils/
timers.py``).  On a CUDA device each section ends with
``torch.cuda.synchronize`` so the numbers include the device's work."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class StageTimer:
    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def mark(self, name: str, seconds: float):
        self.totals[name] += seconds
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
