"""Per-stage wall-clock timing with the reference's performance report.

The port's own copy of ``PerfTimer`` from ``fastscnn_tpu/utils/profiling.py``:
every pipeline stage records its host time; the report prints per-stage
ms, the percentage breakdown and the frame rate the total implies. A
stage that reads a device result back includes the wait for the device.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

__all__ = ["PerfTimer"]


class PerfTimer:
    def __init__(self):
        self.times: dict[str, float] = {}
        self._order: list[str] = []

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float):
        self.times[name] = self.times.get(name, 0.0) + seconds
        if name not in self._order:
            self._order.append(name)

    @property
    def total(self) -> float:
        return sum(self.times.values())

    def report(self, title: str = "Performance analysis") -> str:
        total = self.total
        lines = [f"=== {title} ==="]
        for name in self._order:
            t = self.times[name]
            pct = 100.0 * t / total if total > 0 else 0.0
            lines.append(f"  {name:<24s} {t * 1e3:8.1f} ms  ({pct:5.1f}%)")
        lines.append(f"  {'TOTAL':<24s} {total * 1e3:8.1f} ms")
        if total > 0:
            lines.append(f"  theoretical FPS: {1.0 / total:.1f}")
        return "\n".join(lines)

    def print_performance_analysis(self, title: str = "Performance analysis"):
        print(self.report(title))
