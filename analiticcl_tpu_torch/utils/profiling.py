"""The host-side stage timer (copied from ``analiticcl_tpu/utils/profiling.py``).

Per-batch stage timings are collected in ``DevicePipeline.stats`` and printed
at debug >= 2 (host prep / device / host tail); search and learn add their
own stages.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict


class StageTimer:
    """Accumulates wall-clock per named stage."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, out=sys.stderr) -> None:
        for name, total in sorted(self.totals.items()):
            n = self.counts[name]
            print(
                f" (stage {name}: {total * 1e3:.1f} ms over {n} calls, "
                f"{total / n * 1e3:.2f} ms/call)",
                file=out,
            )

    def clear(self) -> None:
        self.totals.clear()
        self.counts.clear()
