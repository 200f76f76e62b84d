"""Copy of hipstr_tpu/utils/timers.py.

Named phase timers.

Capability parity with the reference's ProcessTimer + per-locus phase timing
(reference: src/process_timer.h:7-27, src/genotyper_bam_processor.cpp:254-276,
src/genotyper_bam_processor.h:196-233): cumulative name -> seconds map with a
run-summary printout, plus a context manager for per-phase measurement.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict


class ProcessTimer:
    def __init__(self):
        self.totals: Dict[str, float] = {}

    def add_time(self, name: str, seconds: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + seconds

    @contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add_time(name, time.perf_counter() - t0)

    def summary(self) -> str:
        lines = ["Execution timing summary:"]
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            lines.append(f"\t{name:<24s} = {self.totals[name]:.3f} seconds")
        return "\n".join(lines)
