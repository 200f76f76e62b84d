"""Copy of hipstr_tpu/utils/timers.py.

Named phase timers.

Capability parity with the reference's ProcessTimer + per-locus phase timing
(reference: src/process_timer.h:7-27, src/genotyper_bam_processor.cpp:254-276,
src/genotyper_bam_processor.h:196-233): cumulative name -> seconds map with a
run-summary printout, plus a context manager for per-phase measurement.

Besides the phases, a loop can be split into *states* (`switch`): every
second between two switches goes to the state that was open, so the states
partition the loop's wall time.  While a torch profiler is active in the
process, each phase and each state is also a `record_function` range of
the same name, so a trace shows the host's phases on the same timeline as
the device's work; with no profiler that costs one flag read.  The module
imports no torch itself: it reads the profiler's flag only where torch is
already loaded.  All times
come from `time.perf_counter()`, the monotonic clock every process of a
run shares.
"""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager
from typing import Dict, Optional

_profiler = None      # torch.autograd.profiler, once torch is loaded


def _open_range(name: str):
    """A torch.profiler range named `name`, entered, while a profiler is
    active in this process; else None.  A process that has not loaded
    torch (a pool's host worker) has no profiler, and this loads none."""
    global _profiler
    if _profiler is None:
        if "torch" not in sys.modules:
            return None
        from torch.autograd import profiler as _profiler
    if not _profiler._is_profiler_enabled:
        return None
    rng = _profiler.record_function(name)
    rng.__enter__()
    return rng


class ProcessTimer:
    """Totals by name, in seconds.  `time` blocks may nest (the inner
    block's time is in both totals); `covered` is the time inside
    outermost blocks, each second once.  One thread's timer: the nesting
    depth is not shared safely across threads."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.covered = 0.0
        self._depth = 0
        self._state: Optional[str] = None
        self._t_state = 0.0
        self._range = None

    @property
    def depth(self) -> int:
        """How many `time` blocks are open."""
        return self._depth

    def add_time(self, name: str, seconds: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + seconds

    @contextmanager
    def time(self, name: str):
        rng = _open_range(name)
        self._depth += 1
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._depth -= 1
            if not self._depth:
                self.covered += dt
            self.add_time(name, dt)
            if rng is not None:
                rng.__exit__(None, None, None)

    def switch(self, name: Optional[str]) -> float:
        """Close the open state, adding the time since it opened to its
        total, and open state `name` (None: open none).  Returns the
        clock reading both share."""
        t = time.perf_counter()
        if self._state is not None:
            self.add_time(self._state, t - self._t_state)
            if self._range is not None:
                self._range.__exit__(None, None, None)
        self._state, self._t_state = name, t
        self._range = _open_range(name) if name is not None else None
        return t

    def summary(self) -> str:
        lines = ["Execution timing summary:"]
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            lines.append(f"\t{name:<24s} = {self.totals[name]:.3f} seconds")
        return "\n".join(lines)
