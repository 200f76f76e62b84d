"""The device's side of a traced run: torch.profiler over the measured
window, reduced to device intervals (kernels, copies, sets), their union
(busy time), the time of each kernel by name, the idle gaps between them
labelled by the harness span open on the host, and the kernels' launch
order, which the roofline readers pair with the captured launches."""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

# profiler event names of the device's own work besides kernels
DEVICE_WORK = ("Memcpy", "Memset", "memcpy", "memset")


class DeviceTrace:
    def __init__(self):
        self.prof = None
        self.t0_wall = self.t0_perf = 0

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0_wall = time.time_ns()
        self.t0_perf = time.perf_counter_ns()

    def stop(self):
        import torch
        torch.cuda.synchronize()
        self.t1_perf = time.perf_counter_ns()
        self.prof.__exit__(None, None, None)

    def events(self) -> List[Tuple[str, int, int]]:
        """(name, start ns, end ns) of every device event, in the harness's
        perf_counter_ns clock, sorted by start."""
        res = self.prof.profiler.kineto_results
        raw = []
        for e in res.events():
            if e.device_type().name != "CUDA":
                continue
            if hasattr(e, "start_ns"):
                s, d = e.start_ns(), e.duration_ns()
            else:
                s, d = e.start_us() * 1000, e.duration_us() * 1000
            if d > 0:
                raw.append((e.name(), s, s + d))
        if not raw:
            return []
        # kineto's clock is the wall clock on Linux builds; the perf clock
        # is what the harness's spans use
        shift = self.t0_perf - self.t0_wall
        first = min(s for _, s, _ in raw)
        if abs(first - self.t0_wall) > 3600 * 10 ** 9:
            shift = self.t0_perf - first       # unknown base: align starts
        return sorted((n, s + shift, e + shift) for n, s, e in raw)


def union(intervals) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


SPAN_ORDER = ("em_wave", "dispatch", "fetch")


def label(spans, t: int) -> str:
    """The harness span open at time t, by SPAN_ORDER; else the parent was
    routing messages or waiting on its host workers."""
    open_ = {n for n, a, b in spans if a <= t <= b}
    for name in SPAN_ORDER:
        if name in open_:
            return name
    return "host_workers"


def reduce(events, spans, t_open: int, t_close: int) -> dict:
    """busy_s, window_s, kernel times by name, the top device ops and the
    longest idle gaps of the window [t_open, t_close] (perf ns)."""
    ev = [(n, max(s, t_open), min(e, t_close)) for n, s, e in events
          if e > t_open and s < t_close]
    busy = union((s, e) for _, s, e in ev)
    busy_ns = sum(e - s for s, e in busy)
    by_name: Dict[str, float] = {}
    for n, s, e in ev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
    gaps = []
    prev = t_open
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t_close > prev:
        gaps.append((prev, t_close))
    gaps.sort(key=lambda g: g[0] - g[1])
    return dict(
        busy_s=busy_ns / 1e9, window_s=(t_close - t_open) / 1e9,
        by_name=by_name,
        device_ops=[[n, t] for n, t in sorted(by_name.items(),
                                              key=lambda x: -x[1])[:10]],
        idle_gaps=[[label(spans, (a + b) // 2), (b - a) / 1e9]
                   for a, b in gaps[:10]],
        kernels=[(n, (e - s) / 1e9) for n, s, e in events])
