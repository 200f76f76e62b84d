"""Per-layer metric readers, one file per metric named as in
BENCHMARK.json: `read(run)` takes the traced run's record (strbench/harness
`layer_record`) and returns the metric's value, or None when the run gave
it nothing to read (the harness then leaves the metric out)."""


def per_locus_ms(run, *timers):
    """The summed totals of `timers` (seconds) over the run's loci, in ms;
    None when no timer of them ran."""
    have = [run["timers"][t] for t in timers if t in run["timers"]]
    if not have or not run["loci"]:
        return None
    return 1000.0 * sum(have) / run["loci"]


def roofline_pct(run, module):
    """Sum of the bounds of the window's captured launches of a kernel over
    the sum of the same launches' device time, in %; the launches and the
    profiler's kernels of that name are paired in order, from the end of
    the trace (a kernel launched before the window opened may still run in
    it).  None when the window held no such launch."""
    import re
    pat = re.compile(rf"\b{module.KERNEL}\b")
    times = [t for n, t in run["trace"]["kernels"] if pat.search(n)]
    caps = run["captured"][module.__name__.rsplit(".", 1)[1]]
    n = min(len(times), len(caps))
    if n == 0:
        return None
    bound_ms = sum(module.captured_bound(c, run["dtype"])["bound_ms"]
                   for c in caps[:n])
    return 100.0 * bound_ms / (1000.0 * sum(times[-n:]))
