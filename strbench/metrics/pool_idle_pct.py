"""The parent's "Pool idle" (waiting with nothing ready on the workers, or
blocked on a fetch) over the traced run's wall, both less the workers'
start ("Worker start": spawn to first reply, idle by construction)."""


def read(run):
    t = run["timers"]
    if "Pool idle" not in t or run["wall_s"] <= 0:
        return None
    start = t.get("Worker start", 0.0)
    return 100.0 * max(t["Pool idle"] - start, 0.0) / (run["wall_s"] - start)
