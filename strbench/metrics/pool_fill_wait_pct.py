"""The parent blocked, or asleep, while loci are staged and no dispatch is
in flight ("Pool wait fill": waiting for a window or an EM wave to fill),
over the traced run's wall less the workers' start ("Worker start"), as
pool_idle_pct.  None where the program does not split its loop into
states ("Pool loop")."""


def read(run):
    t = run["timers"]
    if "Pool loop" not in t or run["wall_s"] <= 0:
        return None
    start = t.get("Worker start", 0.0)
    return 100.0 * t.get("Pool wait fill", 0.0) / (run["wall_s"] - start)
