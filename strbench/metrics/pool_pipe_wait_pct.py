"""The parent's replies to the workers ("Pool send": the "ll" and "emr"
messages), over the traced run's wall less the workers' start ("Worker
start"), as pool_idle_pct.  A reply's write blocks while the worker's pipe
is full, that is while the worker is busy with the locus in hand, so this
is mostly time the parent waits on its workers; the pickling in it is a
small part.  None where the program does not split its loop into states
("Pool loop")."""


def read(run):
    t = run["timers"]
    if "Pool loop" not in t or run["wall_s"] <= 0:
        return None
    start = t.get("Worker start", 0.0)
    return 100.0 * t.get("Pool send", 0.0) / (run["wall_s"] - start)
