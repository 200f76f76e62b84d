"""The parent's work in the pool's loop: "Pool route" (handling the
workers' messages, feeding preps, the VCF writer), "Pool dispatch"
(stacking, copies, launches) and "Stutter estimation (device)" (the EM
waves), over the traced run's wall less the workers' start ("Worker
start"), as pool_idle_pct.  "Pool send" (the replies) is left out: it is
a wait on full worker pipes, which pool_pipe_wait_pct reads.  None where
the program does not split its loop into states ("Pool loop")."""

BUSY = ("Pool route", "Pool dispatch", "Stutter estimation (device)")


def read(run):
    t = run["timers"]
    if "Pool loop" not in t or run["wall_s"] <= 0:
        return None
    start = t.get("Worker start", 0.0)
    return 100.0 * sum(t.get(n, 0.0) for n in BUSY) / (run["wall_s"] - start)
