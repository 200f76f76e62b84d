"""The anonymous memory of the pool's host workers, in MiB: the mean over
the workers of what each read of its own at its end ("anon_mib" in its
"fin" report, run_pooled's last_run_stats["workers"]), whole traced run.
None where no worker reports it (a run in one process, or a program whose
workers do not)."""


def read(run):
    mib = [w["anon_mib"] for w in run["stats"].get("workers", ())
           if w.get("anon_mib") is not None]
    return sum(mib) / len(mib) if mib else None
