"""The share of the pool's workers' ML-trace jobs (pool, haplotype) run
ahead on a worker's trace thread: prefetched over prefetched plus traced
on the main thread, summed over the workers' "fin" reports
(`trace_jobs_prefetched`, `trace_jobs_main`; run_pooled's
last_run_stats["workers"]), whole traced run.  None where no worker
reports them."""


def read(run):
    done = [(w["trace_jobs_prefetched"], w["trace_jobs_main"])
            for w in run["stats"].get("workers", ())
            if "trace_jobs_prefetched" in w]
    ahead = sum(p for p, _ in done)
    total = ahead + sum(m for _, m in done)
    return 100.0 * ahead / total if total else None
