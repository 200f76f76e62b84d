"""The host worker of the pool (parallel/workers.run_pooled): the side of
the pool that never touches a device, and never imports torch.

A worker runs every per-locus host phase of its loci through
pipeline/locus_host.LocusHost, as the in-process run does: BAM decode,
read filtering, the host stutter EM (or the staging of the device EM's
problem), haplotype generation, pooling, the adaptive allele loop,
ML-trace retracing and VCF record assembly, all of it numpy and the
native host library; LocusHost's messages are the worker's replies.  It
packs each round's inputs as numpy arrays and the parent moves them to
the device.  This module keeps the schedule: the pipe, the task queue,
the trace thread and the timers' hand-over.  Nothing this module
imports, directly or through other modules, imports torch, nor does what
the spawn unpickles (`worker_main`, the worker's spec and its
PipelineOptions), so a worker spends no memory or start-up time on it;
its "fin" report says whether torch got loaded all the same
(`torch_loaded`, with `cuda_initialized` where it did) and gives its
anonymous memory then (`anon_mib`).  The messages, and the timers a
worker hands over, are set out in parallel/workers.py.

A worker overlaps its loci's native ML traces with its own Python, as the
in-process executor does (parallel/executor.run_batched): after each task
it reads every message its pipe already holds into a queue, which it
works through in arrival order.  It keeps its one trace thread fed:
before each task, if that thread has no batch left to run, the first
queued "ll" not yet installed is installed (LLs and posteriors) and its
round's traces are marshalled and handed to the thread (the genotyper's
trace prefetch), which runs the native batch with the GIL released; the
locus collects them when its turn comes.  A locus whose adaptive loop
ends starts its record's traces the same way and builds the record after
one more task.  Loci are installed only as fast as the thread traces
them, and records wait one task, since a locus installed or finished
holds ~1-2 MiB until its turn: installing every queued reply at once, or
queueing records behind the whole queue, costs several times that in
memory for no more overlap.  The "fin" report counts the trace jobs
(pool, haplotype) prefetched, traced on the main thread and discarded
stale (`trace_jobs_*`); the traces' seconds, on either thread, are
handed over as the span "ML traces".
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import sys
import time
from collections import deque
from typing import Dict, Optional

# seconds between a worker's timer hand-overs
TIMERS_EVERY_S = 1.0


def anon_mib() -> Optional[float]:
    """This process's anonymous resident memory in MiB (its heap and
    arrays; no shared-library pages), read as strbench/memwatch.py reads a
    process's: the Anonymous total of /proc/self/smaps_rollup or smaps,
    else RssAnon from status; None where /proc has none of them."""
    for name, key in (("smaps_rollup", "Anonymous:"), ("smaps", "Anonymous:"),
                      ("status", "RssAnon:")):
        try:
            with open(f"/proc/self/{name}") as fh:
                kib = [int(line.split()[1]) for line in fh
                       if line.startswith(key)]
        except (OSError, ValueError, IndexError):
            continue
        if kib:
            return sum(kib) / 1024.0
    return None


def worker_main(conn, spec: dict) -> None:
    """One host worker's life: build the pipeline from `spec`, serve the
    parent's messages until "fin", then report (module docstring)."""
    # the parent owns the card: hide it, should anything load CUDA
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    # one native-trace thread per batch: the pool already occupies the
    # cores
    os.environ.setdefault("HIPSTR_TRACE_THREADS", "1")

    from ..pipeline.locus_host import LocusHost
    from ..pipeline.processor import GenotyperPipeline, Logger

    opts = spec["opts"]
    if opts.viz_out:
        opts.viz_out = None          # parent owns the real viz stream
        opts.output.viz_out = True
    pipeline = GenotyperPipeline(spec["bam_paths"], spec["fasta_path"], opts,
                                 Logger(quiet=True),
                                 bam_samps=spec["bam_samps"],
                                 bam_libs=spec["bam_libs"],
                                 lib_field=spec["lib_field"])
    timer = pipeline.timer
    # the tasks in arrival order: the parent's messages, and ("record",
    # idx) for a finished locus
    tasks: deque = deque()
    # idx -> installed, of each "ll" installed ahead of its turn
    ahead: Dict[int, bool] = {}
    # the native trace batches run on one thread of their own (the batch
    # releases the GIL) while the main thread steps the loci ahead
    trace_pool = cf.ThreadPoolExecutor(max_workers=1)

    def send(msg) -> None:
        """A message to the parent, timed as "Worker send"; one that a
        locus's timer holds (a record, in "Genotyping (adaptive)", which
        adaptive_ms_per_locus reads) is counted there instead."""
        if timer.depth:
            conn.send(msg)
            return
        with timer.time("Worker send"):
            conn.send(msg)

    # the parent fuses the genotype posteriors into its dispatches on the
    # card and learns the stutter models in batched waves: the workers
    # install those, so pooled and in-process runs decide alike
    host = LocusHost(pipeline, send, device_em=bool(spec["device_em"]),
                     device_post=bool(spec["device_post"]),
                     trace_pool=trace_pool, trace_threads=0)

    def install_ahead() -> None:
        """While the trace thread has nothing to run, install the first
        queued "ll" not yet installed, so that its traces run while the
        main thread works on the task in hand."""
        if host.tracing is not None and not host.tracing.done():
            return
        for task in tasks:
            if task[0] == "ll" and task[1] not in ahead:
                ahead[task[1]] = host.install(task[1], *task[2:])
                return

    handed: Dict[str, float] = {}     # totals already handed over
    t_handed = time.perf_counter()    # the first recv's start
    covered_handed = 0.0
    traced_handed = 0.0

    def hand_over():
        """(timers, spans): what the timers accrued since the last
        hand-over, with the interval's "Worker wall" and "Worker other"
        (the wall that no outermost timer, "Worker idle" included,
        covered); and the seconds of the native traces in that time, on
        either thread ("ML traces": no part of the wall's partition)."""
        nonlocal t_handed, covered_handed, traced_handed
        now = time.perf_counter()
        out = {k: v - handed.get(k, 0.0) for k, v in timer.totals.items()
               if v != handed.get(k, 0.0)}
        handed.update(timer.totals)
        out["Worker wall"] = now - t_handed
        out["Worker other"] = out["Worker wall"] - (timer.covered
                                                    - covered_handed)
        t_handed, covered_handed = now, timer.covered
        traced = host.tally.seconds
        spans = {"ML traces": traced - traced_handed} \
            if traced != traced_handed else {}
        traced_handed = traced
        return out, spans

    while True:
        if not tasks:
            with timer.time("Worker idle"):
                tasks.append(conn.recv())
        while conn.poll(0):
            tasks.append(conn.recv())
        task = tasks.popleft()
        tag = task[0]
        if tag == "ll":
            idx = task[1]
            ok = ahead.pop(idx) if idx in ahead else host.install(*task[1:])
        install_ahead()
        if tag == "prep":
            host.begin(task[1], task[2])
        elif tag == "ll":
            # a record is built one task after its traces are prefetched
            if ok and host.step(idx):
                tasks.insert(min(1, len(tasks)), ("record", idx))
        elif tag == "record":
            host.record(task[1])
        elif tag == "emr":
            host.resume(task[1], task[2], task[3])
        elif tag == "fin":
            trace_pool.shutdown(wait=True)
            torch = sys.modules.get("torch")
            report = dict(
                pid=os.getpid(),
                torch_loaded=torch is not None,
                anon_mib=anon_mib(),
                host_posteriors=host.host_posteriors,
                jax_loaded=sorted(
                    m for m, mod in sys.modules.items() if mod is not None
                    and m.split(".")[0] in ("jax", "hipstr_tpu")),
                **{f"trace_jobs_{k}": n
                   for k, n in host.tally.jobs.items()})
            if torch is not None:
                report["cuda_initialized"] = bool(torch.cuda.is_initialized())
            send(("fin", pipeline.counters, pipeline._stutter_out,
                  *hand_over(), report))
            conn.close()
            return
        if time.perf_counter() - t_handed >= TIMERS_EVERY_S:
            send(("timers", *hand_over()))
