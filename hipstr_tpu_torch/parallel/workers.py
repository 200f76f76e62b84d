"""Host worker pool: one device-owning parent, N host worker processes.

Counterpart of hipstr_tpu/parallel/workers.py.  The reference scales only
by running independent processes over BED shards (reference:
README.md:167-171); on one card that wastes the device.  This executor
splits the program along the host/device boundary instead:

  * N *worker processes* run every per-locus host phase: BAM decode, read
    filtering, the host stutter EM (or the staging of the device EM's
    problem), haplotype generation, pooling, the adaptive allele loop,
    ML-trace retracing and VCF record assembly (reference:
    src/bam_processor.cpp:173-474, src/genotyper_bam_processor.cpp:161-289,
    src/seq_stutter_genotyper.cpp:603-671), each on its own core
    (parallel/pool_worker.worker_main).  They never touch the card and
    never import torch: each reports at the end whether torch got loaded
    all the same (`last_run_stats["workers_with_torch"]` counts those
    that did) and whether CUDA did, its anonymous memory, and how many
    rounds' genotype posteriors it computed itself (those of dispatches
    the parent did not fuse them into).
  * the *parent* owns the cards and every dispatch: the same shape-grouped
    batched alignments as the in-process executor (parallel/executor.py),
    each sharded over the same devices, and, without a stutter model on
    the card, the batched EM of the staged problems on the first card.

Messages (pickled over pipes):
  parent -> worker: ("prep", idx, region), ("ll", idx, LL[, post, totals]),
                    ("emr", idx, params, converged), ("fin",)
  worker -> parent: ("ready", idx, arrays, statics), ("em", idx, EMProblem),
                    ("settled", idx, record, viz), ("log", text),
                    ("timers", totals, spans), ("fin", counters, stutter
                    models, totals, spans, report)
They carry the packed int8/uint8 tensors, so a locus costs a few KB.  VCF
records come back tagged with their BED index and enter the writer in BED
order.  A worker hands its timer totals over about once a second
("timers": what accrued since the last hand-over; "fin" the rest), so the
parent's `pipeline.timer` holds them, as "<name> (workers)", while the run
goes on.

Time is accounted for on both sides.  The parent's loop is a partition of
states (ProcessTimer.switch): "Pool route" (handling inbox messages,
feeding preps, the VCF writer, fetch bookkeeping), "Pool send" (the "ll"
and "emr" replies), "Pool dispatch" (stacking, copies, launches),
"Stutter estimation (device)" (an EM wave), and, blocked on a queue or
asleep, "Pool wait fill" (loci staged, no dispatch in flight), "Pool wait
fetch" (a dispatch in flight) or "Pool wait idle" (neither); they sum to
"Pool loop", and "Pool idle" is "Pool wait idle" + "Pool wait fetch".
"Pool send" writes the replies; a write blocks only while the worker's
pipe is full, and a worker empties its pipe after every task it runs
(parallel/pool_worker.py).  A worker's "Worker wall" (first recv to
"fin") is its leaf timers ("Read filtering", "SNP info extraction",
"Stutter estimation", "Left alignment", "Genotyper build", "LL install",
"Genotyping (adaptive)", "Locus packing", "Worker send": every send but
the "settled" one that "Genotyping (adaptive)" holds), plus "Worker idle"
(blocked on its pipe), plus "Worker other" (the rest).  "VCF record
construction" is nested in "Genotyping (adaptive)" and counted in it.
Beside the timers a worker hands over its spans: "ML traces", the
seconds of its native trace batches on either of its threads, which
overlap its timers and are no part of the partition.  The parent reads
each worker's pipe on a thread of its own, so neither side can block the
other with a full pipe.  A device error ends
the run; a worker that dies ends it too (its closed pipe's EOFError is
raised in the main loop), and the other workers are terminated.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import threading
import time
from dataclasses import fields
from typing import Dict, List, Optional

from ..io.regions import read_regions
from .executor import (BatchedAligner, EMStats, LocusWorkItem, close_outputs,
                       device_em_enabled, device_post_enabled,
                       dispatch_devices, open_vcf, solve_em, _fetch)
from .pool_worker import worker_main


def add_worker_timers(pipeline, totals: Dict[str, float],
                      spans: Dict[str, float]) -> None:
    """Add a worker's handed-over timer totals and spans (seconds of a
    piece of work on any of its threads, beside its timers' partition of
    its wall) to the parent's timers, each under "<name> (workers)"."""
    for name, secs in (*totals.items(), *spans.items()):
        pipeline.timer.add_time(f"{name} (workers)", secs)


class _ReadyItem(LocusWorkItem):
    """A worker's packed locus awaiting a dispatch: BatchedAligner groups it
    by LocusWorkItem.shape_key (the period is runtime data); `order` is
    its BED index and `worker` the worker that owns it."""

    def __init__(self, idx: int, arrays, statics, worker: int):
        super().__init__(arrays, statics, order=idx)
        self.worker = worker


def run_pooled(pipeline, regions_bed: str, out_vcf: Optional[str], device,
               worker_spec: dict, n_workers: int = 3, batch_size: int = 32,
               full_command: str = "hipstr-tpu-torch", devices=None):
    """Worker-pool analogue of executor.run_batched; the same VCF.  The
    parent never runs per-locus host phases: it routes messages, stacks
    ready tensors, and owns every device call, each dispatch sharded over
    `devices` (default every local device of `device`) and the device EM
    on the first of them."""
    opts = pipeline.opts
    devices = dispatch_devices(device, devices)
    device = devices[0]
    em_device = device_em_enabled(opts, device)
    worker_spec = dict(worker_spec, device_post=device_post_enabled(device),
                       device_em=em_device)
    regions = list(read_regions(regions_bed, opts.max_regions, opts.chrom,
                                opts.locus_shard))
    # loci staged before a dispatch or an EM wave (the JAX pool's default)
    window = batch_size * 4
    writer = open_vcf(pipeline, out_vcf, full_command)

    ctx = mp.get_context("spawn")
    conns, procs = [], []
    aligner = BatchedAligner(devices, opts.dtype, batch_size, pipeline.logger)
    em_stats = EMStats()
    ready: List[_ReadyItem] = []
    em_jobs: List[tuple] = []        # (idx, worker, EMProblem)
    settled: Dict[int, tuple] = {}   # idx -> (rec, viz)
    viz_records: List[tuple] = []
    reports: List[dict] = []
    next_emit = next_region = n_settled = 0
    # loci settled in BED order so far, read by a progress sampler
    pipeline.loci_done = 0
    n_regions = len(regions)
    outstanding = [0] * n_workers    # preps + lls awaiting a reply per worker
    PREFETCH = max(8, window // max(1, n_workers))

    # fetch threads: each device -> host copy waits for its dispatch with
    # the GIL released, overlapping message routing and the next dispatch;
    # an error in a fetch is handed to the main loop and raised there
    fetched: queue.Queue = queue.Queue()
    inflight_q: queue.Queue = queue.Queue()
    fetch_t = [0.0]
    fetch_lock = threading.Lock()
    n_inflight = 0

    def fetch_loop():
        while True:
            item = inflight_q.get()
            if item is None:
                return
            chunk, handle = item
            t0 = time.perf_counter()
            try:
                res = _fetch(handle)
            except BaseException as exc:   # raised in the main loop
                fetched.put((None, exc))
                continue
            with fetch_lock:
                fetch_t[0] += time.perf_counter() - t0
            fetched.put((chunk, res))

    N_FETCHERS = 4
    fetchers = [threading.Thread(target=fetch_loop, daemon=True)
                for _ in range(N_FETCHERS)]

    def drain_settled():
        nonlocal next_emit
        while next_emit in settled:
            rec, viz = settled.pop(next_emit)
            if rec is not None and writer is not None:
                writer.add_vcf_record(rec[0], rec[1], rec[2])
            if viz is not None:
                viz_records.append(viz)
            next_emit += 1
            pipeline.loci_done = next_emit

    def feed_preps():
        nonlocal next_region
        while next_region < n_regions:
            w = min(range(n_workers), key=lambda i: outstanding[i])
            if outstanding[w] >= PREFETCH:
                return
            idx = next_region
            pipeline.logger.log(f"Preparing region {regions[idx]} ...")
            conns[w].send(("prep", idx, regions[idx]))
            outstanding[w] += 1
            next_region += 1

    t_spawn, t_first = 0.0, None
    timer = pipeline.timer

    def handle_msg(w, msg):
        nonlocal n_settled, t_first
        if t_first is None:
            t_first = time.perf_counter() - t_spawn
        tag = msg[0]
        if tag == "ready":
            outstanding[w] -= 1
            ready.append(_ReadyItem(msg[1], msg[2], msg[3], w))
        elif tag == "settled":
            outstanding[w] -= 1
            settled[msg[1]] = (msg[2], msg[3])
            n_settled += 1
        elif tag == "em":
            outstanding[w] -= 1
            em_jobs.append((msg[1], w, msg[2]))
        elif tag == "log":
            pipeline.logger.log(msg[1])
        elif tag == "timers":
            add_worker_timers(pipeline, msg[1], msg[2])
        else:
            raise RuntimeError(f"worker {w} sent {tag!r}")

    # one reader thread per worker moves its messages into the inbox as
    # they arrive: a worker blocked sending a large "ready" to the parent
    # while the parent sends it a run of "ll" messages would otherwise
    # fill both pipes and deadlock the pair
    inbox: queue.Queue = queue.Queue()

    def read_loop(w, conn):
        try:
            while True:
                msg = conn.recv()
                inbox.put((w, msg))
                if msg[0] == "fin":
                    return
        except (EOFError, OSError) as exc:   # raised in the main loop
            inbox.put((w, exc))

    def next_msg(timeout):
        """The inbox's next (worker, message), waiting up to `timeout` s
        (None: until one arrives); a dead worker's pipe error is raised."""
        w, msg = inbox.get(timeout=timeout)
        if isinstance(msg, BaseException):
            raise msg
        return w, msg

    def wait_state() -> str:
        """The state of the loop blocked now."""
        if n_inflight:
            return "Pool wait fetch"
        return "Pool wait fill" if ready or em_jobs else "Pool wait idle"

    def waited(get, timeout: float):
        """get(timeout=timeout); one that may block (timeout > 0) is timed
        in its wait state, apart from the handling of what it returns."""
        if timeout <= 0:
            return get(timeout=0.0)
        timer.switch(wait_state())
        try:
            return get(timeout=timeout)
        finally:
            timer.switch("Pool route")

    def poll_workers(timeout=0.0):
        """Handle every waiting message, waiting up to `timeout` s for the
        first."""
        got = False
        while True:
            try:
                w, msg = waited(next_msg, timeout if not got else 0.0)
            except queue.Empty:
                return got
            handle_msg(w, msg)
            got = True

    def solve_em_jobs():
        """Learn every staged locus's stutter model in one device call
        (run_batched.solve_staged_em parity), then reply to the owners."""
        nonlocal em_jobs
        jobs, em_jobs = em_jobs, []
        timer.switch("Stutter estimation (device)")
        params, conv = solve_em([j[2] for j in jobs], opts, device, em_stats)
        timer.switch("Pool send")
        for i, (idx, w, _prob) in enumerate(jobs):
            conns[w].send(("emr", idx, tuple(float(x) for x in params[i]),
                           bool(conv[i])))
            outstanding[w] += 1
        timer.switch("Pool route")

    def dispatch_ready():
        nonlocal ready, n_inflight
        timer.switch("Pool dispatch")
        for item in ready:
            aligner.add(item)
        ready = []
        for chunk, handle in aligner.dispatch_all():
            n_inflight += 1
            inflight_q.put((chunk, handle))
        timer.switch("Pool route")

    def send_lls(chunk, res) -> None:
        timer.switch("Pool send")
        if isinstance(res, tuple):
            LL_all, post_all, tot_all = res
        else:
            LL_all, post_all, tot_all = res, None, None
        for gi, item in enumerate(chunk):
            P_real, H_real = item.statics[5], item.statics[6]
            msg = ("ll", item.order, LL_all[gi, :P_real, :H_real])
            if post_all is not None:
                msg += (post_all[gi], tot_all[gi])
            conns[item.worker].send(msg)
            outstanding[item.worker] += 1
        timer.switch("Pool route")

    def drain_fetched(block: bool = False) -> bool:
        nonlocal n_inflight
        got = False
        while True:
            try:
                chunk, res = waited(fetched.get,
                                    0.05 if block and not got else 0.0)
            except queue.Empty:
                return got
            if chunk is None:
                raise res
            n_inflight -= 1
            send_lls(chunk, res)
            got = True

    readers: List[threading.Thread] = []
    clean = False
    try:
        t_spawn = time.perf_counter()
        with pipeline.timer.time("Worker spawn"):
            for _ in range(n_workers):
                parent_conn, child_conn = ctx.Pipe()
                proc = ctx.Process(target=worker_main,
                                   args=(child_conn, worker_spec),
                                   daemon=True)
                proc.start()
                child_conn.close()
                conns.append(parent_conn)
                procs.append(proc)
        readers += [threading.Thread(target=read_loop, args=(w, c),
                                     daemon=True) for w, c in enumerate(conns)]
        for r in readers:
            r.start()
        for f in fetchers:
            f.start()

        # every second of the loop in one state, from here to the last
        # drain_settled (see the module's docstring)
        t_loop = timer.switch("Pool route")
        while n_settled < n_regions:
            feed_preps()
            poll_workers(timeout=0.001)
            drain_settled()
            drain_fetched()
            # dispatch once enough work is staged, or when nothing else can
            # make progress
            idle = not n_inflight and not any(outstanding)
            starved = next_region >= n_regions and idle
            if em_jobs and (len(em_jobs) >= window or starved
                            or (not ready and idle)):
                solve_em_jobs()
                continue
            if ready and (len(ready) >= window or starved or idle):
                dispatch_ready()
            if not ready and not n_inflight and n_settled < n_regions:
                if not poll_workers(timeout=0.05):
                    timer.switch(wait_state())
                    time.sleep(0.005)
                    timer.switch("Pool route")
            elif n_inflight and not poll_workers():
                drain_fetched(block=True)
        drain_settled()
        timer.add_time("Pool loop", timer.switch(None) - t_loop)
        totals = timer.totals
        timer.add_time("Pool idle", totals.get("Pool wait idle", 0.0)
                       + totals.get("Pool wait fetch", 0.0))
        timer.add_time("Device fetch", fetch_t[0])
        # spawn to the first reply: the workers' interpreter start and
        # imports, and their first locus
        timer.add_time("Worker start", t_first or 0.0)

        # collect the workers' counters, models, timers and reports
        for c in conns:
            c.send(("fin",))
        while len(reports) < n_workers:
            w, msg = next_msg(None)
            if msg[0] != "fin":
                handle_msg(w, msg)
                continue
            _, counters, stutter_out, timer_totals, spans, report = msg
            for f in fields(counters):
                setattr(pipeline.counters, f.name,
                        getattr(pipeline.counters, f.name)
                        + getattr(counters, f.name))
            pipeline._stutter_out.update(stutter_out)
            add_worker_timers(pipeline, timer_totals, spans)
            reports.append(report)
        for c in conns:
            c.close()
        for proc in procs:
            proc.join(timeout=10)
        clean = True
    finally:
        timer.switch(None)      # a loop that raised leaves its state open
        for _ in fetchers:
            inflight_q.put(None)
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
        if not clean:
            for proc in procs:
                proc.join(timeout=10)
        # no thread of the run outlives it: a daemon thread still waking
        # when the interpreter exits can abort it from inside torch
        for t in fetchers + readers:
            if t.is_alive():
                t.join(timeout=10)
    bad = [r for r in reports if r.get("cuda_initialized")
           or r["jax_loaded"]]
    if bad:
        raise RuntimeError(f"a worker initialised CUDA or loaded JAX: {bad}")

    if pipeline.viz_writer is not None:
        for row in sorted(viz_records, key=lambda r: (r[0], r[1])):
            pipeline.viz_writer.add(*row)
    close_outputs(pipeline, writer)
    pipeline.last_run_stats = dict(
        dispatches=int(aligner.dispatches),
        card_shards=int(aligner.card_shards), cards=len(set(devices)),
        shards_per_dispatch=len(devices), workers=reports,
        workers_with_torch=sum(bool(r.get("torch_loaded")) for r in reports),
        **em_stats.as_dict())
    return pipeline.counters
