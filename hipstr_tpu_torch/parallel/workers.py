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
    src/seq_stutter_genotyper.cpp:603-671), each on its own core.  They
    never touch the card: `CUDA_VISIBLE_DEVICES` is empty before any CUDA
    call, and each reports at the end that CUDA stayed uninitialised.
  * the *parent* owns the cards and every dispatch: the same shape-grouped
    batched alignments as the in-process executor (parallel/executor.py),
    each sharded over the same devices, and, without a stutter model on
    the card, the batched EM of the staged problems on the first card.

Messages (pickled over pipes):
  parent -> worker: ("prep", idx, region), ("ll", idx, LL[, post, totals]),
                    ("emr", idx, params, converged), ("fin",)
  worker -> parent: ("ready", idx, arrays, statics), ("em", idx, EMProblem),
                    ("settled", idx, record, viz), ("log", text),
                    ("fin", counters, stutter models, timers, report)
They carry the packed int8/uint8 tensors, so a locus costs a few KB.  VCF
records come back tagged with their BED index and enter the writer in BED
order.  The parent reads each worker's pipe on a thread of its own, so
neither side can block the other with a full pipe.  A device error ends
the run; a worker that dies ends it too (its closed pipe's EOFError is
raised in the main loop), and the other workers are terminated.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import sys
import threading
import time
from dataclasses import fields
from typing import Dict, List, Optional

from ..io.regions import read_regions
from .executor import (BatchedAligner, EMStats, LocusWorkItem, close_outputs,
                       device_em_enabled, device_post_enabled,
                       dispatch_devices, em_problem, open_vcf, solve_em,
                       _fetch)


# --------------------------------------------------------------- worker side


def _worker_main(conn, spec: dict) -> None:
    # the parent owns the card: hide it before anything can initialise CUDA
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    # one native-trace thread and one torch thread per worker: the pool
    # already occupies the cores
    os.environ.setdefault("HIPSTR_TRACE_THREADS", "1")
    import torch
    torch.set_num_threads(1)

    from ..models.stutter import StutterModel
    from ..pipeline.hap_aligner import prepare_locus
    from ..pipeline.processor import GenotyperPipeline, Logger
    from ..pipeline.vcf_record import build_vcf_record

    opts = spec["opts"]
    want_viz = bool(opts.viz_out)
    opts.viz_out = None              # parent owns the real viz stream
    if want_viz:
        opts.output.viz_out = True
    pipeline = GenotyperPipeline(spec["bam_paths"], spec["fasta_path"], opts,
                                 Logger(quiet=True),
                                 bam_samps=spec["bam_samps"],
                                 bam_libs=spec["bam_libs"],
                                 lib_field=spec["lib_field"])
    dtype = opts.dtype
    # the parent fuses the genotype posteriors into its dispatches on the
    # card: workers install those instead of recomputing them on the host,
    # so pooled and in-process runs take the same adaptive decisions
    device_post = bool(spec["device_post"])
    # stutter models learned on the parent's device in batched waves, as
    # in-process: workers ship the EM problem up and resume on the reply
    device_em = bool(spec["device_em"])
    # idx -> (region, genotyper, adaptive generator, chrom_seq)
    items: Dict[int, tuple] = {}
    em_pending: Dict[int, tuple] = {}  # idx -> (region, prep, chrom_seq)
    chrom = None
    chrom_seq = None

    def fail(idx, region, exc) -> None:
        pipeline.counters.genotype_fail += 1
        conn.send(("log", f"ERROR at {region}: {exc!r}"))
        conn.send(("settled", idx, None, None))

    def build_record(g, region, local_seq):
        pipeline.counters.genotype_success += 1
        with pipeline.timer.time("VCF record construction"):
            chrom_, pos, text, stats = build_vcf_record(
                g, pipeline.samples, opts.output)
        viz = None
        if want_viz and stats.viz_data is not None:
            from ..pipeline.viz import visualize_alignments
            alns_by_sample = {}
            for s, entries in enumerate(stats.viz_data):
                if entries:
                    one = sorted((a for st, a in entries if st == 0),
                                 key=lambda a: a.start)
                    two = sorted((a for st, a in entries if st == 1),
                                 key=lambda a: a.start)
                    alns_by_sample[g.sample_names[s]] = one + two
            html = visualize_alignments(
                alns_by_sample, stats.sample_gb, local_seq,
                region.chrom, region.start, region.stop)
            viz = (region.chrom, region.start + 1, region.stop, html)
        return (chrom_, pos, text), viz

    def pack(g):
        with pipeline.timer.time("Locus packing"):
            seqs, quals, seeds = g.pool_inputs()
            if not seqs:
                return None
            return prepare_locus(
                g.align_haplotype(), seqs, quals, seeds, dtype,
                post_meta=g.posterior_meta() if device_post else None,
                read_cache=g.__dict__.setdefault("_read_pack_cache", {}))

    def stage(idx, region, g, local_seq):
        packed = pack(g)
        if packed is None:
            pipeline.counters.genotype_fail += 1
            conn.send(("settled", idx, None, None))
            return
        items[idx] = (region, g, None, local_seq)
        conn.send(("ready", idx, *packed))

    def do_prep(idx, region):
        nonlocal chrom, chrom_seq
        if region.stop - region.start > opts.max_str_len:
            pipeline.counters.too_long += 1
            conn.send(("settled", idx, None, None))
            return
        if region.chrom != chrom:
            chrom = region.chrom
            chrom_seq = pipeline.fasta.get_sequence(chrom)
        try:
            if device_em:
                staged = em_problem(pipeline, region, chrom_seq)
                if staged is None:
                    conn.send(("settled", idx, None, None))
                    return
                prep, prob = staged
                em_pending[idx] = (region, prep, chrom_seq)
                conn.send(("em", idx, prob))
                return
            g = pipeline.prepare_locus_genotyper(region, chrom_seq)
            if g is None:
                conn.send(("settled", idx, None, None))
                return
            stage(idx, region, g, chrom_seq)
        except Exception as exc:  # skip-and-continue, like the reference
            fail(idx, region, exc)

    def do_emr(idx, params, converged):
        """Resume a locus whose stutter model the parent learned
        (run_batched.solve_staged_em parity)."""
        region, prep, local_seq = em_pending.pop(idx)
        try:
            if not converged:
                pipeline.counters.em_fail += 1
                conn.send(("log", f"Stutter EM failed for {region}"))
                conn.send(("settled", idx, None, None))
                return
            model = StutterModel(*params, region.period)
            pipeline.register_learned_model(region, model)
            if opts.skip_genotyping:
                conn.send(("settled", idx, None, None))
                return
            g = pipeline.finish_prepare(prep, region, local_seq, model)
            if g is None:
                conn.send(("settled", idx, None, None))
                return
            stage(idx, region, g, local_seq)
        except Exception as exc:
            fail(idx, region, exc)

    def do_ll(idx, LL, post=None, totals=None):
        region, g, gen, local_seq = items[idx]
        try:
            g.set_pool_lls(LL)
            with pipeline.timer.time("Genotyping (adaptive)"):
                if post is not None:
                    S, A = g.num_samples, g.num_alleles
                    g.install_posteriors(post[:S, :A, :A], totals[:S])
                else:
                    g.calc_log_sample_posteriors()
                if gen is None:
                    gen = g.adaptive_steps(opts.max_haps,
                                           opts.max_hap_flanks,
                                           opts.min_flank_freq)
                    items[idx] = (region, g, gen, local_seq)
                try:
                    next(gen)
                except StopIteration as stop:
                    del items[idx]
                    if stop.value:
                        rec, viz = build_record(g, region, local_seq)
                        conn.send(("settled", idx, rec, viz))
                    else:
                        pipeline.counters.genotype_fail += 1
                        conn.send(("settled", idx, None, None))
                    return
            packed = pack(g)
            if packed is None:
                raise RuntimeError("no reads to realign")
            conn.send(("ready", idx, *packed))
        except Exception as exc:
            items.pop(idx, None)
            fail(idx, region, exc)

    idle_t = 0.0
    while True:
        t0 = time.perf_counter()
        msg = conn.recv()
        idle_t += time.perf_counter() - t0
        tag = msg[0]
        if tag == "prep":
            do_prep(msg[1], msg[2])
        elif tag == "ll":
            do_ll(msg[1], *msg[2:])
        elif tag == "emr":
            do_emr(msg[1], msg[2], msg[3])
        elif tag == "fin":
            pipeline.timer.add_time("Worker idle", idle_t)
            report = dict(
                pid=os.getpid(),
                cuda_initialized=bool(torch.cuda.is_initialized()),
                jax_loaded=sorted(
                    m for m, mod in sys.modules.items() if mod is not None
                    and m.split(".")[0] in ("jax", "hipstr_tpu")))
            conn.send(("fin", pipeline.counters, pipeline._stutter_out,
                       pipeline.timer.totals, report))
            conn.close()
            return


# --------------------------------------------------------------- parent side


class _ReadyItem(LocusWorkItem):
    """A worker's packed locus awaiting a dispatch: BatchedAligner groups it
    by LocusWorkItem.shape_key (the period is runtime data); `order` is
    its BED index and `worker` the worker that owns it."""

    def __init__(self, idx: int, arrays, statics, worker: int):
        super().__init__(None, None, arrays, statics, None, order=idx)
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

    def poll_workers(timeout=0.0):
        """Handle every waiting message, waiting up to `timeout` s for the
        first."""
        got = False
        while True:
            try:
                w, msg = next_msg(timeout if not got else 0.0)
            except queue.Empty:
                return got
            handle_msg(w, msg)
            got = True

    def solve_em_jobs():
        """Learn every staged locus's stutter model in one device call
        (run_batched.solve_staged_em parity), then reply to the owners."""
        nonlocal em_jobs
        jobs, em_jobs = em_jobs, []
        with pipeline.timer.time("Stutter estimation (device)"):
            params, conv = solve_em([j[2] for j in jobs], opts, device,
                                    em_stats)
        for i, (idx, w, _prob) in enumerate(jobs):
            conns[w].send(("emr", idx, tuple(float(x) for x in params[i]),
                           bool(conv[i])))
            outstanding[w] += 1

    def dispatch_ready():
        nonlocal ready, n_inflight
        for item in ready:
            aligner.add(item)
        ready = []
        for chunk, handle in aligner.dispatch_all():
            n_inflight += 1
            inflight_q.put((chunk, handle))

    def send_lls(chunk, res) -> None:
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

    def drain_fetched(block: bool = False) -> bool:
        nonlocal n_inflight
        got = False
        while True:
            try:
                chunk, res = fetched.get(timeout=0.05 if block and not got
                                         else 0.0)
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
                proc = ctx.Process(target=_worker_main,
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

        t_poll = t_idle = 0.0
        while n_settled < n_regions:
            feed_preps()
            t0 = time.perf_counter()
            poll_workers(timeout=0.001)
            t_poll += time.perf_counter() - t0
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
                t0 = time.perf_counter()
                if not poll_workers(timeout=0.05):
                    time.sleep(0.005)
                t_idle += time.perf_counter() - t0
            elif n_inflight and not poll_workers():
                t0 = time.perf_counter()
                drain_fetched(block=True)
                t_idle += time.perf_counter() - t0
        drain_settled()
        pipeline.timer.add_time("Device fetch", fetch_t[0])
        pipeline.timer.add_time("Pool poll", t_poll)
        pipeline.timer.add_time("Pool idle", t_idle)
        # spawn to the first reply: the workers' interpreter start and
        # imports, and their first locus
        pipeline.timer.add_time("Worker start", t_first or 0.0)

        # collect the workers' counters, models, timers and reports
        for c in conns:
            c.send(("fin",))
        while len(reports) < n_workers:
            w, msg = next_msg(None)
            if msg[0] != "fin":
                handle_msg(w, msg)
                continue
            _, counters, stutter_out, timer_totals, report = msg
            for f in fields(counters):
                setattr(pipeline.counters, f.name,
                        getattr(pipeline.counters, f.name)
                        + getattr(counters, f.name))
            pipeline._stutter_out.update(stutter_out)
            for name, secs in timer_totals.items():
                pipeline.timer.add_time(f"{name} (workers)", secs)
            reports.append(report)
        for c in conns:
            c.close()
        for proc in procs:
            proc.join(timeout=10)
        clean = True
    finally:
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
    bad =[r for r in reports if r["cuda_initialized"] or r["jax_loaded"]]
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
        **em_stats.as_dict())
    return pipeline.counters
