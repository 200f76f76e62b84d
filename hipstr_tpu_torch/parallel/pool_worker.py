"""The host worker of the pool (parallel/workers.run_pooled): the side of
the pool that never touches a device, and never imports torch.

A worker runs every per-locus host phase of its loci: BAM decode, read
filtering, the host stutter EM (or the staging of the device EM's
problem), haplotype generation, pooling, the adaptive allele loop,
ML-trace retracing and VCF record assembly (reference:
src/bam_processor.cpp:173-474, src/genotyper_bam_processor.cpp:161-289,
src/seq_stutter_genotyper.cpp:603-671), all of it numpy and the native
host library.  It packs each round's inputs as numpy arrays
(pipeline/locus_pack.prepare_locus) and the parent moves them to the
device.  Nothing this module imports, directly or through other modules,
imports torch, nor does what the spawn unpickles (`worker_main`, the
worker's spec and its PipelineOptions), so a worker spends no memory or
start-up time on it; its "fin" report says whether torch got loaded all
the same (`torch_loaded`, with `cuda_initialized` where it did) and gives
its anonymous memory then (`anon_mib`).  The messages, and the timers a
worker hands over, are set out in parallel/workers.py.

A worker overlaps its loci's native ML traces with its own Python, as the
in-process executor does (parallel/executor.run_batched): after each task
it reads every message its pipe already holds into a queue, which it
works through in arrival order.  It keeps its one trace thread fed:
before each task, if that thread has no batch left to run, the first
queued "ll" not yet installed is installed (LLs and posteriors) and its
round's traces are marshalled and handed to the thread
(SeqStutterGenotyper.prefetch_traces), which runs the native batch with
the GIL released; the locus collects them when its turn comes.  A locus
whose adaptive loop ends starts its record's traces the same way and
builds the record after one more task.  Loci are installed only as fast
as the thread traces them, and records wait one task, since a locus
installed or finished holds ~1-2 MiB until its turn: installing every
queued reply at once, or queueing records behind the whole queue, costs
several times that in memory for no more overlap.  The "fin" report
counts the trace jobs (pool, haplotype) prefetched, traced on the main
thread and discarded stale (`trace_jobs_*`); the traces' seconds, on
either thread, are handed over as the span "ML traces".
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import sys
import time
from collections import deque
from typing import Dict, Optional

from ..ops.em_problem import EMProblem

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


def em_problem(pipeline, region, chrom_seq: str):
    """Stage 1 of a locus whose stutter model the device EM learns:
    (prepared reads, EMProblem), or None when the locus stops here (its
    counter updated)."""
    prep = pipeline.prepare_reads(region, chrom_seq)
    if prep is None:
        return None
    with pipeline.timer.time("Stutter estimation"):
        inputs = pipeline.stutter_em_inputs(prep.alns_by_rg, prep.log_p1s,
                                            prep.log_p2s, region)
    if inputs is None:
        return None
    return prep, EMProblem.build(prep.haploid, region.period, *inputs)


def worker_main(conn, spec: dict) -> None:
    """One host worker's life: build the pipeline from `spec`, serve the
    parent's messages until "fin", then report (module docstring)."""
    # the parent owns the card: hide it, should anything load CUDA
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    # one native-trace thread per batch: the pool already occupies the
    # cores
    os.environ.setdefault("HIPSTR_TRACE_THREADS", "1")

    from ..models.stutter import StutterModel
    from ..pipeline.genotyper import TraceTally
    from ..pipeline.locus_pack import prepare_locus
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
    host_posteriors = 0   # rounds whose posteriors this worker computed
    chrom = None
    chrom_seq = None
    timer = pipeline.timer
    # the tasks in arrival order: the parent's messages, and ("record",
    # idx) for a finished locus
    tasks: deque = deque()
    # idx -> installed, of each "ll" installed ahead of its turn
    ahead: Dict[int, bool] = {}
    tracing = None    # the Future of the last batch sent to the thread
    # the native trace batches run on one thread of their own (the batch
    # releases the GIL) while the main thread steps the loci ahead
    trace_pool = cf.ThreadPoolExecutor(max_workers=1)
    tally = TraceTally()

    def send(msg) -> None:
        with timer.time("Worker send"):
            conn.send(msg)

    def fail(idx, region, exc) -> None:
        pipeline.counters.genotype_fail += 1
        send(("log", f"ERROR at {region}: {exc!r}"))
        send(("settled", idx, None, None))

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
            send(("settled", idx, None, None))
            return
        g.trace_tally = tally
        items[idx] = (region, g, None, local_seq)
        send(("ready", idx, *packed))

    def do_prep(idx, region):
        nonlocal chrom, chrom_seq
        if region.stop - region.start > opts.max_str_len:
            pipeline.counters.too_long += 1
            send(("settled", idx, None, None))
            return
        if region.chrom != chrom:
            chrom = region.chrom
            chrom_seq = pipeline.fasta.get_sequence(chrom)
        try:
            if device_em:
                staged = em_problem(pipeline, region, chrom_seq)
                if staged is None:
                    send(("settled", idx, None, None))
                    return
                prep, prob = staged
                em_pending[idx] = (region, prep, chrom_seq)
                send(("em", idx, prob))
                return
            g = pipeline.prepare_locus_genotyper(region, chrom_seq)
            if g is None:
                send(("settled", idx, None, None))
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
                send(("log", f"Stutter EM failed for {region}"))
                send(("settled", idx, None, None))
                return
            model = StutterModel(*params, region.period)
            pipeline.register_learned_model(region, model)
            if opts.skip_genotyping:
                send(("settled", idx, None, None))
                return
            g = pipeline.finish_prepare(prep, region, local_seq, model)
            if g is None:
                send(("settled", idx, None, None))
                return
            stage(idx, region, g, local_seq)
        except Exception as exc:
            fail(idx, region, exc)

    def prefetch(g) -> None:
        """Start the traces the locus's current posteriors need on the
        trace thread, a batch of one native thread: those of each read's
        ML haplotype alone, as the next step traces them (the record's
        differ only in reads its strand tolerance weighs alike; the
        superset would double a worker's trace work)."""
        nonlocal tracing
        fut = g.prefetch_traces(trace_pool, n_threads=0, superset=False)
        if fut is not None:
            tracing = fut

    def install(idx, LL, post=None, totals=None) -> bool:
        """Install a round's LLs and posteriors and start its traces on
        the trace thread; False if the locus failed."""
        nonlocal host_posteriors
        region, g, _, _ = items[idx]
        try:
            with timer.time("LL install"):
                g.set_pool_lls(LL)
            with timer.time("Genotyping (adaptive)"):
                if post is not None:
                    S, A = g.num_samples, g.num_alleles
                    g.install_posteriors(post[:S, :A, :A], totals[:S])
                else:
                    g.calc_log_sample_posteriors()
                    host_posteriors += 1
                prefetch(g)
            return True
        except Exception as exc:
            del items[idx]
            fail(idx, region, exc)
            return False

    def do_step(idx):
        """The next adaptive round of an installed locus: a realignment
        to ask for, or the end of its loop."""
        region, g, gen, local_seq = items[idx]
        try:
            with timer.time("Genotyping (adaptive)"):
                if gen is None:
                    gen = g.adaptive_steps(opts.max_haps,
                                           opts.max_hap_flanks,
                                           opts.min_flank_freq)
                    items[idx] = (region, g, gen, local_seq)
                try:
                    next(gen)
                except StopIteration as stop:
                    if stop.value:
                        # the record's traces run while the next task does
                        prefetch(g)
                        tasks.insert(min(1, len(tasks)), ("record", idx))
                        return
                    del items[idx]
                    pipeline.counters.genotype_fail += 1
                    conn.send(("settled", idx, None, None))
                    return
            packed = pack(g)
            if packed is None:
                raise RuntimeError("no reads to realign")
            send(("ready", idx, *packed))
        except Exception as exc:
            items.pop(idx, None)
            fail(idx, region, exc)

    def do_record(idx):
        region, g, _, local_seq = items.pop(idx)
        try:
            with timer.time("Genotyping (adaptive)"):
                rec, viz = build_record(g, region, local_seq)
                # sent inside "Genotyping (adaptive)", which
                # adaptive_ms_per_locus reads; so not in "Worker send"
                conn.send(("settled", idx, rec, viz))
        except Exception as exc:
            fail(idx, region, exc)

    def install_ahead() -> None:
        """While the trace thread has nothing to run, install the first
        queued "ll" not yet installed, so that its traces run while the
        main thread works on the task in hand."""
        if tracing is not None and not tracing.done():
            return
        for task in tasks:
            if task[0] == "ll" and task[1] not in ahead:
                ahead[task[1]] = install(task[1], *task[2:])
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
        traced = tally.seconds
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
            ok = ahead.pop(idx) if idx in ahead else install(*task[1:])
        install_ahead()
        if tag == "prep":
            do_prep(task[1], task[2])
        elif tag == "ll":
            if ok:
                do_step(idx)
        elif tag == "record":
            do_record(task[1])
        elif tag == "emr":
            do_emr(task[1], task[2], task[3])
        elif tag == "fin":
            trace_pool.shutdown(wait=True)
            torch = sys.modules.get("torch")
            report = dict(
                pid=os.getpid(),
                torch_loaded=torch is not None,
                anon_mib=anon_mib(),
                host_posteriors=host_posteriors,
                jax_loaded=sorted(
                    m for m, mod in sys.modules.items() if mod is not None
                    and m.split(".")[0] in ("jax", "hipstr_tpu")),
                **{f"trace_jobs_{k}": n for k, n in tally.jobs.items()})
            if torch is not None:
                report["cuda_initialized"] = bool(torch.cuda.is_initialized())
            send(("fin", pipeline.counters, pipeline._stutter_out,
                  *hand_over(), report))
            conn.close()
            return
        if time.perf_counter() - t_handed >= TIMERS_EVERY_S:
            send(("timers", *hand_over()))
