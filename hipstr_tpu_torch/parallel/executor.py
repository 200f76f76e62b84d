"""Multi-locus batched execution on one torch device.

Counterpart of hipstr_tpu/parallel/executor.py.  The host prepares a wave
of loci (filters, haplotype generation, pooling, seeds), groups them by
kernel shape, and dispatches every group's read<->haplotype alignment
(K1 emission + K2 segment forward per orientation, seed combination, and
on the card the fused posteriors) before fetching any result, so device
work overlaps host work across waves.  The adaptive per-locus rounds
regroup and dispatch together.

Differences from the JAX executor: chunks are stacked with numpy and moved
with `torch.from_numpy(...).to(device)`; the locus axis is padded only to
the real group size (kernels take runtime extents); the period is always
runtime data, so groups merge across periods.  Only host errors are
counted per locus (`genotype_fail`): an exception from a dispatch, a
kernel build or launch, or a fetch propagates and fails the run.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_dtype
from ..io.regions import read_regions
from ..io.vcf_write import VCFWriter, build_vcf_header
from ..models.stutter import write_stutter_models
from ..ops.hmm2 import batched_forward
from ..ops.posteriors import batched_pool_posteriors
from ..pipeline.hap_aligner import locus_to_torch, prepare_locus, stack_arrays
from ..pipeline.vcf_record import build_vcf_record


def _leaf_shapes(x) -> tuple:
    if isinstance(x, dict):
        return tuple(_leaf_shapes(x[k]) for k in sorted(x))
    if isinstance(x, tuple):
        return tuple(_leaf_shapes(v) for v in x)
    return np.shape(x)


class LocusWorkItem:
    def __init__(self, region, genotyper, arrays, statics, chrom_seq,
                 order=0):
        self.region = region
        self.genotyper = genotyper
        self.arrays = arrays
        self.statics = statics
        self.chrom_seq = chrom_seq
        self.order = order
        self.gen = None   # resumable adaptive loop, created after initial LLs
        self.rounds = 0   # device dispatches this locus has ridden

    def shape_key(self):
        # the period is runtime data: groups merge across periods
        st = self.statics
        return (st[:4] + (st[7],), _leaf_shapes(self.arrays))


class BatchedAligner:
    """Groups per-locus prepared arrays by kernel shape and dispatches each
    group as one (or a few) batched device calls, all enqueued before any
    caller fetches."""

    def __init__(self, device: torch.device, dtype: str = "float32",
                 batch_size: int = 32, logger=None):
        self.device = device
        self.torch_dtype = resolve_dtype(dtype)
        self.batch_size = batch_size
        self.groups: Dict[tuple, List[LocusWorkItem]] = {}
        self.logger = logger
        # per-shape dispatch accounting: key -> [dispatches, loci]
        self.stats: Dict[tuple, list] = {}
        self.dispatches = 0
        self.round_hist: Dict[int, int] = {}
        self.spec_hits = 0
        self.spec_misses = 0

    def finalize(self, item) -> None:
        """Record a settled locus's round count and speculation totals."""
        self.round_hist[item.rounds] = self.round_hist.get(item.rounds, 0) + 1
        g = item.genotyper
        self.spec_hits += getattr(g, "spec_hits", 0)
        self.spec_misses += getattr(g, "spec_misses", 0)

    def log_stats(self) -> None:
        if self.logger is None or not self.stats:
            return
        for key, (n, real) in sorted(self.stats.items()):
            R_f, R_r = key[:2]
            self.logger.log(f"Dispatch shape R={R_f}+{R_r}: {n} dispatches, "
                            f"{real} loci")
        if self.round_hist:
            hist = ", ".join(f"{r}: {c}" for r, c in
                             sorted(self.round_hist.items()))
            self.logger.log(f"Device rounds per locus: {{{hist}}}")
        if self.spec_hits or self.spec_misses:
            total = self.spec_hits + self.spec_misses
            self.logger.log(
                f"Speculation: {self.spec_hits}/{total} allele-addition "
                f"rounds served by column gather "
                f"({self.spec_misses} realignment dispatches)")

    def add(self, item: LocusWorkItem) -> None:
        self.groups.setdefault(item.shape_key(), []).append(item)

    def dispatch_all(self) -> List[Tuple[List[LocusWorkItem], object]]:
        """Dispatch every pending group (chunked to batch_size); returns
        [(chunk_items, device results)] without waiting for any."""
        out = []
        for key in list(self.groups):
            group = self.groups.pop(key)
            for i in range(0, len(group), self.batch_size):
                chunk = group[i:i + self.batch_size]
                out.append((chunk, self._dispatch_chunk(chunk)))
        return out

    def _dispatch_chunk(self, chunk: List[LocusWorkItem]):
        G = len(chunk)
        st = self.stats.setdefault(tuple(chunk[0].statics[:4]), [0, 0])
        st[0] += 1
        st[1] += G
        self.dispatches += 1
        for it in chunk:
            it.rounds += 1
        dev, dt = self.device, self.torch_dtype
        t = locus_to_torch(stack_arrays([it.arrays for it in chunk]), dev, dt)
        R_f, R_r, sr_f, sr_r = chunk[0].statics[:4]
        Sm = chunk[0].statics[7]
        h_real = torch.tensor([it.statics[6] for it in chunk],
                              dtype=torch.int32).to(dev)
        periods = torch.tensor([it.statics[4] for it in chunk],
                               dtype=torch.int32).to(dev)
        LL = batched_forward(*t[:7], R_f, R_r, sr_f, sr_r, h_real, periods, dt)
        if Sm is None:
            return LL
        log_post, totals = batched_pool_posteriors(LL, t[7], Sm, dt)
        return LL, log_post, totals


def device_post_enabled(device: torch.device) -> bool:
    """Fuse the genotype posteriors into each dispatch on the card; the CPU
    keeps the host float64 posteriors (the golden-parity path)."""
    return device.type == "cuda"


FAILED = object()


def open_vcf(pipeline, out_vcf: Optional[str], full_command: str):
    """The run's VCF writer, or None without an output path."""
    if not out_vcf:
        return None
    header = build_vcf_header(pipeline.fasta_path, full_command,
                              pipeline.fasta.contig_header_lines(),
                              pipeline.samples, pipeline.opts.output)
    return VCFWriter(out_vcf, header)


def close_outputs(pipeline, writer) -> None:
    """Close the run's VCF, viz and pass/filt BAM writers and write
    --stutter-out (the tail of the JAX package's run)."""
    for w in (writer, pipeline.viz_writer, pipeline.pass_writer,
              pipeline.filt_writer):
        if w is not None:
            w.close()
    if pipeline.opts.stutter_out:
        with open(pipeline.opts.stutter_out, "w") as fh:
            write_stutter_models(pipeline._stutter_out, fh)


def _fetch(res):
    if isinstance(res, tuple):
        return tuple(r.cpu().numpy() for r in res)
    return res.cpu().numpy()


def run_batched(pipeline, regions_bed: str, out_vcf: Optional[str],
                device: torch.device, batch_size: int = 32,
                full_command: str = "hipstr-tpu-torch"):
    """Batched genotyping run on `device`; the JAX executor's outputs.

    Needs a fixed stutter model (`def_stutter_model` or `stutter_in`): the
    batched stutter EM is not ported yet."""
    opts = pipeline.opts
    if opts.def_stutter_model is None and not opts.stutter_in:
        raise NotImplementedError(
            "stutter EM is not yet ported to hipstr_tpu_torch: pass a "
            "stutter model (--def-stutter-model or --stutter-in)")
    regions = read_regions(regions_bed, opts.max_regions, opts.chrom,
                           opts.locus_shard)
    writer = open_vcf(pipeline, out_vcf, full_command)

    aligner = BatchedAligner(device, opts.dtype, batch_size, pipeline.logger)
    # records enter the writer in BED order; loci settle out of order
    pending: Dict[int, Tuple] = {}
    next_emit = [0]

    def drain_pending():
        while next_emit[0] in pending:
            rec, viz = pending.pop(next_emit[0])
            if rec is not None and writer is not None:
                writer.add_vcf_record(*rec)
            if viz is not None and pipeline.viz_writer is not None:
                pipeline.viz_writer.add(*viz)
            next_emit[0] += 1

    def settle(order, rec=None, viz=None):
        pending[order] = (rec, viz)
        drain_pending()

    def emit_record(item):
        g = item.genotyper
        pipeline.counters.genotype_success += 1
        with pipeline.timer.time("VCF record construction"):
            chrom, pos, text, stats = build_vcf_record(
                g, pipeline.samples, opts.output)
        viz = None
        if pipeline.viz_writer is not None and stats.viz_data is not None:
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
                alns_by_sample, stats.sample_gb, item.chrom_seq,
                item.region.chrom, item.region.start, item.region.stop)
            viz = (item.region.chrom, item.region.start + 1,
                   item.region.stop, html)
        settle(item.order, (chrom, pos, text), viz)

    use_device_post = device_post_enabled(device)

    def maybe_post_meta(g):
        return g.posterior_meta() if use_device_post else None

    # native trace batches release the GIL; size the pool to spare cores
    trace_pool = cf.ThreadPoolExecutor(
        max_workers=max(2, min(3, (os.cpu_count() or 2) - 1)))
    # fetches start the moment a wave is dispatched, so the copy back
    # overlaps the next wave's host work
    fetch_pool = cf.ThreadPoolExecutor(max_workers=4)

    def install(item, LL, post=None, totals=None) -> None:
        g = item.genotyper
        g.set_pool_lls(LL)
        with pipeline.timer.time("Genotyping (adaptive)"):
            if post is not None:
                g.install_posteriors(post, totals)
            else:
                g.calc_log_sample_posteriors()
        g.prefetch_traces(trace_pool)

    def advance(item) -> str:
        """Step one locus's adaptive loop: 'realign' (item.arrays updated
        for the new haplotype), 'emit' or 'done'."""
        g = item.genotyper
        with pipeline.timer.time("Genotyping (adaptive)"):
            if item.gen is None:
                item.gen = g.adaptive_steps(opts.max_haps,
                                            opts.max_hap_flanks,
                                            opts.min_flank_freq)
            try:
                next(item.gen)
            except StopIteration as stop:
                aligner.finalize(item)
                if stop.value:
                    g.prefetch_traces(trace_pool)
                    return "emit"
                pipeline.counters.genotype_fail += 1
                settle(item.order)
                return "done"
        with pipeline.timer.time("Locus packing"):
            seqs, quals, seeds = g.pool_inputs()
            item.arrays, item.statics = prepare_locus(
                g.align_haplotype(), seqs, quals, seeds, opts.dtype,
                post_meta=maybe_post_meta(g),
                read_cache=g.__dict__.setdefault("_read_pack_cache", {}))
        return "realign"

    def submit_fetch(handles):
        return [(chunk, fetch_pool.submit(_fetch, res))
                for chunk, res in handles]

    def host_step(item, fn, *args):
        """Run one per-locus host step; a host error fails only the locus
        (and returns FAILED)."""
        try:
            return fn(item, *args)
        except Exception as exc:
            aligner.finalize(item)
            pipeline.counters.genotype_fail += 1
            settle(item.order)
            pipeline.logger.log(f"ERROR at {item.region}: {exc!r}")
            return FAILED

    def finish_handles(handles) -> None:
        """Resolve in-flight fetches and drive every adaptive round of the
        wave to completion, regrouping realignments per round."""
        while handles:
            with pipeline.timer.time("Device fetch"):
                handles = [(chunk, fut.result()) for chunk, fut in handles]
            ready: List[LocusWorkItem] = []
            for chunk, res in handles:
                if isinstance(res, tuple):
                    LL_all, post_all, tot_all = res
                else:
                    LL_all, post_all, tot_all = res, None, None
                for gi, item in enumerate(chunk):
                    P_real, H_real = item.statics[5], item.statics[6]
                    post = tot = None
                    if post_all is not None:
                        S = item.genotyper.num_samples
                        A = item.genotyper.num_alleles
                        post = post_all[gi, :S, :A, :A]
                        tot = tot_all[gi, :S]
                    if host_step(item, install, LL_all[gi, :P_real, :H_real],
                                 post, tot) is not FAILED:
                        ready.append(item)
            realign: List[LocusWorkItem] = []
            emit_q: List[LocusWorkItem] = []
            for item in ready:
                r = host_step(item, advance)
                if r == "realign":
                    realign.append(item)
                elif r == "emit":
                    emit_q.append(item)
            for item in emit_q:
                host_step(item, emit_record)
            for item in realign:
                aligner.add(item)
            handles = submit_fetch(aligner.dispatch_all())

    prepared: List[LocusWorkItem] = []
    in_flight: List[Tuple[List[LocusWorkItem], object]] = []

    def stage_locus(g, region, local_chrom_seq, order) -> None:
        with pipeline.timer.time("Locus packing"):
            seqs, quals, seeds = g.pool_inputs()
            if not seqs:
                pipeline.counters.genotype_fail += 1
                settle(order)
                return
            arrays, statics = prepare_locus(
                g.align_haplotype(), seqs, quals, seeds, opts.dtype,
                post_meta=maybe_post_meta(g),
                read_cache=g.__dict__.setdefault("_read_pack_cache", {}))
        prepared.append(
            LocusWorkItem(region, g, arrays, statics, local_chrom_seq, order))

    def launch_wave():
        """Dispatch the prepared loci, then settle the previous wave while
        this one computes."""
        nonlocal prepared, in_flight
        for item in prepared:
            aligner.add(item)
        prepared = []
        handles = submit_fetch(aligner.dispatch_all())
        done, in_flight = in_flight, handles
        finish_handles(done)

    chrom = None
    chrom_seq = None
    try:
        for order, region in enumerate(regions):
            if region.stop - region.start > opts.max_str_len:
                pipeline.counters.too_long += 1
                settle(order)
                continue
            if region.chrom != chrom:
                chrom = region.chrom
                chrom_seq = pipeline.fasta.get_sequence(chrom)
            pipeline.logger.log(f"Preparing region {region} ...")
            # host preparation errors fail the locus; the device wave below
            # runs outside this handler, so device errors end the run
            try:
                g = pipeline.prepare_locus_genotyper(region, chrom_seq)
                if g is None:
                    settle(order)
                    continue
                stage_locus(g, region, chrom_seq, order)
            except Exception as exc:
                pipeline.counters.genotype_fail += 1
                settle(order)
                pipeline.logger.log(f"ERROR at {region}: {exc!r}")
                continue
            if len(prepared) >= batch_size:
                launch_wave()

        launch_wave()            # dispatch the tail, settle the previous wave
        finish_handles(in_flight)
        in_flight = []
    finally:
        trace_pool.shutdown(wait=False)
        fetch_pool.shutdown(wait=False)
    drain_pending()
    aligner.log_stats()
    pipeline.last_run_stats = dict(
        round_hist={int(k): int(v) for k, v in aligner.round_hist.items()},
        spec_hits=int(aligner.spec_hits),
        spec_misses=int(aligner.spec_misses),
        dispatches=int(aligner.dispatches))

    close_outputs(pipeline, writer)
    return pipeline.counters
