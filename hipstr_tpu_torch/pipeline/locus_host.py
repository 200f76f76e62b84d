"""A locus's host life between its device rounds, for both batched
runs: the in-process run (parallel/executor.run_batched) and each host
worker of the pool (parallel/pool_worker.worker_main).

`LocusHost` takes each locus from its region to its VCF record: the
too-long check, the host preparation (read filtering, the host stutter EM
or the staging of the device EM's problem, haplotype generation), the
packing of each round for the device (pipeline/locus_pack.prepare_locus),
the install of each round's LLs and posteriors with the prefetch of its ML
traces, the adaptive allele loop and the record (reference:
src/bam_processor.cpp:173-474, src/genotyper_bam_processor.cpp:161-289,
src/seq_stutter_genotyper.cpp:603-671).  It does no device work and
imports no torch: its caller dispatches the packed rounds and hands their
results back.  It tells the caller what became of a locus through the
caller's `emit`, in the pool's messages (parallel/workers.py):

  ("ready", idx, arrays, statics)  a round packed for the device
  ("em", idx, EMProblem)           staged for the device EM (then `resume`)
  ("settled", idx, record, viz)    done; record None where the locus
                                   failed or stopped, its counter updated
  ("log", text)

A host error fails its locus alone ("ERROR at <region>: <exc>", then
"settled").  The timers are the pipeline's: "Locus packing", "LL
install" and "Genotyping (adaptive)" (the posteriors, the trace prefetch,
the adaptive steps and the record, "VCF record construction" nested in
it).  A record, and the settling of a locus whose adaptive loop failed,
are emitted inside "Genotyping (adaptive)"; every other message outside
this module's timers.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from ..models.stutter import StutterModel
from ..ops.em_problem import EMProblem
from .genotyper import TraceTally
from .locus_pack import prepare_locus
from .vcf_record import build_vcf_record


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


def locus_record(pipeline, g, region, chrom_seq: str):
    """((chrom, pos, text), viz) of a genotyped locus: its VCF record, and
    its visualization row (chrom, start + 1, stop, html) where the run
    writes them, else None.  Its success is counted first."""
    pipeline.counters.genotype_success += 1
    with pipeline.timer.time("VCF record construction"):
        chrom, pos, text, stats = build_vcf_record(g, pipeline.samples,
                                                   pipeline.opts.output)
    viz = None
    if stats.viz_data is not None:
        from .viz import visualize_alignments
        alns_by_sample = {}
        for s, entries in enumerate(stats.viz_data):
            if entries:
                one = sorted((a for st, a in entries if st == 0),
                             key=lambda a: a.start)
                two = sorted((a for st, a in entries if st == 1),
                             key=lambda a: a.start)
                alns_by_sample[g.sample_names[s]] = one + two
        html = visualize_alignments(alns_by_sample, stats.sample_gb,
                                    chrom_seq, region.chrom, region.start,
                                    region.stop)
        viz = (region.chrom, region.start + 1, region.stop, html)
    return (chrom, pos, text), viz


class _Locus:
    """A locus between its rounds: its genotyper and adaptive loop."""

    def __init__(self, region, g, chrom_seq: str):
        self.region = region
        self.g = g
        self.chrom_seq = chrom_seq
        self.gen = None      # the adaptive loop, from the first step


class LocusHost:
    """The loci of one run between their device rounds, each under the
    caller's index for it (its BED order).  `device_em`: stage each
    locus's stutter-EM problem for the caller's device EM instead of
    running the host EM; `device_post`: pack each round's posterior inputs,
    so that the dispatch computes the posteriors `install` is handed;
    `trace_pool` runs each round's ML-trace prefetch, a native batch of
    `trace_threads` threads (SeqStutterGenotyper.prefetch_traces)."""

    def __init__(self, pipeline, emit: Callable[[tuple], None], *,
                 device_em: bool, device_post: bool, trace_pool,
                 trace_threads: int):
        self.pipeline = pipeline
        self.opts = pipeline.opts
        self.timer = pipeline.timer
        self.emit = emit
        self.device_em = device_em
        self.device_post = device_post
        self.trace_pool = trace_pool
        self.trace_threads = trace_threads
        # the native trace batches of every locus: seconds and jobs
        self.tally = TraceTally()
        self.tracing = None        # the Future of the last prefetch
        self.host_posteriors = 0   # rounds whose posteriors were computed here
        self.spec_hits = self.spec_misses = 0   # of the loci that left
        self._loci: Dict[int, _Locus] = {}
        self._em_pending: Dict[int, tuple] = {}  # idx -> (region, prep, seq)
        self._chrom: Optional[str] = None
        self._chrom_seq: Optional[str] = None

    def begin(self, idx: int, region) -> None:
        """A new locus: one too long is settled at once; else its host
        preparation, then its device-EM problem or its first round."""
        p = self.pipeline
        if region.stop - region.start > self.opts.max_str_len:
            p.counters.too_long += 1
            self._settle(idx)
            return
        if region.chrom != self._chrom:
            self._chrom = region.chrom
            self._chrom_seq = p.fasta.get_sequence(region.chrom)
        chrom_seq = self._chrom_seq
        try:
            if self.device_em:
                staged = em_problem(p, region, chrom_seq)
                if staged is not None:
                    self._em_pending[idx] = (region, staged[0], chrom_seq)
                    self.emit(("em", idx, staged[1]))
                    return
            else:
                g = p.prepare_locus_genotyper(region, chrom_seq)
                if g is not None:
                    self._stage(idx, region, g, chrom_seq)
                    return
            self._settle(idx)
        except Exception as exc:  # skip-and-continue, like the reference
            self._fail(idx, region, exc)

    def resume(self, idx: int, params, converged) -> None:
        """Go on with a staged locus once the device EM has run: `params`
        its model's six parameters, `converged` whether the EM converged
        (reference train loop src/em_stutter_genotyper.cpp:170-226)."""
        p = self.pipeline
        region, prep, chrom_seq = self._em_pending.pop(idx)
        try:
            if not converged:
                p.counters.em_fail += 1
                self.emit(("log", f"Stutter EM failed for {region}"))
                self._settle(idx)
                return
            model = StutterModel(*params, region.period)
            p.register_learned_model(region, model)
            g = None if self.opts.skip_genotyping else p.finish_prepare(
                prep, region, chrom_seq, model)
            if g is None:
                self._settle(idx)
                return
            self._stage(idx, region, g, chrom_seq)
        except Exception as exc:
            self._fail(idx, region, exc)

    def install(self, idx: int, LL, post=None, totals=None) -> bool:
        """Install a round's LLs [P, H] and its posteriors, the dispatch's
        (`post` [S', A', A'] and `totals` [S'], padded) or else the host's,
        and prefetch its ML traces; False if the locus failed."""
        locus = self._loci[idx]
        g = locus.g
        try:
            with self.timer.time("LL install"):
                g.set_pool_lls(LL)
            with self.timer.time("Genotyping (adaptive)"):
                if post is not None:
                    S, A = g.num_samples, g.num_alleles
                    g.install_posteriors(post[:S, :A, :A], totals[:S])
                else:
                    g.calc_log_sample_posteriors()
                    self.host_posteriors += 1
                self._prefetch(g)
            return True
        except Exception as exc:
            self._drop(idx)
            self._fail(idx, locus.region, exc)
            return False

    def step(self, idx: int) -> bool:
        """The next adaptive round of an installed locus.  True when its
        loop ended with genotypes: its record's traces are prefetched and
        `record` is due.  Else the round's realignment is packed ("ready")
        or the locus failed ("settled")."""
        locus = self._loci[idx]
        g = locus.g
        try:
            with self.timer.time("Genotyping (adaptive)"):
                if locus.gen is None:
                    locus.gen = g.adaptive_steps(self.opts.max_haps,
                                                 self.opts.max_hap_flanks,
                                                 self.opts.min_flank_freq)
                try:
                    next(locus.gen)
                except StopIteration as stop:
                    if stop.value:
                        self._prefetch(g)
                        return True
                    self._drop(idx)
                    self.pipeline.counters.genotype_fail += 1
                    self._settle(idx)
                    return False
            packed = self._pack(g)
            if packed is None:
                raise RuntimeError("no reads to realign")
            self.emit(("ready", idx, *packed))
        except Exception as exc:
            self._drop(idx)
            self._fail(idx, locus.region, exc)
        return False

    def record(self, idx: int) -> None:
        """Build the record of a locus whose `step` returned True, and
        settle it."""
        locus = self._drop(idx)
        try:
            with self.timer.time("Genotyping (adaptive)"):
                rec, viz = locus_record(self.pipeline, locus.g, locus.region,
                                        locus.chrom_seq)
                self.emit(("settled", idx, rec, viz))
        except Exception as exc:
            self._fail(idx, locus.region, exc)

    def _stage(self, idx: int, region, g, chrom_seq: str) -> None:
        """Pack a prepared locus's first round."""
        packed = self._pack(g)
        if packed is None:
            self.pipeline.counters.genotype_fail += 1
            self._settle(idx)
            return
        g.trace_tally = self.tally
        self._loci[idx] = _Locus(region, g, chrom_seq)
        self.emit(("ready", idx, *packed))

    def _pack(self, g):
        """(arrays, statics) of the locus's next round; None without
        reads."""
        with self.timer.time("Locus packing"):
            seqs, quals, seeds = g.pool_inputs()
            if not seqs:
                return None
            return prepare_locus(
                g.align_haplotype(), seqs, quals, seeds, self.opts.dtype,
                post_meta=g.posterior_meta() if self.device_post else None,
                read_cache=g.__dict__.setdefault("_read_pack_cache", {}))

    def _prefetch(self, g) -> None:
        fut = g.prefetch_traces(self.trace_pool, self.trace_threads)
        if fut is not None:
            self.tracing = fut

    def _drop(self, idx: int) -> Optional[_Locus]:
        """Forget a locus (if still held), counting its speculation."""
        locus = self._loci.pop(idx, None)
        if locus is not None:
            self.spec_hits += locus.g.spec_hits
            self.spec_misses += locus.g.spec_misses
        return locus

    def _settle(self, idx: int) -> None:
        self.emit(("settled", idx, None, None))

    def _fail(self, idx: int, region, exc: Exception) -> None:
        self.pipeline.counters.genotype_fail += 1
        self.emit(("log", f"ERROR at {region}: {exc!r}"))
        self._settle(idx)
