"""Copy of hipstr_tpu/pipeline/genotyper.py, but for one repair: no
trace of a locus runs beside its ML-trace prefetch (`prefetch_traces`
waits for a stale one, `summary_stats_for` collects one in flight), since
both fill the same unlocked native pointer caches.  Besides, a genotyper
given a `TraceTally` counts its native trace batches' seconds and jobs
there; `prefetch_traces` takes the batch's thread count, prefetches
each read's ML-haplotype trace alone, and marshals the batch on the
calling thread.

Per-locus sequence-based stutter genotyping orchestration.

Capability parity with the reference SeqStutterGenotyper (reference:
src/seq_stutter_genotyper.{h,cpp}), re-architected for TPU execution:

* the read<->haplotype HMM runs as one batched device call over all
  [pool x haplotype] pairs (pipeline/hap_aligner.py) instead of the
  reference's Gray-code-incremental CPU loop;
* allele-set changes (stutter-candidate mining, unused-allele pruning, flank
  assembly) simply rebuild the haplotype and rerun the batched kernel — on
  TPU a full batched realignment is cheaper than incremental bookkeeping, and
  mate-pair LL combination is re-derived from raw pool LLs each time, which
  removes the reference's double-combination hazard
  (seq_stutter_genotyper.cpp:549-551);
* genotype posteriors are dense tensor ops (ops/posteriors.py);
* the rare per-read alignment traces come from the host retrace slow path
  (align/retrace.py), cached per (pool, haplotype).
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..align.alignment_data import Alignment, extract_cigar_bp_diff
from ..align.debruijn import MAX_KMER, MIN_KMER, MIN_PATH_WEIGHT, DebruijnGraph
from ..align.hap_generator import HaplotypeGenerator
from ..align.haplotype import HapBlock, Haplotype
from ..align.retrace import HapAlignInfo
from ..align.trace_summary import (TraceStore, batch_columnar_runner,
                                   summaries_via_objects)
from ..io.regions import Region
from ..models.base_quality import BaseQuality
from ..models.stutter import StutterModel
from ..ops import posteriors as post_ops
from ..ops.em import EMStutterGenotyper
from ..utils.mathops import LOG_ONE_HALF
from .special import allele_bias_pvalue, fisher_strand_pvalue


class TraceTally:
    """The native ML-trace batches of a process's genotypers, from any
    thread: their seconds, and their (pool, haplotype) jobs by where they
    ran ("prefetched": on a prefetch's thread; "main": synchronously, on
    the thread that asked) and "discarded" (of a prefetch made stale by a
    new haplotype)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.seconds = 0.0
        self.jobs = dict(prefetched=0, main=0, discarded=0)

    def add(self, kind: str, jobs: int, seconds: float = 0.0) -> None:
        with self._lock:
            self.jobs[kind] += jobs
            self.seconds += seconds


def _aligner():
    """The in-process rounds' aligner: pipeline/hap_aligner's
    compute_hap_log_likelihoods, bound to this module's name of it on first
    use, so that torch is imported only where a locus is aligned in the
    process (never in a pool's host worker, which imports this module).
    What that name is bound to then (a wrapper, say) is what runs."""
    names = globals()
    if "compute_hap_log_likelihoods" not in names:
        from .hap_aligner import compute_hap_log_likelihoods
        names["compute_hap_log_likelihoods"] = compute_hap_log_likelihoods
    return names["compute_hap_log_likelihoods"]


def __getattr__(name: str):
    # `genotyper.compute_hap_log_likelihoods` before the first alignment
    if name == "compute_hap_log_likelihoods":
        return _aligner()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

MIN_SEED_DIST = 5
TOLERANCE = 1e-10
STRAND_TOLERANCE = 0.1
MAX_FLANK_INDEL_FRAC = 0.15

# speculative stutter-allele alignment (see _build_speculative_haplotype):
# the speculative repeat block is capped at MAX_SPEC_TOTAL options so the
# dispatch stays inside the executor's first option/haplotype shape buckets
# (a bigger superset would fragment dispatch groups and balloon the
# emission tensor); candidates beyond the budget fall back to an exact
# realignment round
MAX_SPEC_TOTAL = 8
MAX_SPEC_COMBS = 512


def speculation_enabled() -> bool:
    return os.environ.get("HIPSTR_TPU_SPECULATE", "1") != "0"


def order_key(seq: str):
    return (len(seq), seq)


def _flank_segment(aln, bstart: int, bend: int):
    """(ref_lo, ref_hi, read_lo) of `aln`'s aligned span over the flank
    window [bstart, bend) when that overlap is indel-free; None when an
    indel touches it or the read misses the window entirely."""
    lo = max(bstart, aln.start)
    hi = min(bend, aln.stop + 1)
    if lo >= hi:
        return None
    pos = aln.start
    ridx = 0
    read_lo = None
    for el in aln.cigar:
        t = el.type
        n = el.num
        if t in "=XM":
            if pos <= lo < pos + n:
                read_lo = ridx + (lo - pos)
            pos += n
            ridx += n
        elif t == "I":
            if lo < pos < hi:
                return None
            ridx += n
        elif t == "D":
            if pos < hi and pos + n > lo:
                return None
            pos += n
        elif t == "S":
            ridx += n
        if pos >= hi:
            break
    if read_lo is None:
        return None
    return lo, hi, read_lo


class ReadPooler:
    """Dedupe identical read sequences; pooled quals = per-position median
    (reference: src/read_pooler.{h,cpp})."""

    def __init__(self):
        self.pooled_alns: List[Alignment] = []
        self.quals_by_pool: List[List[str]] = []
        self._seq_to_pool: Dict[str, int] = {}
        self.pooled = False

    def add_alignment(self, aln: Alignment) -> int:
        assert not self.pooled
        idx = self._seq_to_pool.get(aln.sequence)
        if idx is None:
            idx = len(self.pooled_alns)
            self._seq_to_pool[aln.sequence] = idx
            pooled = Alignment(aln.start, aln.stop, False, "READPOOL", "",
                               aln.sequence, aln.alignment)
            pooled.cigar = list(aln.cigar)
            self.pooled_alns.append(pooled)
            self.quals_by_pool.append([aln.base_qualities])
        else:
            self.quals_by_pool[idx].append(aln.base_qualities)
        return idx

    def num_pools(self) -> int:
        return len(self.pooled_alns)

    def pool(self, bq: BaseQuality) -> None:
        for aln, quals in zip(self.pooled_alns, self.quals_by_pool):
            aln.base_qualities = bq.median_base_qualities(quals)
        self.pooled = True


def calc_best_seed_position(region_start, region_end, repeat_starts,
                            repeat_ends) -> Tuple[int, int]:
    """Reference: HapAligner::calc_best_seed_position
    (HapAligner.cpp:238-264)."""
    best_dist = best_pos = -1
    pos = region_start
    ri = 0
    while ri < len(repeat_starts) and pos <= region_end:
        if pos < repeat_starts[ri]:
            dist = 1 + (min(region_end, repeat_starts[ri] - 1) - pos) // 2
            if dist >= best_dist:
                best_dist = dist
                best_pos = dist - 1 + pos
            pos = repeat_ends[ri]
            ri += 1
        elif pos < repeat_ends[ri]:
            pos = repeat_ends[ri]
            ri += 1
        else:
            ri += 1
    if pos <= region_end:
        dist = 1 + (region_end - pos) // 2
        if dist >= best_dist:
            best_dist = dist
            best_pos = dist - 1 + pos
    return best_dist, best_pos


def calc_seed_base(aln: Alignment, haplotype: Haplotype) -> int:
    """Reference: HapAligner::calc_seed_base (HapAligner.cpp:270-318)."""
    repeat_starts = [b.start for b in haplotype.blocks if b.is_repeat]
    repeat_ends = [b.end for b in haplotype.blocks if b.is_repeat]
    hap_start = haplotype.blocks[0].start
    hap_end = haplotype.blocks[-1].end

    pos = aln.start
    best_seed, cur_base, max_dist = -1, 0, MIN_SEED_DIST
    for el in aln.cigar:
        if el.type == "=":
            min_region = max(pos, hap_start)
            max_region = min(pos + el.num - 1, hap_end - 1)
            if min_region <= max_region:
                dist, dist_pos = calc_best_seed_position(
                    min_region, max_region, repeat_starts, repeat_ends)
                if dist >= max_dist:
                    max_dist = dist
                    best_seed = cur_base + (dist_pos - pos)
            pos += el.num
            cur_base += el.num
        elif el.type == "I":
            cur_base += el.num
        elif el.type == "X":
            pos += el.num
            cur_base += el.num
        elif el.type == "D":
            pos += el.num
        else:
            raise AssertionError("Unrecognized CIGAR char in calc_seed_base")

    if best_seed < -1 or best_seed == 0 or best_seed >= len(aln.sequence) - 1:
        raise RuntimeError("Invalid alignment seed")
    return best_seed


class SeqStutterGenotyper:
    def __init__(self, region: Region, haploid: bool, reassemble_flanks: bool,
                 alns: List[Alignment], log_p1: List[List[float]],
                 log_p2: List[List[float]], sample_names: List[str],
                 chrom_seq: str, stutter_model: StutterModel,
                 ref_vcf_alleles: Optional[Tuple[int, List[str]]] = None,
                 dtype: str = "float32", logger=None):
        self.region = region
        self.haploid = haploid
        self.reassemble_flanks = reassemble_flanks
        self.alns = alns
        self.sample_names = sample_names
        self.sample_indices = {n: i for i, n in enumerate(sample_names)}
        self.chrom_seq = chrom_seq
        self.stutter_model = stutter_model
        self.ref_vcf_alleles = ref_vcf_alleles
        self.dtype = dtype
        self.logger = logger or _NullLogger()
        self.base_quality = BaseQuality()

        self.num_samples = len(sample_names)
        # flatten per-sample phasing likelihoods in read order
        self.log_p1 = np.array([v for s in log_p1 for v in s])
        self.log_p2 = np.array([v for s in log_p2 for v in s])
        self.sample_label = np.array(
            [s for s in range(self.num_samples) for _ in log_p1[s]],
            dtype=np.int64)
        self.num_reads = len(alns)
        assert self.num_reads == len(self.log_p1)

        # pool identical sequences; mark second mates (adjacent same name)
        self.pooler = ReadPooler()
        self.pool_index = np.zeros(self.num_reads, dtype=np.int64)
        self.second_mate = np.zeros(self.num_reads, dtype=bool)
        self.read_weights = np.ones(self.num_reads)
        prev_name = ""
        for i, aln in enumerate(alns):
            self.pool_index[i] = self.pooler.add_alignment(aln)
            self.second_mate[i] = (aln.name == prev_name)
            if self.second_mate[i]:
                self.read_weights[i] = 0
            prev_name = aln.name

        self.call_sample = [""] * self.num_samples
        self._pool_logq_cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._spec_hap: Optional[Haplotype] = None
        self._spec_LL: Optional[np.ndarray] = None
        # per-locus speculation accounting (aggregated by the executor):
        # allele-addition events served from the speculative LL matrix (hit)
        # vs needing a realignment dispatch (miss)
        self.spec_hits = 0
        self.spec_misses = 0
        self.haplotype: Optional[Haplotype] = None
        self.hap_info: Optional[HapAlignInfo] = None
        # columnar trace rows (TraceStore) + its (pool, hap) -> row key map;
        # created at the first _set_haplotype (block count is then known)
        self.trace_store: Optional[TraceStore] = None
        # where the native trace batches are counted (TraceTally), if any
        self.trace_tally: Optional[TraceTally] = None
        self.pool_seeds: Optional[np.ndarray] = None
        self.seed_positions: Optional[np.ndarray] = None
        self.pool_LLs: Optional[np.ndarray] = None  # [P, A] raw pool LLs
        self.log_aln_probs: Optional[np.ndarray] = None  # [R, A] mate-combined
        self.log_post: Optional[np.ndarray] = None
        self.sample_total_LLs: Optional[np.ndarray] = None

        self.initialized = self._build_haplotype()

    # ------------------------------------------------------------------ build
    def _build_haplotype(self) -> bool:
        if self.num_reads == 0:
            return False
        min_start = min(a.start for a in self.alns)
        max_stop = max(a.stop for a in self.alns)
        gen = HaplotypeGenerator(min_start, max_stop)

        if self.ref_vcf_alleles is not None:
            pos, alleles = self.ref_vcf_alleles
            ok = gen.add_vcf_haplotype_block(pos, self.chrom_seq, alleles,
                                             self.stutter_model)
        else:
            by_sample: List[List[Alignment]] = [[] for _ in range(self.num_samples)]
            for i, aln in enumerate(self.alns):
                if aln.use_for_hap_generation(0):
                    by_sample[self.sample_label[i]].append(aln)
            ok = gen.add_haplotype_block(self.region, self.chrom_seq,
                                         by_sample, [], self.stutter_model)
        if not ok:
            self.logger.log(f"Haplotype construction failed: {gen.failure_msg}")
            return False
        gen.fuse_haplotype_blocks(self.chrom_seq)
        self._set_haplotype(Haplotype(gen.hap_blocks))
        return True

    def _set_haplotype(self, haplotype: Haplotype) -> None:
        self.haplotype = haplotype
        self.hap_info = HapAlignInfo(
            haplotype,
            content_cache=self.__dict__.setdefault("_aln_info_content", {}))
        # realized-instance reuse across the locus's haplotype rebuilds
        # (align/retrace._instances_for): keyed by realized content
        haplotype._inst_content_cache = self.__dict__.setdefault(
            "_inst_content", {})
        haplotype._homop_content_cache = self.__dict__.setdefault(
            "_homop_content", {})
        if self.trace_store is None:
            self.trace_store = TraceStore(haplotype.num_blocks())
        else:
            # rows persist across haplotype rebuilds (they describe traces
            # against realized sequences); only the key map resets — the
            # caller remaps surviving keys (reference remaps its caches,
            # seq_stutter_genotyper.cpp:324-415)
            self.trace_store.rows.clear()
        self._invalidate_trace_view()

    @property
    def num_alleles(self) -> int:
        return self.haplotype.num_combs

    def haps_to_alleles(self, block_index: int) -> np.ndarray:
        return np.array([self.haplotype.digits(h)[block_index]
                         for h in range(self.num_alleles)], dtype=np.int64)

    # ------------------------------------------------------- alignment + post
    def _pool_columns(self):
        """Cached columnar marshal of the pooled reads (immutable after
        pooling); shared by the native seed and speculation scans."""
        from .. import native as _native
        cols = getattr(self, "_pool_cols", None)
        if cols is None:
            cols = self._pool_cols = _native.pool_columns(
                self.pooler.pooled_alns)
        return cols

    def _compute_seeds(self) -> None:
        from .. import native as _native
        P = self.pooler.num_pools()
        seeds = None
        if P:
            blocks = self.haplotype.blocks
            rep_starts = [b.start for b in blocks if b.is_repeat]
            rep_ends = [b.end for b in blocks if b.is_repeat]
            seeds = _native.seed_scan_native(
                self._pool_columns(), rep_starts, rep_ends,
                blocks[0].start, blocks[-1].end, MIN_SEED_DIST)
        if seeds is None:
            self.pool_seeds = np.full(P, -1, dtype=np.int64)
            for p, aln in enumerate(self.pooler.pooled_alns):
                self.pool_seeds[p] = calc_seed_base(aln, self.haplotype)
        else:
            bad = np.nonzero(seeds < -1)[0]
            if len(bad):     # mirror the per-read exceptions, first pool wins
                if seeds[bad[0]] == -3:
                    raise AssertionError(
                        "Unrecognized CIGAR char in calc_seed_base")
                raise RuntimeError("Invalid alignment seed")
            self.pool_seeds = seeds
        self.seed_positions = self.pool_seeds[self.pool_index]

    def valid_pools(self):
        return [p for p in range(self.pooler.num_pools())
                if self.pool_seeds[p] >= 0]

    def pool_inputs(self):
        """(seqs, quals, seeds) for pools with a valid seed — the inputs a
        batched executor aligns externally."""
        pooled = self.pooler.pooled_alns
        valid = self.valid_pools()
        return ([pooled[p].sequence for p in valid],
                [pooled[p].base_qualities for p in valid],
                [int(self.pool_seeds[p]) for p in valid])

    # ------------------------------------------------- speculative alignment
    def _build_speculative_haplotype(self) -> None:
        """Speculatively include likely stutter-candidate repeat alleles in
        the FIRST alignment dispatch.

        The adaptive loop's first realignment round almost always exists to
        add the stutter-artifact alleles the miner finds in the ML traces
        (get_stutter_candidate_alleles; reference:
        src/seq_stutter_genotyper.cpp:570-601, 843-879).  Those candidates
        are read sequences over the repeat block, so they can be predicted
        from the raw spanning alignments before any alignment runs: align
        the superset once, and when the mined set is contained in it, gather
        the new haplotype's likelihood columns on host instead of paying a
        second device round.  Exactness is preserved — posteriors and
        mining decisions only ever see the CURRENT haplotype's columns, the
        per-(pool, haplotype) kernel math is independent of which other
        columns share the dispatch, and a mined allele outside the
        speculative set falls back to a realignment dispatch."""
        self._spec_hap = None
        self._spec_LL = None
        if not speculation_enabled() or self.ref_vcf_alleles is not None:
            return
        blocks = self.haplotype.blocks
        spec_blocks = list(blocks)
        added_any = False
        native_res = self._spec_scan_native()
        for bi, block in enumerate(blocks):
            if not block.is_repeat:
                continue
            if native_res is not None:
                support = native_res[0].get(bi, {})
            else:
                support = self._stutter_support_py(block)
            budget = MAX_SPEC_TOTAL - block.num_options()
            if budget <= 0:
                continue
            cand_list = sorted(support, key=lambda q: (-support[q],
                                                       order_key(q)))
            cand_list = sorted(cand_list[:budget], key=order_key)
            if cand_list:
                nb = block.remove_alleles([])
                for seq in cand_list:
                    nb.add_alternate(seq)
                spec_blocks[bi] = nb
                added_any = True
        if self.reassemble_flanks:
            if native_res is not None:
                flank_pred = []
                for fbi, sup in native_res[1].items():
                    if sup:
                        cands = sorted(sup, key=lambda q: (-sup[q],
                                                           order_key(q)))[:4]
                        flank_pred.append((fbi, sorted(cands, key=order_key)))
            else:
                flank_pred = self._predict_flank_candidates()
            for fbi, cands in flank_pred:
                block = spec_blocks[fbi]
                nb = block.remove_alleles([])
                for seq in cands:
                    nb.add_alternate(seq)
                spec_blocks[fbi] = nb
                added_any = True

        if not added_any:
            return
        spec = Haplotype(spec_blocks)
        if spec.num_combs > MAX_SPEC_COMBS:
            return
        self._spec_hap = spec

    def _spec_scan_native(self):
        """Marshal the pooled reads + block descriptors into the one-call
        native candidate scan (native/spec_scan.cpp); None -> Python
        fallback.  Best-effort by construction: a differing candidate set
        only changes speculation hit rate, never the output."""
        from .. import native as _native
        blocks = self.haplotype.blocks
        repeat_blocks = []
        for bi, block in enumerate(blocks):
            if block.is_repeat:
                repeat_blocks.append((bi, block.start, block.end,
                                      block.repeat_info.period,
                                      list(block.seqs)))
        flank_blocks = []
        if self.reassemble_flanks:
            for bi in (0, len(blocks) - 1):
                block = blocks[bi]
                if block.is_repeat:
                    continue
                ref_seq = block.get_seq(0)
                if len(ref_seq) < 2:
                    continue
                flank_blocks.append((bi, block.start, ref_seq))
        S = self.num_samples
        P = self.pooler.num_pools()
        ps_counts = np.bincount(self.pool_index * S + self.sample_label,
                                minlength=P * S).reshape(P, S)
        return _native.spec_scan_native(self._pool_columns(), ps_counts,
                                        repeat_blocks, flank_blocks)

    def _stutter_support_py(self, block):
        """Python fallback for one repeat block's speculative-candidate
        support scan (the native path is spec_scan_native)."""
        period = block.repeat_info.period
        max_art = 6 * period
        ref_len = len(block.get_seq(0))

        # observed artifact sizes: net CIGAR bp-diff near the repeat
        # (the EM trains on the same signal, extract_cigar_bp_diff /
        # reference ExtractCigar, src/extract_indels.cpp:18-101); raw
        # block extraction misses indels that NW left-alignment slid
        # into the flank, the bp-diff does not
        from ..align.alignment_data import extract_cigar_bp_diff
        lo = block.start - period - 8
        hi = block.end + period + 8
        # periodic extension template of the reference option, padded so
        # insertions up to +max_art can be matched
        ref_opt = block.get_seq(0)
        tmpl = list(ref_opt)
        for _ in range(max_art + period):
            tmpl.append(tmpl[-period])
        tmpl = "".join(tmpl)

        def read_index_at(aln, ref_pos: int):
            """Read index aligned to ref_pos (None if not covered by a
            match/mismatch), walking the left-aligned CIGAR."""
            cig = aln.cigar
            if len(cig) == 1 and cig[0].type in "M=X":
                # ref-length-preserving read (the common case): direct
                # offset, no walk
                if aln.start <= ref_pos < aln.start + cig[0].num:
                    return ref_pos - aln.start
                return None
            pos = aln.start
            ridx = 0
            for el in aln.cigar:
                if el.type in "=XM":
                    if pos <= ref_pos < pos + el.num:
                        return ridx + (ref_pos - pos)
                    pos += el.num
                    ridx += el.num
                elif el.type == "I":
                    ridx += el.num
                elif el.type == "D":
                    if pos <= ref_pos < pos + el.num:
                        return None
                    pos += el.num
            return None

        tmpl_b = np.frombuffer(tmpl.encode("latin1"), np.uint8)
        S = self.num_samples
        pooled = self.pooler.pooled_alns
        P = self.pooler.num_pools()
        # scan POOLS with per-sample read weights instead of every read:
        # reads in a pool share the sequence (and, virtually always, the
        # alignment), and speculation is best-effort — a rare same-seq
        # different-alignment collision only perturbs which candidates
        # get pre-aligned, never the exact output
        ps_counts = np.bincount(self.pool_index * S + self.sample_label,
                                minlength=P * S).reshape(P, S)
        diff_counts: List[Dict[int, int]] = [dict() for _ in range(S)]
        seq_counts: List[Dict[str, int]] = [dict() for _ in range(S)]
        span = np.zeros(S, dtype=np.int64)
        for p, aln in enumerate(pooled):
            if not (aln.start < block.start and aln.stop > block.end):
                continue
            w = ps_counts[p]
            span += w
            ws = np.nonzero(w)[0].tolist()
            diff = extract_cigar_bp_diff(aln.cigar, aln.start, lo, hi)
            if diff is not None and diff != 0:
                for s in ws:
                    diff_counts[s][diff] = \
                        diff_counts[s].get(diff, 0) + int(w[s])
            # the read's maximal periodic run from the block anchor:
            # stutter artifacts that NW realignment rendered as mismatch
            # runs (not CIGAR indels) still shorten/lengthen this run,
            # and its content is exactly the ML trace's STR sequence on
            # a (mostly) pure repeat
            anchor = read_index_at(aln, block.start)
            if anchor is not None:
                seq_b = aln.sequence
                limit = min(len(seq_b) - anchor, len(tmpl))
                rb = np.frombuffer(
                    seq_b[anchor:anchor + limit].encode("latin1"),
                    np.uint8)
                neq = np.nonzero(rb != tmpl_b[:limit])[0].tolist()
                # walk only the mismatches: tolerate up to 2 isolated
                # in-repeat SNPs when the periodic phase resumes for
                # min(period, remaining) chars right after each
                k = limit
                mism = 0
                for j, m in enumerate(neq):
                    la = min(period, limit - (m + 1))
                    nxt = neq[j + 1] if j + 1 < len(neq) else limit
                    if mism < 2 and la >= 1 and nxt > m + la:
                        mism += 1
                        continue
                    k = m
                    break
                if k >= period and k < len(seq_b) - anchor:
                    # the run may over-extend into flank bases that
                    # accidentally continue the period; per option, the
                    # candidate is the largest stutter-consistent
                    # truncation (left-aligned artifacts make the ML
                    # trace's STR sequence the maximal such run)
                    for opt in block.seqs:
                        Lo = len(opt)
                        Lp = k - ((k - Lo) % period)
                        if (Lp >= period and Lp != Lo
                                and abs(Lp - Lo) <= max_art):
                            run = seq_b[anchor:anchor + Lp]
                            for s in ws:
                                seq_counts[s][run] = \
                                    seq_counts[s].get(run, 0) + int(w[s])

        def periodic_variants(opt: str, delta: int) -> List[str]:
            """Stutter variants of one option: delta bp removed from
            either end, or appended/prepended following the period
            (the trace's left-aligned artifact on a perfect repeat)."""
            if delta < 0:
                if len(opt) + delta <= 0:
                    return []
                return [opt[-delta:], opt[:len(opt) + delta]]
            ext = list(opt)
            for _ in range(delta):
                ext.append(ext[-period])
            front = list(opt)
            for _ in range(delta):
                front.insert(0, front[period - 1])
            return ["".join(ext), "".join(front)]

        support: Dict[str, int] = {}
        for s in range(self.num_samples):
            for diff, cnt in diff_counts[s].items():
                if diff == 0 or cnt < 2 or cnt < 0.10 * span[s]:
                    continue
                target_len = ref_len + diff
                for opt in block.seqs:
                    delta = target_len - len(opt)
                    if (delta == 0 or delta % period != 0
                            or abs(delta) > max_art):
                        continue
                    for cand in periodic_variants(opt, delta):
                        if cand and not block.contains(cand):
                            support[cand] = support.get(cand, 0) + cnt
            for seq, cnt in seq_counts[s].items():
                if cnt < 2 or cnt < 0.10 * span[s] or block.contains(seq):
                    continue
                if any(abs(len(seq) - len(o)) <= max_art
                       and (len(seq) - len(o)) % period == 0
                       and len(seq) != len(o) for o in block.seqs):
                    support[seq] = support.get(seq, 0) + cnt
        return support

    def _predict_flank_candidates(self):
        """Predict the alt flank sequences _assemble_flank_candidates is
        likely to add, BEFORE any alignment runs, so the flank-reassembly
        realignment round (reference: seq_stutter_genotyper.cpp:40-217,
        626-650) can usually be served from the speculative LL matrix
        instead of a second device dispatch.

        The de Bruijn assembly only ever adds SAME-LENGTH alt flanks
        (length mismatches mark the sample FLANK_ASSEMBLY_INDEL and add
        nothing), i.e. substitution variants of the reference flank.  Those
        are visible in the raw left-aligned reads: per sample, flank-window
        substitutions carried by >25% of the covering reads.  Misses (an
        assembled flank outside the prediction) fall back to the exact
        realignment dispatch, so this is best-effort only."""
        blocks = self.haplotype.blocks
        S = self.num_samples
        P = self.pooler.num_pools()
        pooled = self.pooler.pooled_alns
        ps_counts = np.bincount(self.pool_index * S + self.sample_label,
                                minlength=P * S).reshape(P, S)
        # per-pool span + pure-reference-match flag, gathered once: the
        # pure-match majority contributes coverage only, fully vectorized
        p_start = np.fromiter((a.start for a in pooled), np.int64, count=P)
        p_stop = np.fromiter((a.stop for a in pooled), np.int64, count=P)
        pure = np.fromiter(
            (len(a.cigar) == 1 and a.cigar[0].type == "=" for a in pooled),
            bool, count=P)
        dirty = np.nonzero(~pure)[0].tolist()
        out = []
        for bi in (0, len(blocks) - 1):
            block = blocks[bi]
            if block.is_repeat:
                continue
            ref_seq = block.get_seq(0)
            blen = len(ref_seq)
            if blen < 2:
                continue
            bstart = block.start
            bend = bstart + blen
            ref_b = np.frombuffer(ref_seq.encode("latin1"), np.uint8)
            cov_diff = np.zeros((blen + 1, S), dtype=np.int64)
            lo_v = np.maximum(bstart, p_start)
            hi_v = np.minimum(bend, p_stop + 1)
            pm = pure & (lo_v < hi_v)
            # most pure pools span the whole flank window; their coverage is
            # one constant row — scatter only the partial overlaps
            full = pm & (lo_v == bstart) & (hi_v == bend)
            part = pm & ~full
            full_cov = ps_counts[full].sum(axis=0)
            if part.any():
                np.add.at(cov_diff, lo_v[part] - bstart, ps_counts[part])
                np.subtract.at(cov_diff, hi_v[part] - bstart,
                               ps_counts[part])
            alt_counts: List[Dict[Tuple[int, int], int]] = \
                [dict() for _ in range(S)]
            for p in dirty:
                aln = pooled[p]
                seg = _flank_segment(aln, bstart, bend)
                if seg is None:
                    continue
                lo, hi, rlo = seg
                w = ps_counts[p]
                cov_diff[lo - bstart] += w
                cov_diff[hi - bstart] -= w
                sb = np.frombuffer(
                    aln.sequence[rlo:rlo + hi - lo].encode("latin1"),
                    np.uint8)
                mism = np.nonzero(sb != ref_b[lo - bstart:hi - bstart])[0]
                if len(mism):
                    ws = np.nonzero(w)[0].tolist()
                    for off in mism.tolist():
                        key = (off + lo - bstart, int(sb[off]))
                        for s in ws:
                            d = alt_counts[s]
                            d[key] = d.get(key, 0) + int(w[s])
            if not any(alt_counts):
                continue
            cov = (np.cumsum(cov_diff[:blen], axis=0)
                   + full_cov[None, :]).T
            support: Dict[str, int] = {}
            for s in range(S):
                subs = [(off, base, cnt)
                        for (off, base), cnt in alt_counts[s].items()
                        if cnt >= 2 and cnt > 0.25 * cov[s, off]]
                if not subs:
                    continue
                alt = bytearray(ref_b)
                total = 0
                for off, base, cnt in subs:
                    alt[off] = base
                    total += cnt
                seq = alt.decode("latin1")
                if seq != ref_seq:
                    support[seq] = support.get(seq, 0) + total
            if support:
                cands = sorted(support, key=lambda q: (-support[q],
                                                       order_key(q)))[:4]
                out.append((bi, sorted(cands, key=order_key)))
        return out

    def align_haplotype(self) -> Haplotype:
        """The haplotype the device aligns against: the speculative superset
        while active, else the current haplotype."""
        return self._spec_hap if self._spec_hap is not None else self.haplotype

    def _spec_cols(self) -> Optional[np.ndarray]:
        """Column of each current-haplotype combination inside the
        speculative LL matrix; None when some block option is absent."""
        spec = self._spec_hap
        maps = []
        for b_cur, b_spec in zip(self.haplotype.blocks, spec.blocks):
            m: Dict[str, int] = {}
            for d, seq in enumerate(b_spec.seqs):
                m.setdefault(seq, d)
            row = []
            for seq in b_cur.seqs:
                d = m.get(seq)
                if d is None:
                    return None
                row.append(d)
            maps.append(row)
        cols = np.empty(self.num_alleles, dtype=np.int64)
        for h in range(self.num_alleles):
            digits = self.haplotype.digits(h)
            cols[h] = spec.hap_index_for_options(
                [maps[b][d] for b, d in enumerate(digits)])
        return cols

    def device_col_index(self) -> np.ndarray:
        """Columns of the dispatched LL matrix holding the current
        haplotype (identity without speculation); consumed by the fused
        device posterior kernel."""
        if self._spec_hap is not None:
            cols = self._spec_cols()
            if cols is not None:
                return cols.astype(np.int32)
        return np.arange(self.num_alleles, dtype=np.int32)

    def set_pool_lls(self, LL: np.ndarray) -> None:
        """Install externally computed [valid_pools, A] log-likelihoods
        (columns of align_haplotype()) and expand them to reads (mate pairs
        combined)."""
        valid = self.valid_pools()
        H = self.align_haplotype().num_combs
        full = np.zeros((self.pooler.num_pools(), H))
        for row, p in enumerate(valid):
            full[p] = LL[row]
        if self._spec_hap is not None:
            self._spec_LL = full
            cols = self._spec_cols()
            assert cols is not None, "speculative haplotype lost a column"
            self.pool_LLs = full[:, cols]
        else:
            self.pool_LLs = full
        self._expand_pool_lls()

    def _expand_pool_lls(self) -> None:
        # expand pools to reads; combine mate pairs (both get the sum)
        probs = self.pool_LLs[self.pool_index].astype(np.float64)
        sm = np.nonzero(self.second_mate)[0]
        if len(sm):
            if len(sm) > 1 and (np.diff(sm) == 1).any():
                # degenerate >2-read name run: keep the sequential semantics
                for i in sm.tolist():
                    total = probs[i - 1] + probs[i]
                    probs[i - 1] = total
                    probs[i] = total
            else:
                total = probs[sm - 1] + probs[sm]
                probs[sm - 1] = total
                probs[sm] = total
        self.log_aln_probs = probs

    def calc_hap_aln_probs(self) -> None:
        """Batched device alignment of every pool against every haplotype,
        then mate-pair combination (reference calc_hap_aln_probs,
        seq_stutter_genotyper.cpp:519-568)."""
        hap = self.align_haplotype()
        seqs, quals, seeds = self.pool_inputs()
        if seqs:
            LL = _aligner()(hap, seqs, quals, seeds, dtype=self.dtype)
        else:
            LL = np.zeros((0, hap.num_combs))
        self.set_pool_lls(LL)

    def calc_log_sample_posteriors(self) -> float:
        priors = post_ops.log_genotype_priors(np, self.num_alleles, self.haploid)
        self.log_post, self.sample_total_LLs, total = post_ops.sample_posteriors(
            np, self.log_aln_probs, self.log_p1, self.log_p2,
            self.read_weights, self.sample_label, self.num_samples, priors)
        self._invalidate_trace_view()
        return float(total)

    def posterior_meta(self) -> dict:
        """Read-level arrays a device posterior kernel needs alongside the
        [pool, hap] LLs: pool expansion, mate-pair combination structure,
        phasing priors and sample segments (reference inner loop:
        src/genotyper.cpp:44-80 plus the mate summing of
        seq_stutter_genotyper.cpp:530-564).  The read/pool/mate structure
        is fixed after init, so the dict is computed once and cached; only
        the speculative column map (col_index) is refreshed per call."""
        cached = getattr(self, "_post_meta", None)
        if cached is not None:
            return dict(cached, col_index=self.device_col_index())
        R = self.num_reads
        mate_index = np.arange(R, dtype=np.int32)
        has_mate = np.zeros(R, dtype=bool)
        for i in range(R):
            if self.second_mate[i]:
                mate_index[i] = i - 1
                mate_index[i - 1] = i
                has_mate[i] = has_mate[i - 1] = True
        # map pool ids to the row order of pool_inputs() (valid pools only)
        valid = self.valid_pools()
        pool_row = np.full(self.pooler.num_pools(), 0, dtype=np.int32)
        read_ok = np.ones(R, dtype=bool)
        for row, p in enumerate(valid):
            pool_row[p] = row
        for i in range(R):
            if self.pool_seeds[self.pool_index[i]] < 0:
                read_ok[i] = False
        self._post_meta = dict(
            pool_row=pool_row[self.pool_index].astype(np.int32),
            mate_index=mate_index,
            has_mate=has_mate,
            read_ok=read_ok,
            weights=self.read_weights.copy(),
            log_p1=self.log_p1.copy(),
            log_p2=self.log_p2.copy(),
            sample=self.sample_label.astype(np.int32),
            num_samples=self.num_samples,
            haploid=self.haploid,
        )
        return dict(self._post_meta, col_index=self.device_col_index())

    def install_posteriors(self, log_post: np.ndarray,
                           sample_total_LLs: np.ndarray) -> None:
        """Adopt device-computed posteriors (same shapes as
        calc_log_sample_posteriors would produce)."""
        self.log_post = np.asarray(log_post, dtype=np.float64)
        self.sample_total_LLs = np.asarray(sample_total_LLs,
                                           dtype=np.float64)
        self._invalidate_trace_view()

    def get_optimal_haplotypes(self) -> Tuple[np.ndarray, np.ndarray]:
        A = self.num_alleles
        flat = self.log_post.reshape(self.num_samples, A * A)
        best = np.argmax(flat, axis=1)
        return best // A, best % A

    # ------------------------------------------------------------- traces
    def _pool_logq(self, pool_idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """(log_error, log_correct) arrays for one pool's qualities; the
        pooled quality strings are fixed after pool(), so cache them.
        When every pool shares one read length (the normal case), the
        first miss converts ALL pools with two [P, L] table gathers."""
        cache = self._pool_logq_cache
        got = cache.get(pool_idx)
        if got is None:
            pooled = self.pooler.pooled_alns
            if not cache:
                # first miss converts ALL pools in two table gathers over
                # the concatenated quality bytes (any mix of lengths)
                from ..models.base_quality import (_LOG_CORRECT_BY_BYTE,
                                                   _LOG_ERROR_BY_BYTE)
                flat = np.frombuffer(
                    "".join(a.base_qualities
                            for a in pooled).encode("latin1"), np.uint8)
                ble = _LOG_ERROR_BY_BYTE[flat]
                blc = _LOG_CORRECT_BY_BYTE[flat]
                off = 0
                for p, a in enumerate(pooled):
                    end = off + len(a.base_qualities)
                    cache[p] = (ble[off:end], blc[off:end])
                    off = end
                return cache[pool_idx]
            quals = pooled[pool_idx].base_qualities
            got = (self.base_quality.quals_to_log_error(quals),
                   self.base_quality.quals_to_log_correct(quals))
            cache[pool_idx] = got
        return got

    def _trace_plan(self):
        """(best_haps per read [-1 = no seed], missing (read, cache-key)
        list) for the current posteriors (reference retrace_alignments,
        seq_stutter_genotyper.cpp:805-841)."""
        best = getattr(self, "_plan_cache", None)
        if best is None:
            # cached per posterior state (cleared by _invalidate_trace_view)
            haps_a, haps_b = self.get_optimal_haplotypes()
            R = self.num_reads
            ha = haps_a[self.sample_label]
            hb = haps_b[self.sample_label]
            ridx = np.arange(R)
            v1 = LOG_ONE_HALF + self.log_p1 + self.log_aln_probs[ridx, ha]
            v2 = LOG_ONE_HALF + self.log_p2 + self.log_aln_probs[ridx, hb]
            best = np.where(v1 > v2, ha, hb).astype(np.int64)
            best[self.seed_positions < 0] = -1
            self._plan_cache = best

        # unique (pool, hap) pairs among valid reads not yet in the store
        H = self.num_alleles
        vi = np.nonzero(best >= 0)[0]
        combos = self.pool_index[vi] * H + best[vi]
        uniq, first = np.unique(combos, return_index=True)
        missing: List[Tuple[int, Tuple[int, int]]] = []
        rows = self.trace_store.rows
        for u, f in zip(uniq.tolist(), first.tolist()):
            key = (u // H, u % H)
            if key not in rows:
                missing.append((int(vi[f]), key))
        return best, missing

    def _trace_batch_runner(self, missing, n_threads: int = 0):
        """Marshal the missing (read, key) jobs on this thread; returns a
        callable that traces them (the native batch releases the GIL) and
        returns an uninstalled batch payload for _install_trace_batch
        (columnar when the native library is present, boxed objects
        otherwise)."""
        jobs = []
        for i, key in missing:
            pooled = self.pooler.pooled_alns[key[0]]
            blw, blc = self._pool_logq(key[0])
            jobs.append((key[1], pooled, int(self.seed_positions[i]),
                         blw, blc))
        native_run = batch_columnar_runner(self.haplotype, jobs,
                                           self.hap_info, n_threads)

        def run():
            out = native_run() if native_run is not None else None
            if out is not None:
                return ("cols", out, jobs)
            return ("objs", summaries_via_objects(self.haplotype, jobs,
                                                  self.hap_info,
                                                  n_threads=n_threads), jobs)
        return run

    def _run_trace_batch(self, missing, n_threads: int = 0):
        """Trace the missing (read, key) jobs on this thread: the payload
        of _trace_batch_runner."""
        t0 = time.perf_counter()
        run = self._trace_batch_runner(missing, n_threads)
        return self._tallied_run(run, len(missing), "main",
                                 time.perf_counter() - t0)

    def _tallied_run(self, run, jobs: int, kind: str, marshal_s: float):
        """run(), its seconds (with the `marshal_s` its marshalling took)
        and `jobs` counted under `kind` in the genotyper's TraceTally, if
        it has one."""
        t0 = time.perf_counter()
        res = run()
        if self.trace_tally is not None:
            self.trace_tally.add(kind, jobs,
                                 marshal_s + time.perf_counter() - t0)
        return res

    def _install_trace_batch(self, missing, res) -> None:
        keys = [key for _, key in missing]
        kind, payload, jobs = res
        if kind == "cols":
            self.trace_store.add_batch(keys, payload, jobs, self.haplotype,
                                       self.hap_info)
        else:
            self.trace_store.add_objects(keys, payload)

    def prefetch_traces(self, pool, n_threads: int):
        """Submit the current posteriors' missing ML-trace jobs (each read's
        ML haplotype: _trace_plan) to a thread pool, as one native batch of
        `n_threads` threads (0: align/retrace.trace_threads()); the batch
        releases the GIL, so it overlaps other loci's Python while this
        locus waits its turn.  The jobs are marshalled here, so the pool's
        thread runs the native batch alone and allocates next to nothing.
        The record's traces differ only in reads its strand tolerance
        weighs alike (summary_stats_for traces those itself).  Identical
        results to
        the synchronous path (retrace_rows collects).  Returns the batch's
        Future (the one already in flight for this haplotype, if any), or
        None when nothing was left to trace."""
        tf = getattr(self, "_trace_future", None)
        if tf is not None:
            if tf[0] is self.haplotype:
                return tf[2]
            # stale prefetch for a haplotype the adaptive loop replaced:
            # wait for it and discard it.  Its native batch reads the
            # pointer caches of haplotype instances the new haplotype may
            # share (the content caches), so no other trace of this locus
            # may run beside it
            self._collect_trace_future()
        if self.log_aln_probs is None or self.log_post is None:
            return None
        _, missing = self._trace_plan()
        if len(missing) <= 1:
            return None
        t0 = time.perf_counter()
        run = self._trace_batch_runner(missing, n_threads)
        fut = pool.submit(self._tallied_run, run, len(missing), "prefetched",
                          time.perf_counter() - t0)
        self._trace_future = (self.haplotype, missing, fut)
        return fut

    def _collect_trace_future(self) -> None:
        tf = getattr(self, "_trace_future", None)
        if tf is None:
            return
        self._trace_future = None
        hap, missing, fut = tf
        results = fut.result()
        if hap is not self.haplotype or results is None:
            # haplotype changed under the prefetch: discard
            if self.trace_tally is not None:
                self.trace_tally.add("discarded", len(missing))
            return
        self._install_trace_batch(missing, results)

    def retrace_rows(self) -> np.ndarray:
        """Per-read row index into the TraceStore for the ML trace of each
        read (-1 = no seed; reference retrace_alignments,
        seq_stutter_genotyper.cpp:805-841).  Store misses are computed in
        ONE batched native call, possibly prefetched on a thread pool."""
        self._collect_trace_future()
        best_haps, missing = self._trace_plan()
        if missing:
            self._install_trace_batch(missing, self._run_trace_batch(missing))
        rows_map = self.trace_store.rows
        H = self.num_alleles
        R = self.num_reads
        rows = np.full(R, -1, dtype=np.int64)
        valid = best_haps >= 0
        vi = np.nonzero(valid)[0]
        if len(vi):
            combos = self.pool_index[vi] * H + best_haps[vi]
            uniq, inv = np.unique(combos, return_inverse=True)
            u_rows = np.fromiter(
                (rows_map[(u // H, u % H)] for u in uniq.tolist()),
                dtype=np.int64, count=len(uniq))
            rows[vi] = u_rows[inv]
        return rows

    def _trace_view(self):
        """Cached per-read summary arrays for the CURRENT posteriors:
        (store rows [-1 invalid], starts, stops, stut_size [R, NB],
        valid bool).  Invalidated whenever posteriors or the haplotype
        change (the consumers re-derive everything from it)."""
        view = getattr(self, "_view_cache", None)
        if view is not None:
            return view
        rows = self.retrace_rows()
        R = self.num_reads
        NB = self.haplotype.num_blocks()
        store = self.trace_store
        starts = np.full(R, np.iinfo(np.int64).max, dtype=np.int64)
        stops = np.full(R, np.iinfo(np.int64).min, dtype=np.int64)
        stut = np.zeros((R, NB), dtype=np.int64)
        valid = rows >= 0
        r = rows[valid]
        starts[valid] = store.start[r]
        stops[valid] = store.stop[r]
        stut[valid] = np.where(store.svalid[r], store.stut[r], 0)
        view = (rows, starts, stops, stut, valid)
        self._view_cache = view
        return view

    def _invalidate_trace_view(self) -> None:
        self._view_cache = None
        self._plan_cache = None

    def rev_strand_flags(self) -> np.ndarray:
        """Per-read reverse-strand flags (immutable after init; cached)."""
        flags = getattr(self, "_rev_flags", None)
        if flags is None:
            flags = np.fromiter((a.rev_strand for a in self.alns),
                                dtype=bool, count=self.num_reads)
            self._rev_flags = flags
        return flags

    def summary_stats_for(self, ridx: np.ndarray, best_hap: np.ndarray):
        """Per-read trace-summary stats for reads `ridx` aligned to their
        `best_hap` (VCF stats loop; reference
        seq_stutter_genotyper.cpp:1102-1166): (has_stutter, has_flank_indel,
        start, stop, total_stutter, summaries) arrays over len(ridx)."""
        # a prefetch still in flight shares this locus's haplotype
        # instances: finish (and install) it before tracing here
        self._collect_trace_future()
        H = self.num_alleles
        pools = self.pool_index[ridx]
        combos = pools * H + best_hap
        uniq, inv = np.unique(combos, return_inverse=True)
        store = self.trace_store
        rows_map = store.rows
        missing = []
        for pos, u in enumerate(uniq.tolist()):
            key = (u // H, u % H)
            if key not in rows_map:
                # representative read for the pool's seed position
                rep = int(ridx[np.nonzero(inv == pos)[0][0]])
                missing.append((rep, key))
        if missing:
            self._install_trace_batch(missing, self._run_trace_batch(missing))
        u_rows = np.fromiter(
            (rows_map[(u // H, u % H)] for u in uniq.tolist()),
            dtype=np.int64, count=len(uniq))
        u_has_stut = (store.svalid[u_rows] & (store.stut[u_rows] != 0)
                      ).any(axis=1)
        u_flank = (store.fins[u_rows] != 0) | (store.fdel[u_rows] != 0)
        u_start = store.start[u_rows]
        u_stop = store.stop[u_rows]
        u_tot = np.where(store.svalid[u_rows],
                         store.stut[u_rows], 0).sum(axis=1)
        return (u_has_stut[inv], u_flank[inv], u_start[inv], u_stop[inv],
                u_tot[inv], u_rows[inv])

    # ----------------------------------------------------- allele management
    def add_and_remove_alleles(self, alleles_to_remove: List[List[int]],
                               alleles_to_add: List[List[str]]) -> None:
        """Rebuild blocks, then realign (additions) or remap (pruning) and
        recompute posteriors."""
        if self._apply_allele_changes(alleles_to_remove, alleles_to_add):
            self.calc_hap_aln_probs()
        self.calc_log_sample_posteriors()

    def _apply_allele_changes(self, alleles_to_remove: List[List[int]],
                              alleles_to_add: List[List[str]]) -> bool:
        """Host side of an allele change: rebuild blocks, remap caches.

        Returns True when the new haplotype needs a device realignment
        (alleles were added); False when the pool likelihood columns were
        remapped in place (pruning only — the reference remaps its arrays
        the same way, seq_stutter_genotyper.cpp:324-415).
        """
        blocks = self.haplotype.blocks
        new_blocks = [b.remove_alleles(rm) for b, rm in
                      zip(blocks, alleles_to_remove)]
        for blk, adds in zip(new_blocks, alleles_to_add):
            for seq in adds:
                blk.add_alternate(seq)

        # remap surviving traces to the new haplotype indexing instead of
        # recomputing them (reference remaps its caches incrementally,
        # seq_stutter_genotyper.cpp:324-415): removals compress each block's
        # option indices, additions append after the kept options
        old_hap = self.haplotype
        old_rows = dict(self.trace_store.rows)  # _set_haplotype resets map
        digit_maps = []
        for b, rm in zip(blocks, alleles_to_remove):
            removed = set(rm)
            kept = [d for d in range(b.num_options()) if d not in removed]
            digit_maps.append({d: i for i, d in enumerate(kept)})

        self._set_haplotype(Haplotype(new_blocks))
        new_rows = self.trace_store.rows
        for (pool, h_old), row in old_rows.items():
            try:
                new_digits = [digit_maps[bi][d]
                              for bi, d in enumerate(old_hap.digits(h_old))]
            except KeyError:
                continue  # trace's haplotype used a removed allele
            h_new = self.haplotype.hap_index_for_options(new_digits)
            new_rows[(pool, h_new)] = row

        if not any(alleles_to_add) and getattr(self, "pool_LLs", None) is not None:
            # pruning only: every kept haplotype's sequence is unchanged, so
            # its per-pool likelihood column is too — remap instead of
            # re-running the device alignment (reference remaps
            # log_aln_probs_ the same way, seq_stutter_genotyper.cpp:324-415)
            inv_maps = [{new: old for old, new in dm.items()}
                        for dm in digit_maps]
            old_cols = np.empty(self.num_alleles, dtype=np.int64)
            for h_new in range(self.num_alleles):
                digits_old = [inv_maps[bi][d] for bi, d in
                              enumerate(self.haplotype.digits(h_new))]
                old_cols[h_new] = old_hap.hap_index_for_options(digits_old)
            self.pool_LLs = self.pool_LLs[:, old_cols]
            self._expand_pool_lls()
            return False
        if self._spec_hap is not None and self._spec_LL is not None:
            # additions already aligned speculatively: gather the new
            # haplotype's columns instead of dispatching a realignment
            cols = self._spec_cols()
            if cols is not None:
                self.spec_hits += 1
                self.pool_LLs = self._spec_LL[:, cols]
                self._expand_pool_lls()
                return False
            # an added allele (e.g. an assembled flank) is outside the
            # speculative set — realign against the exact haplotype
            self._spec_hap = None
            self._spec_LL = None
        self.spec_misses += 1
        return True

    def remove_alleles(self, allele_indices: List[List[int]]) -> None:
        self.add_and_remove_alleles(
            allele_indices, [[] for _ in self.haplotype.blocks])

    def get_unused_alleles(self, check_spanned: bool, check_called: bool
                           ) -> Tuple[List[List[int]], int, int]:
        """Reference: seq_stutter_genotyper.cpp:229-315."""
        num_aff_blocks = num_aff_alleles = 0
        haps_a, haps_b = self.get_optimal_haplotypes()
        # the called-only pass never touches the traces (the reference
        # reads them only under check_spanned, seq_stutter_genotyper.cpp
        # :252-276), so skip the retrace entirely
        seed_ok = self.seed_positions >= 0
        if check_spanned:
            _, starts, stops, stut, valid = self._trace_view()
            # per-read best hap under the spanned-check tie rule
            ha_r = haps_a[self.sample_label]
            hb_r = haps_b[self.sample_label]
            ridx = np.arange(self.num_reads)
            v1 = self.log_p1 + self.log_aln_probs[ridx, ha_r]
            v2 = self.log_p2 + self.log_aln_probs[ridx, hb_r]
            decided = ((not self.haploid) & (ha_r != hb_r)
                       & (np.abs(v1 - v2) > TOLERANCE))
            best_r = np.where(decided & (v2 > v1), hb_r, ha_r)

        aligned_read = np.zeros(self.num_samples, dtype=bool)
        aligned_read[self.sample_label[seed_ok]] = True

        allele_indices: List[List[int]] = []
        for bi, block in enumerate(self.haplotype.blocks):
            allele_indices.append([])
            if block.num_options() == 1:
                continue
            hap_to_allele = self.haps_to_alleles(bi)
            spanned = np.zeros(block.num_options(), dtype=bool)
            called = np.zeros(block.num_options(), dtype=bool)

            if check_spanned:
                mask = (valid & (starts < block.start)
                        & (stops > block.end) & (stut[:, bi] == 0))
                if mask.any():
                    spanned[hap_to_allele[np.unique(best_r[mask])]] = True

            if check_called:
                for s in range(self.num_samples):
                    if aligned_read[s] and not self.call_sample[s]:
                        called[hap_to_allele[haps_a[s]]] = True
                        called[hap_to_allele[haps_b[s]]] = True

            affected = False
            for ai in range(1, block.num_options()):
                if (check_spanned and not spanned[ai]) or \
                        (check_called and not called[ai]):
                    allele_indices[-1].append(ai)
                    affected = True
                    num_aff_alleles += 1
            if affected:
                num_aff_blocks += 1
        return allele_indices, num_aff_blocks, num_aff_alleles

    def get_stutter_candidate_alleles(self, block_index: int) -> List[str]:
        """Reference: seq_stutter_genotyper.cpp:843-879."""
        block = self.haplotype.blocks[block_index]
        rows, starts, stops, stut, valid = self._trace_view()
        span = valid & (starts < block.start) & (stops > block.end)
        sample_counts = np.bincount(self.sample_label[span],
                                    minlength=self.num_samples)
        store = self.trace_store
        stutter_counts: List[Dict[str, int]] = [dict() for _ in range(self.num_samples)]
        for i in np.nonzero(span & (stut[:, block_index] != 0))[0].tolist():
            s = self.sample_label[i]
            seq = store.str_seq(int(rows[i]), block_index)
            stutter_counts[s][seq] = stutter_counts[s].get(seq, 0) + 1

        candidates = set()
        for s in range(self.num_samples):
            for seq, cnt in stutter_counts[s].items():
                if cnt >= 2 and cnt / sample_counts[s] >= 0.15:
                    if not block.contains(seq):
                        candidates.add(seq)
        return sorted(candidates)

    # -------------------------------------------------------- flank assembly
    def assemble_flanks(self, max_total_haplotypes: int,
                        max_flank_haplotypes: int,
                        min_flank_freq: float) -> bool:
        """Synchronous flank reassembly: candidates + realign + prune."""
        adds = self._assemble_flank_candidates(
            max_total_haplotypes, max_flank_haplotypes, min_flank_freq)
        if adds is None:
            return False
        if any(adds):
            self.logger.log("Realigning to include assembled flanks")
            self.add_and_remove_alleles([[] for _ in adds], adds)
            if self.ref_vcf_alleles is None:
                unused, nb, na = self.get_unused_alleles(False, True)
                if na:
                    self.remove_alleles(unused)
        return True

    def _assemble_flank_candidates(self, max_total_haplotypes: int,
                                   max_flank_haplotypes: int,
                                   min_flank_freq: float
                                   ) -> Optional[List[List[str]]]:
        """Per-sample de Bruijn reassembly of flanking sequences
        (reference: seq_stutter_genotyper.cpp:40-217).  Returns the per-block
        alternate flank sequences to add, or None to abort the locus."""
        t_rows, _, _, _, _ = self._trace_view()
        store = self.trace_store
        nblocks = self.haplotype.num_blocks()
        alleles_to_add: List[List[str]] = [[] for _ in range(nblocks)]
        realign_sample = [False] * self.num_samples
        new_total_haps = self.num_alleles

        for flank in range(2):
            block_index = 0 if flank == 0 else nblocks - 1
            flank_dir = "left" if flank == 0 else "right"
            ref_seq = self.haplotype.blocks[block_index].get_seq(0)
            max_k = min(MAX_KMER, len(ref_seq) - 1 if ref_seq else -1)
            new_total_haps //= self.haplotype.blocks[block_index].num_options()

            kmer_length = DebruijnGraph.calc_kmer_length(ref_seq, MIN_KMER, max_k)
            if kmer_length is None:
                return None

            hap_indexes: Dict[str, int] = {}
            hap_to_sample: List[List[int]] = []
            reads_by_sample: List[List[int]] = [[] for _ in range(self.num_samples)]
            for i in range(self.num_reads):
                reads_by_sample[self.sample_label[i]].append(i)

            def sample_strings(s):
                out = []
                for i in reads_by_sample[s]:
                    if t_rows[i] < 0:
                        continue
                    seq = store.flank_seq_bytes(int(t_rows[i]), block_index)
                    if seq:
                        out.append(seq)
                return out

            # one native call runs every sample's k-escalation assembly
            # (native/debruijn.cpp); the python graph below is the fallback
            from .. import native as _native
            skip = [bool(self.call_sample[s])
                    for s in range(self.num_samples)]
            native_res = _native.flank_assembly_batch_native(
                ref_seq, kmer_length, max_k,
                [sample_strings(s) if not skip[s] else ()
                 for s in range(self.num_samples)],
                skip, 0.02, 2, MIN_PATH_WEIGHT, 10)

            for s in range(self.num_samples):
                if self.call_sample[s]:
                    continue
                if native_res is not None:
                    acyclic = bool(native_res[0][s])
                    assembly_data = native_res[1][s]
                else:
                    assembly_data = []
                    acyclic = False
                    for k in range(kmer_length, max_k + 1):
                        assembler = DebruijnGraph(k, ref_seq)
                        for seq in sample_strings(s):
                            assembler.add_string(seq.decode("latin1"))
                        assembler.prune_edges(0.02, 2)
                        if (not assembler.has_cycles()
                                and assembler.is_source_ok()
                                and assembler.is_sink_ok()):
                            acyclic = True
                            assembly_data = assembler.enumerate_paths(
                                MIN_PATH_WEIGHT, 10)
                            break

                if acyclic:
                    if not self.call_sample[s] and len(assembly_data) > 1:
                        total_depth = sum(d for _, d in assembly_data)
                        for seq, depth in assembly_data:
                            if seq == ref_seq:
                                continue
                            if depth / total_depth > 0.25:
                                if len(ref_seq) != len(seq):
                                    self.call_sample[s] = "FLANK_ASSEMBLY_INDEL"
                                    realign_sample[s] = False
                                else:
                                    if seq not in hap_indexes:
                                        hap_indexes[seq] = len(hap_indexes)
                                        hap_to_sample.append([])
                                    realign_sample[s] = True
                                    hap_to_sample[hap_indexes[seq]].append(s)
                else:
                    self.call_sample[s] = "FLANK_ASSEMBLY_CYCLIC"

            # prune low-frequency flanks
            for seq in sorted(hap_indexes, key=lambda q: hap_indexes[q]):
                samples = hap_to_sample[hap_indexes[seq]]
                if len(samples) < min_flank_freq * self.num_samples:
                    for s in samples:
                        if not self.call_sample[s]:
                            self.call_sample[s] = "LOW_FREQUENCY_ALT_FLANK"
                            realign_sample[s] = False
                    self.logger.log(
                        f"Pruning low frequency {flank_dir} flank {seq}")
                    del hap_indexes[seq]

            if hap_indexes:
                if len(hap_indexes) > max_flank_haplotypes:
                    self.logger.log(
                        f"Skipping locus: too many {flank_dir} flanks")
                    return None
                for seq in sorted(hap_indexes, key=lambda q: hap_indexes[q]):
                    alleles_to_add[block_index].append(seq)
                new_total_haps *= (1 + len(hap_indexes))

        if new_total_haps > max_total_haplotypes:
            self.logger.log("Aborting: too many haplotypes after flank assembly")
            return None
        return alleles_to_add

    # ---------------------------------------------------------------- driver
    def genotype_prepare(self) -> bool:
        """Guards + pooling + seed selection — everything before the first
        batched alignment (the split lets an executor align many loci per
        device dispatch)."""
        if not self.initialized:
            return False
        if self.num_alleles > 1000000000:
            return False

        for flank in (0, -1):
            ref_seq = self.haplotype.blocks[flank].get_seq(0)
            max_k = min(MAX_KMER, len(ref_seq) - 1 if ref_seq else -1)
            if DebruijnGraph.calc_kmer_length(ref_seq, MIN_KMER, max_k) is None:
                self.logger.log("Aborting: flank too repetitive")
                return False

        self.pooler.pool(self.base_quality)
        self._compute_seeds()
        self._build_speculative_haplotype()
        return True

    def genotype_finish(self, max_total_haplotypes: int = 1000,
                        max_flank_haplotypes: int = 4,
                        min_flank_freq: float = 0.01) -> bool:
        """Posteriors + adaptive allele loops; assumes pool LLs are set."""
        self.calc_log_sample_posteriors()
        return self._genotype_tail(max_total_haplotypes, max_flank_haplotypes,
                                   min_flank_freq)

    def genotype(self, max_total_haplotypes: int = 1000,
                 max_flank_haplotypes: int = 4,
                 min_flank_freq: float = 0.01) -> bool:
        """Reference: seq_stutter_genotyper.cpp:603-671."""
        if self.initialized and self.num_alleles > max_total_haplotypes:
            self.logger.log("Aborting: too many candidate haplotypes")
            return False
        if not self.genotype_prepare():
            return False
        self.calc_hap_aln_probs()
        self.calc_log_sample_posteriors()
        return self._genotype_tail(max_total_haplotypes, max_flank_haplotypes,
                                   min_flank_freq)

    def _genotype_tail(self, max_total_haplotypes: int,
                       max_flank_haplotypes: int,
                       min_flank_freq: float) -> bool:
        # drive the resumable adaptive loop synchronously: service each
        # requested realignment with an immediate device call
        gen = self.adaptive_steps(max_total_haplotypes, max_flank_haplotypes,
                                  min_flank_freq)
        while True:
            try:
                next(gen)
            except StopIteration as stop:
                return bool(stop.value)
            self.calc_hap_aln_probs()
            self.calc_log_sample_posteriors()

    def adaptive_steps(self, max_total_haplotypes: int = 1000,
                       max_flank_haplotypes: int = 4,
                       min_flank_freq: float = 0.01):
        """Resumable adaptive-allele loop (stutter mining -> pruning ->
        flank reassembly; reference seq_stutter_genotyper.cpp:603-671).

        Yields whenever the CURRENT haplotype needs externally computed pool
        likelihoods: the caller must align `pool_inputs()` against
        `self.haplotype`, call `set_pool_lls(LL)` and
        `calc_log_sample_posteriors()`, then resume.  A batched executor
        services the yields of many loci with one device dispatch.  Returns
        the genotyping success bool.
        """
        if self.ref_vcf_alleles is None:
            # stutter-candidate mining rounds
            # (reference: seq_stutter_genotyper.cpp:570-601)
            while True:
                added = False
                stutter_seqs: List[List[str]] = []
                new_total = self.num_alleles
                for bi, block in enumerate(self.haplotype.blocks):
                    if block.is_repeat:
                        seqs = self.get_stutter_candidate_alleles(bi)
                        added |= bool(seqs)
                        seqs.sort(key=order_key)
                        stutter_seqs.append(seqs)
                        new_total = (new_total // block.num_options()
                                     * (block.num_options() + len(seqs)))
                    else:
                        stutter_seqs.append([])
                if not added:
                    break
                if new_total > max_total_haplotypes:
                    self.logger.log("Aborting: too many candidate haplotypes "
                                    f"({new_total})")
                    return False
                self.logger.log("Identified additional stutter alleles: "
                                + str([s for s in stutter_seqs if s]))
                if self._apply_allele_changes(
                        [[] for _ in self.haplotype.blocks], stutter_seqs):
                    yield
                else:
                    self.calc_log_sample_posteriors()

            # unused-allele pruning (host-only LL remap)
            for check_spanned, check_called in ((False, True), (True, False)):
                unused, nb, na = self.get_unused_alleles(check_spanned,
                                                         check_called)
                if na:
                    if self._apply_allele_changes(
                            unused, [[] for _ in self.haplotype.blocks]):
                        yield
                    else:
                        self.calc_log_sample_posteriors()

        if self.reassemble_flanks:
            adds = self._assemble_flank_candidates(
                max_total_haplotypes, max_flank_haplotypes, min_flank_freq)
            if adds is None:
                return False
            if any(adds):
                self.logger.log("Realigning to include assembled flanks")
                if self._apply_allele_changes([[] for _ in adds], adds):
                    yield
                else:
                    self.calc_log_sample_posteriors()
                if self.ref_vcf_alleles is None:
                    unused, nb, na = self.get_unused_alleles(False, True)
                    if na:
                        if self._apply_allele_changes(
                                unused, [[] for _ in self.haplotype.blocks]):
                            yield
                        else:
                            self.calc_log_sample_posteriors()
        return True

    def recompute_stutter_models(self, max_total_haplotypes=1000,
                                 max_flank_haplotypes=4, min_flank_freq=0.01,
                                 max_em_iter=100, abs_ll_converge=0.01,
                                 frac_ll_converge=0.001) -> bool:
        """Retrain EM from ML-alignment stutter calls, then regenotype
        (reference: seq_stutter_genotyper.cpp:1542-1581)."""
        rows, starts, stops, stut, valid = self._trace_view()
        store = self.trace_store
        for bi, block in enumerate(self.haplotype.blocks):
            if not block.is_repeat:
                continue
            num_bps = [[] for _ in range(self.num_samples)]
            p1s = [[] for _ in range(self.num_samples)]
            p2s = [[] for _ in range(self.num_samples)]
            span = valid & (starts < block.start) & (stops > block.end)
            for i in np.nonzero(span)[0].tolist():
                s = self.sample_label[i]
                row = int(rows[i])
                num_bps[s].append(len(store.str_seq_bytes(row, bi))
                                  + int(stut[i, bi]))
                p1s[s].append(float(self.log_p1[i]))
                p2s[s].append(float(self.log_p2[i]))
            em = EMStutterGenotyper(self.haploid,
                                    block.repeat_info.period,
                                    num_bps, p1s, p2s, ref_allele=0)
            res = em.train(max_em_iter, abs_ll_converge, frac_ll_converge)
            if not res.converged:
                self.logger.log("Stutter model retraining failed")
                return False
            self.stutter_model = res.stutter_model
            block.repeat_info.stutter_model = res.stutter_model
        self.trace_store.clear_all()
        self._invalidate_trace_view()
        return self.genotype(max_total_haplotypes, max_flank_haplotypes,
                             min_flank_freq)


class _NullLogger:
    def log(self, *args, **kwargs):
        pass
