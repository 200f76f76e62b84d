"""Copy of hipstr_tpu/pipeline/processor.py.

Region-level genotyping pipeline: BAM -> filters -> genotyper -> VCF.

Capability parity with the reference's three-level processor hierarchy
(reference: src/bam_processor.cpp `process_regions`/`read_and_filter_reads`,
src/snp_bam_processor.cpp, src/genotyper_bam_processor.cpp
`analyze_reads_and_phasing`): per-locus read fetching, the full filter
cascade (mate flags, overlap, quality trimming, N-bases, quality sum, unique
mapping, haplotype-generation eligibility), PCR-duplicate removal, stutter
model selection (default / file / EM-learned), left alignment, genotyping and
sorted VCF emission, with per-locus skip-and-continue error discipline.
"""

from __future__ import annotations

import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..align.alignment_data import Alignment, CigarElement
from ..align.realign import convert_alignment, realign
from ..io.bam import BamReader
from ..io.fasta import FastaReader
from ..io.regions import Region
from ..io.vcf_write import VCFWriter
from ..models.base_quality import BaseQuality
from ..models.stutter import StutterModel, read_stutter_models
from ..utils.timers import ProcessTimer
from ..ops.em import EMStutterGenotyper
from .adapter_trimmer import AdapterTrimmer
from .bam_align import BamAlign
from .genotyper import SeqStutterGenotyper
from .locus_host import locus_record
from .vcf_record import OutputConfig

MAX_MATE_DIST = 1000


@dataclass
class PreparedReads:
    """Stage-1 output of the locus prepare path (filters + phasing done)."""
    rg_names: List[str]
    alns_by_rg: List[List["BamAlign"]]
    log_p1s: List[List[float]]
    log_p2s: List[List[float]]
    haploid: bool

MIN_BP_BEFORE_INDEL = 7
MIN_FLANK = 5
MIN_READ_END_MATCH = 10
MAXIMAL_END_MATCH_WINDOW = 15
MIN_SUM_QUAL_LOG_PROB = -10.0
BASE_QUAL_TRIM = "5"


@dataclass
class PipelineOptions:
    min_reads: int = 100
    max_reads: int = 1000000
    max_str_len: int = 100
    use_unpaired: bool = False
    remove_pcr_dups: bool = True
    def_stutter_model: Optional[StutterModel] = None
    stutter_in: Optional[str] = None
    stutter_out: Optional[str] = None
    haploid_chroms: Tuple[str, ...] = ()
    max_haps: int = 1000
    max_hap_flanks: int = 4
    min_flank_freq: float = 0.01
    max_em_iter: int = 100
    abs_ll_converge: float = 0.01
    frac_ll_converge: float = 0.001
    chrom: str = ""
    max_regions: int = 1000000000
    max_mate_dist: int = MAX_MATE_DIST
    base_qual_trim: str = BASE_QUAL_TRIM
    sample_set: Optional[Tuple[str, ...]] = None   # --sample-list
    pass_bam: Optional[str] = None
    filt_bam: Optional[str] = None
    skip_genotyping: bool = False
    dtype: str = "float32"
    snp_vcf: Optional[str] = None
    ref_vcf: Optional[str] = None
    viz_out: Optional[str] = None
    locus_shard: Optional[Tuple[int, int]] = None  # (index, count)
    fam_file: Optional[str] = None
    bams_from_10x: bool = False
    output: OutputConfig = field(default_factory=OutputConfig)


class Logger:
    def __init__(self, stream=None, quiet=False):
        self.stream = stream or sys.stderr
        self.quiet = quiet

    def log(self, *args):
        if not self.quiet:
            print(*args, file=self.stream)


@dataclass
class LocusCounters:
    too_long: int = 0
    too_few_reads: int = 0
    too_many_reads: int = 0
    missing_model: int = 0
    em_fail: int = 0
    genotype_fail: int = 0
    genotype_success: int = 0


class GenotyperPipeline:
    def __init__(self, bam_paths: List[str], fasta_path: str,
                 options: Optional[PipelineOptions] = None,
                 logger: Optional[Logger] = None,
                 bam_samps: Optional[List[str]] = None,
                 bam_libs: Optional[List[str]] = None,
                 lib_field: str = "LB"):
        self.opts = options or PipelineOptions()
        self.logger = logger or Logger()
        self.fasta = FastaReader(fasta_path)
        self.fasta_path = fasta_path
        # BAM or CRAM per file, as in the reference's BamCramMultiReader
        # (reference: src/bam_io.h:505-569); CRAM decode needs the FASTA
        from ..io.cram import CramReader
        self.readers = [CramReader(p, fasta_path) if p.endswith(".cram")
                        else BamReader(p) for p in bam_paths]
        self.bq = BaseQuality()
        self.counters = LocusCounters()
        self.adapter_trimmer = AdapterTrimmer()
        self.timer = ProcessTimer()

        # RG -> sample / library maps (reference: hipstr_main.cpp:418-473)
        self.rg_to_sample: Dict[str, str] = {}
        self.rg_to_library: Dict[str, str] = {}
        self.use_bam_rgs = bam_samps is None
        self.samples: List[str] = []
        seen = set()
        for i, rdr in enumerate(self.readers):
            if self.use_bam_rgs:
                for rg in rdr.read_groups():
                    rg_id = rg.get("ID", "")
                    sm = rg.get("SM", "")
                    # --lib-field selects the RG field naming the library
                    # (reference: hipstr_main.cpp:451-453)
                    lb = rg.get(lib_field)
                    if lb is None:
                        raise RuntimeError(
                            f"RG in BAM header is missing the {lib_field} tag;"
                            " see the --lib-field option")
                    self.rg_to_sample[rdr.path + rg_id] = sm
                    self.rg_to_library[rdr.path + rg_id] = lb
                    if sm not in seen:
                        seen.add(sm)
                        self.samples.append(sm)
            else:
                sm = bam_samps[i]
                lb = bam_libs[i] if bam_libs else sm
                self.rg_to_sample[rdr.path] = sm
                self.rg_to_library[rdr.path] = lb
                if sm not in seen:
                    seen.add(sm)
                    self.samples.append(sm)

        self.ref_vcf = None
        if self.opts.ref_vcf:
            from ..io.vcf_read import VCFReader
            self.ref_vcf = VCFReader(self.opts.ref_vcf)

        # phased-SNP support (reference: snp_bam_processor.cpp)
        self.snp_vcf = None
        self.haplotype_tracker = None
        self.phase_match_count = 0
        self.phase_mismatch_count = 0
        if self.opts.snp_vcf:
            from ..io.vcf_read import VCFReader
            self.snp_vcf = VCFReader(self.opts.snp_vcf)
            if self.opts.fam_file:
                from ..phasing.haplotype_tracker import HaplotypeTracker
                from ..phasing.pedigree import extract_pedigree_nuclear_families
                fams = extract_pedigree_nuclear_families(
                    self.opts.fam_file, set(self.snp_vcf.samples))
                self.haplotype_tracker = HaplotypeTracker(fams, self.snp_vcf)

        self.viz_writer = None
        if self.opts.viz_out:
            from .viz import VizWriter
            self.viz_writer = VizWriter(self.opts.viz_out)
            self.opts.output.viz_out = True

        # --pass-bam / --filt-bam: BAM outputs of reads used / filtered, with
        # PF (passes-filters per region) and FT (filter reason) tags
        # (reference: hipstr_main.cpp pass/filt writers + bam_processor.cpp:21-58)
        from ..io.bam import BamWriter
        self.pass_writer = self.filt_writer = None
        hdr = self.readers[0]
        if self.opts.pass_bam:
            self.pass_writer = BamWriter(self.opts.pass_bam, hdr.ref_names,
                                         hdr.ref_lens, hdr.header_text,
                                         build_index=False)
        if self.opts.filt_bam:
            self.filt_writer = BamWriter(self.opts.filt_bam, hdr.ref_names,
                                         hdr.ref_lens, hdr.header_text,
                                         build_index=False)

        self.stutter_models: Dict[Tuple[str, int, int], StutterModel] = {}
        if self.opts.stutter_in:
            with open(self.opts.stutter_in) as fh:
                self.stutter_models = read_stutter_models(fh)
        self._stutter_out: Dict[Tuple[str, int, int], StutterModel] = {}

    # ------------------------------------------------------------------ reads
    def _get_rg(self, aln: BamAlign) -> str:
        s = getattr(aln, "_samp", None)   # precomputed per locus
        if s is not None:
            return s
        if self.use_bam_rgs:
            rg = aln.get_tag("RG")
            if rg is None:
                raise RuntimeError("missing RG tag for read " + aln.name)
            key = aln.filename + str(rg)
            if key not in self.rg_to_sample:
                raise RuntimeError(f"no sample for read group {rg}")
            return self.rg_to_sample[key]
        return self.rg_to_sample[aln.filename]

    def _get_library(self, aln: BamAlign) -> str:
        lb = getattr(aln, "_lib", None)   # precomputed per locus
        if lb is not None:
            return lb
        if self.use_bam_rgs:
            rg = aln.get_tag("RG")
            return self.rg_to_library.get(aln.filename + str(rg), "")
        return self.rg_to_library[aln.filename]

    def _write_pass(self, aln: BamAlign) -> None:
        if self.pass_writer is not None:
            tags = {}
            if getattr(aln, "pass_two", None) is not None:
                tags["PF"] = aln.pass_two
            self.pass_writer.write(aln.to_record(tags))

    def _write_filt(self, aln: BamAlign, reason: str) -> None:
        if self.filt_writer is not None:
            self.filt_writer.write(aln.to_record({"FT": reason}))

    @staticmethod
    def _trim_name(name: str) -> str:
        if len(name) > 2 and name[-2] == "/":
            return name[:-2]
        return name

    def read_and_filter_reads(self, region: Region, chrom_seq: str):
        """Port of BamProcessor::read_and_filter_reads
        (bam_processor.cpp:173-474), single-region groups."""
        paired_strs: List[BamAlign] = []
        mate_alns: List[BamAlign] = []
        unpaired_strs: List[BamAlign] = []
        potential_strs: Dict[str, BamAlign] = {}
        potential_mates: Dict[str, BamAlign] = {}
        too_many_reads = False
        g_start, g_stop = region.start, region.stop

        mate_dist = self.opts.max_mate_dist
        qual_trim = self.opts.base_qual_trim
        for file_index, rdr in enumerate(self.readers):
            potential_mates.clear()
            label = f"{file_index + 1}_"
            for rec in rdr.fetch(region.chrom, max(0, g_start - mate_dist),
                                 g_stop + mate_dist):
                if rec.is_unmapped or rec.is_secondary or rec.is_supplementary \
                        or rec.is_duplicate or (rec.flag & 0x200):
                    continue
                if rec.is_paired and not (rec.is_first_mate or rec.is_second_mate):
                    continue
                aln = BamAlign(rec, rdr.path, region.chrom)
                if aln.pos > g_stop or aln.end_pos < g_start:
                    if not rec.is_paired or rec.mate_pos == aln.pos:
                        continue
                    if rec.mate_pos > g_stop:
                        continue
                    if rec.mate_pos + aln.length + 100 < g_start:
                        continue
                if len(paired_strs) > self.opts.max_reads:
                    too_many_reads = True
                    break
                if rec.pos == 0 or not aln.cigar or aln.length == 0:
                    continue

                overlaps = aln.pos < g_stop and aln.end_pos >= g_start
                if overlaps:
                    if qual_trim > " ":
                        if aln.starts_with_hard_clip() or aln.ends_with_hard_clip():
                            self._write_filt(aln, "HARD_CLIPPED")
                            continue
                        length = aln.length
                        aln.trim_low_quality_ends(qual_trim)
                        if aln.pos < g_stop and aln.end_pos >= g_start:
                            if aln.length == 0 or aln.length < length / 2:
                                continue
                    self.adapter_trimmer.trim_adapters(aln)
                    if not aln.cigar or aln.length == 0:
                        continue

                overlaps = aln.pos < g_stop and aln.end_pos >= g_start
                aln_key = label + self._trim_name(aln.name)
                if overlaps:
                    pass_one = False
                    pass_two = "0"
                    filter_reason = ""
                    if "N" in aln.bases:
                        filter_reason = "HAS_N_BASES"
                    elif self.bq.sum_log_prob_correct(aln.quals) < MIN_SUM_QUAL_LOG_PROB:
                        filter_reason = "LOW_BASE_QUALS"
                    else:
                        pass_one = True

                    if pass_one:
                        ok = True
                        if MIN_FLANK > 0 and (aln.pos > region.start - MIN_FLANK
                                              or aln.end_pos < region.stop + MIN_FLANK):
                            ok = False
                        if ok and MAXIMAL_END_MATCH_WINDOW > 0:
                            if not aln.has_largest_end_matches(
                                    chrom_seq, 0, MAXIMAL_END_MATCH_WINDOW,
                                    MAXIMAL_END_MATCH_WINDOW):
                                ok = False
                        if ok and MIN_READ_END_MATCH > 0:
                            h, t = aln.num_end_matches(chrom_seq, 0)
                            if h < MIN_READ_END_MATCH or t < MIN_READ_END_MATCH:
                                ok = False
                        if ok and MIN_BP_BEFORE_INDEL > 0:
                            h, t = aln.end_dist_to_indel()
                            if (h != -1 and h < MIN_BP_BEFORE_INDEL) or \
                                    (t != -1 and t < MIN_BP_BEFORE_INDEL):
                                ok = False
                        pass_two = "1" if ok else "0"

                    if pass_one:
                        aln.pass_two = pass_two
                        mate = potential_mates.pop(aln_key, None)
                        if mate is not None:
                            if mate.rec.is_first_mate == aln.rec.is_first_mate:
                                potential_strs[aln_key] = aln
                                continue
                            if self._valid_pairing(aln, mate):
                                paired_strs.append(aln)
                                mate_alns.append(mate)
                                self._write_pass(aln)
                                self._write_pass(mate)
                            else:
                                self._write_filt(aln, "NO_UNIQUE_MAPPING")
                        else:
                            other = potential_strs.get(aln_key)
                            if other is not None:
                                if other.rec.is_first_mate == aln.rec.is_first_mate:
                                    continue
                                del potential_strs[aln_key]
                                if self._valid_pairing(aln, other):
                                    paired_strs.append(aln)
                                    mate_alns.append(other)
                                    paired_strs.append(other)
                                    mate_alns.append(aln)
                                    self._write_pass(aln)
                                    self._write_pass(other)
                                else:
                                    self._write_filt(aln, "NO_UNIQUE_MAPPING")
                                    self._write_filt(other, "NO_UNIQUE_MAPPING")
                            else:
                                potential_strs[aln_key] = aln
                    else:
                        self._write_filt(aln, filter_reason)
                        potential_mates[aln_key] = aln
                else:
                    other = potential_strs.get(aln_key)
                    if other is not None:
                        if other.rec.is_first_mate == aln.rec.is_first_mate:
                            continue
                        del potential_strs[aln_key]
                        if self._valid_pairing(other, aln):
                            paired_strs.append(other)
                            mate_alns.append(aln)
                            self._write_pass(other)
                            self._write_pass(aln)
                        else:
                            self._write_filt(other, "NO_UNIQUE_MAPPING")
                    else:
                        prev = potential_mates.get(aln_key)
                        if prev is not None:
                            if prev.rec.is_first_mate != aln.rec.is_first_mate:
                                del potential_mates[aln_key]
                        else:
                            potential_mates[aln_key] = aln
            if too_many_reads:
                break

        # the reference's potential_strs is a std::map: leftover unpaired
        # reads surface in KEY-SORTED order (bam_processor.cpp:183,408-425);
        # this ordering decides read-group order and which read becomes a
        # pool's representative alignment on repeat-shifted ties
        for aln_key in sorted(potential_strs):
            aln = potential_strs[aln_key]
            if aln.get_tag("XA") is not None:
                self._write_filt(aln, "NO_UNIQUE_MAPPING")
                continue
            if not self.opts.use_unpaired:
                self._write_filt(aln, "NO_MATE_PAIR")
                continue
            unpaired_strs.append(aln)
            self._write_pass(aln)

        # group by read-group/sample; the reference pops reads off the BACK
        # of each list (bam_processor.cpp:440-470), so read-group order and
        # per-group read order follow the reversed accumulation order —
        # this decides pool-representative alignments on repeat ties
        rg_indices: Dict[str, int] = {}
        rg_names: List[str] = []
        paired_by_rg: List[List[BamAlign]] = []
        mates_by_rg: List[List[BamAlign]] = []
        unpaired_by_rg: List[List[BamAlign]] = []
        for kind, src, mates in ((0, paired_strs, mate_alns),
                                 (1, unpaired_strs, None)):
            for i in range(len(src) - 1, -1, -1):
                aln = src[i]
                rg = self._get_rg(aln)
                if rg not in rg_indices:
                    rg_indices[rg] = len(rg_names)
                    rg_names.append(rg)
                    paired_by_rg.append([])
                    mates_by_rg.append([])
                    unpaired_by_rg.append([])
                k = rg_indices[rg]
                if kind == 0:
                    paired_by_rg[k].append(aln)
                    mates_by_rg[k].append(mates[i])
                else:
                    unpaired_by_rg[k].append(aln)

        return (rg_names, paired_by_rg, mates_by_rg, unpaired_by_rg,
                too_many_reads)

    def _valid_pairing(self, aln: BamAlign, mate: BamAlign) -> bool:
        """Port of get_valid_pairings (bam_processor.cpp:97-152) reduced to
        the no-alt-tag common path; reads with XA/SA alternates are checked
        for a unique pairing within MAX_MATE_DIST."""
        def mappings(a: BamAlign):
            out = [(a.ref_name, a.pos if a is aln else a.rec.pos)]
            for tag in ("XA", "SA"):
                val = a.get_tag(tag)
                if val is None:
                    continue
                for alt in str(val).split(";"):
                    if not alt:
                        continue
                    toks = alt.split(",")
                    pos = abs(int(toks[1]))
                    if toks[0] != out[0][0] or abs(pos - out[0][1]) > 200:
                        out.append((toks[0], pos))
            return out

        # AS/XS score-gap guard
        for a, b in ((mate, aln), (aln, mate)):
            if a.get_tag("XA") is None:
                s = a.get_tag("AS")
                x = a.get_tag("XS")
                if s is not None and x is not None and s - x < 10:
                    return False

        p1 = []
        for m1 in sorted(mappings(aln)):
            for m2 in sorted(mappings(mate)):
                if m1[0] == m2[0] and abs(m1[1] - m2[1]) < self.opts.max_mate_dist:
                    p1.append(m1)
        return len(p1) == 1 and p1[0][1] == aln.pos

    # ------------------------------------------------------------------ dedup
    def remove_pcr_duplicates(self, rg_names, paired_by_rg, mates_by_rg,
                              unpaired_by_rg) -> int:
        """Port of remove_pcr_duplicates (pcr_duplicates.cpp:18-94)."""
        dup_count = 0
        bq_sum = self.bq.sum_log_prob_correct

        def qsum(aln) -> float:
            # memoized per read: the duplicate-cluster scan re-reads the
            # current best's sum on every comparison, and the fast filter
            # already computed it for overlap candidates
            v = getattr(aln, "_qual_sum", None)
            if v is None:
                v = bq_sum(aln.quals)
                aln._qual_sum = v
            return v
        for k in range(len(rg_names)):
            pairs = []
            for aln, mate in zip(paired_by_rg[k], mates_by_rg[k]):
                lib = self._get_library(aln)
                mn = min(aln.pos, mate.rec.pos)
                mx = max(aln.pos, mate.rec.pos)
                pairs.append((lib, mn, mx, aln.name, aln, mate))
            for aln in unpaired_by_rg[k]:
                lib = self._get_library(aln)
                pairs.append((lib, -1, aln.pos, aln.name, aln, None))
            pairs.sort(key=lambda t: (t[0], t[1], t[2], t[3]))
            paired_by_rg[k] = []
            mates_by_rg[k] = []
            unpaired_by_rg[k] = []
            if not pairs:
                continue

            def emit(entry, include_rev):
                lib, mn, mx, name, aln, mate = entry
                if mn == -1:
                    unpaired_by_rg[k].append(aln)
                else:
                    paired_by_rg[k].append(aln)
                    mates_by_rg[k].append(mate)
                    if include_rev:
                        paired_by_rg[k].append(mate)
                        mates_by_rg[k].append(aln)

            best = 0
            include_rev = False
            for j in range(1, len(pairs)):
                same = (pairs[j][0] == pairs[best][0]
                        and pairs[j][1] == pairs[best][1]
                        and pairs[j][2] == pairs[best][2])
                if same:
                    dup_count += 1
                    if qsum(pairs[j][4]) > qsum(pairs[best][4]):
                        best = j
                        include_rev = (pairs[best][3] == pairs[j - 1][3])
                    elif j == best + 1:
                        include_rev |= (pairs[best][3] == pairs[j][3])
                else:
                    if include_rev:
                        dup_count -= 1
                    emit(pairs[best], include_rev)
                    best = j
                    include_rev = False
            if include_rev:
                dup_count -= 1
            emit(pairs[best], include_rev)
        return dup_count

    # --------------------------------------------------------------- genotype
    def prepare_locus_genotyper(self, region: Region, chrom_seq: str
                                ) -> Optional[SeqStutterGenotyper]:
        """Host phases of analyze_reads_and_phasing
        (genotyper_bam_processor.cpp:161-289) up to the first batched
        alignment; returns a prepared genotyper or None."""
        prep = self.prepare_reads(region, chrom_seq)
        if prep is None:
            return None
        stutter_model = self.resolve_stutter_model(prep, region)
        if stutter_model is None:
            return None
        return self.finish_prepare(prep, region, chrom_seq, stutter_model)

    def prepare_reads(self, region: Region, chrom_seq: str
                      ) -> Optional["PreparedReads"]:
        """Stage 1: filters, dedup, phasing LLs, read-count guards."""
        with self.timer.time("Read filtering"):
            res = None
            if os.environ.get("HIPSTR_TPU_FAST_FILTER", "1") != "0":
                from .fast_filter import read_and_filter_reads_fast
                res = read_and_filter_reads_fast(self, region, chrom_seq)
            if res is None:
                res = self.read_and_filter_reads(region, chrom_seq)
            (rg_names, paired_by_rg, mates_by_rg, unpaired_by_rg,
             too_many) = res
            if self.opts.sample_set is not None:
                # --sample-list restriction (reference:
                # bam_processor.cpp:589-609)
                allowed = set(self.opts.sample_set)
                keep = [i for i, rg in enumerate(rg_names) if rg in allowed]
                rg_names = [rg_names[i] for i in keep]
                paired_by_rg = [paired_by_rg[i] for i in keep]
                mates_by_rg = [mates_by_rg[i] for i in keep]
                unpaired_by_rg = [unpaired_by_rg[i] for i in keep]
            if self.opts.remove_pcr_dups:
                self.remove_pcr_duplicates(rg_names, paired_by_rg,
                                           mates_by_rg, unpaired_by_rg)

        # merge paired + unpaired per rg; compute phasing LLs from the
        # phased-SNP VCF when available (reference: snp_bam_processor.cpp:35-124)
        alns_by_rg: List[List[BamAlign]] = []
        for k in range(len(rg_names)):
            alns_by_rg.append(paired_by_rg[k] + unpaired_by_rg[k])
        log_p1s = [[0.0] * len(a) for a in alns_by_rg]
        log_p2s = [[0.0] * len(a) for a in alns_by_rg]
        if self.opts.bams_from_10x:
            log_p1s, log_p2s = self._phase_from_10x_tags(
                paired_by_rg, unpaired_by_rg)
        elif self.snp_vcf is not None:
            with self.timer.time("SNP info extraction"):
                from ..phasing.snp_phasing import (calc_het_snp_factors,
                                                   create_snp_sets)
                SKIP_PADDING = 15
                if self.haplotype_tracker is not None:
                    self.haplotype_tracker.advance(region.chrom, region.start)
                res = create_snp_sets(
                    region.chrom,
                    max(1, region.start - self.opts.max_mate_dist),
                    region.stop + self.opts.max_mate_dist, [region],
                    SKIP_PADDING, self.snp_vcf, self.haplotype_tracker)
                if res is not None:
                    snp_sets, _ = res
                    counts: Dict[str, int] = {}
                    for k, rg in enumerate(rg_names):
                        if rg in snp_sets:
                            p1a, p2a = calc_het_snp_factors(
                                paired_by_rg[k], mates_by_rg[k], self.bq,
                                snp_sets[rg], counts)
                            p1b, p2b = calc_het_snp_factors(
                                unpaired_by_rg[k], None, self.bq,
                                snp_sets[rg], counts)
                            log_p1s[k] = p1a + p1b
                            log_p2s[k] = p2a + p2b
                    self.phase_match_count += counts.get("match", 0)
                    self.phase_mismatch_count += counts.get("mismatch", 0)

        total_reads = sum(len(a) for a in alns_by_rg)
        if total_reads < self.opts.min_reads:
            self.logger.log(f"Skipping locus {region}: too few reads "
                            f"({total_reads} < {self.opts.min_reads})")
            self.counters.too_few_reads += 1
            return None
        if too_many:
            self.counters.too_many_reads += 1
            return None

        haploid = region.chrom in self.opts.haploid_chroms
        return PreparedReads(rg_names, alns_by_rg, log_p1s, log_p2s, haploid)

    def resolve_stutter_model(self, prep: "PreparedReads", region: Region
                              ) -> Optional[StutterModel]:
        """Stage 2: stutter model selection (default / file / host EM);
        counters updated on failure (genotyper_bam_processor.cpp:161-221)."""
        rg_names, alns_by_rg = prep.rg_names, prep.alns_by_rg
        log_p1s, log_p2s, haploid = prep.log_p1s, prep.log_p2s, prep.haploid
        if self.opts.def_stutter_model is not None:
            stutter_model = self.opts.def_stutter_model.with_period(region.period)
        elif self.opts.stutter_in:
            stutter_model = self.stutter_models.get(
                (region.chrom, region.start, region.stop))
            if stutter_model is None:
                self.logger.log(f"WARNING: no stutter model for {region}")
                self.counters.missing_model += 1
                return None
        else:
            with self.timer.time("Stutter estimation"):
                stutter_model = self.learn_stutter_model(
                    alns_by_rg, log_p1s, log_p2s, haploid, rg_names, region)
            if stutter_model is None:
                return None
            self.register_learned_model(region, stutter_model)
        if self.opts.skip_genotyping:
            # --skip-genotyping: stop after stutter-model estimation
            # (reference: hipstr_main.cpp:387,513 — no VCF writer is opened,
            # so genotyper_bam_processor.cpp:222 skips the genotyping block)
            return None
        return stutter_model

    def register_learned_model(self, region: Region,
                               stutter_model: StutterModel) -> None:
        """Record an EM-learned model for --stutter-out."""
        if self.opts.stutter_out:
            self._stutter_out[(region.chrom, region.start,
                               region.stop)] = stutter_model

    def finish_prepare(self, prep: "PreparedReads", region: Region,
                       chrom_seq: str, stutter_model: StutterModel
                       ) -> Optional[SeqStutterGenotyper]:
        """Stage 3: left alignment, ref-panel alleles, genotyper build."""
        rg_names, alns_by_rg = prep.rg_names, prep.alns_by_rg
        log_p1s, log_p2s, haploid = prep.log_p1s, prep.log_p2s, prep.haploid
        with self.timer.time("Left alignment"):
            left_alns, filt_p1s, filt_p2s = self.left_align_reads(
                region, chrom_seq, alns_by_rg, log_p1s, log_p2s)

        ref_vcf_alleles = None
        if self.ref_vcf is not None:
            from ..io.vcf_read import read_vcf_alleles
            res = read_vcf_alleles(self.ref_vcf, region)
            if res is None:
                self.logger.log(f"No reference-panel alleles for {region}")
                self.counters.genotype_fail += 1
                return None
            ref_vcf_alleles = res

        # the haplotypes and candidate alleles
        with self.timer.time("Genotyper build"):
            g = SeqStutterGenotyper(
                region, haploid, True, left_alns, filt_p1s,
                filt_p2s, rg_names, chrom_seq, stutter_model,
                ref_vcf_alleles=ref_vcf_alleles, dtype=self.opts.dtype,
                logger=self.logger)
            if not g.initialized:
                self.counters.genotype_fail += 1
                return None
            if g.num_alleles > self.opts.max_haps:
                self.logger.log(
                    f"Aborting {region}: too many candidate haplotypes")
                self.counters.genotype_fail += 1
                return None
            if not g.genotype_prepare():
                self.counters.genotype_fail += 1
                return None
        return g

    def analyze_region(self, region: Region, chrom_seq: str,
                       vcf_writer: Optional[VCFWriter]) -> None:
        g = self.prepare_locus_genotyper(region, chrom_seq)
        if g is None or vcf_writer is None:
            return
        with self.timer.time("Genotyping"):
            g.calc_hap_aln_probs()
            genotyped = g.genotype_finish(self.opts.max_haps,
                                          self.opts.max_hap_flanks,
                                          self.opts.min_flank_freq)
        if genotyped:
            rec, viz = locus_record(self, g, region, chrom_seq)
            vcf_writer.add_vcf_record(*rec)
            if viz is not None and self.viz_writer is not None:
                self.viz_writer.add(*viz)
        else:
            self.counters.genotype_fail += 1

    def _phase_from_10x_tags(self, paired_by_rg, unpaired_by_rg):
        """10x Genomics HP-tag phasing (reference:
        snp_bam_processor.cpp:141-204): HP=1/2 assigns FROM_HAP_LL to the
        tagged haplotype and OTHER_HAP_LL to the other."""
        FROM_HAP_LL, OTHER_HAP_LL = -0.01, -1000.0
        log_p1s, log_p2s = [], []
        for k in range(len(paired_by_rg)):
            p1s, p2s = [], []
            for aln in paired_by_rg[k] + unpaired_by_rg[k]:
                hap = aln.get_tag("HP")
                if hap == 1:
                    p1s.append(FROM_HAP_LL)
                    p2s.append(OTHER_HAP_LL)
                elif hap == 2:
                    p1s.append(OTHER_HAP_LL)
                    p2s.append(FROM_HAP_LL)
                else:
                    p1s.append(0.0)
                    p2s.append(0.0)
            log_p1s.append(p1s)
            log_p2s.append(p2s)
        return log_p1s, log_p2s

    def stutter_em_inputs(self, alns_by_rg, log_p1s, log_p2s,
                          region: Region):
        """STR bp-diff extraction + informative-read guard (the front half
        of learn_stutter_model, genotyper_bam_processor.cpp:104-123);
        returns (str_bps, p1s, p2s) or None with counters updated."""
        from ..align.alignment_data import CigarElement, extract_cigar_bp_diff
        MAX_INF_READS = 10000
        str_bps = [[] for _ in alns_by_rg]
        p1s = [[] for _ in alns_by_rg]
        p2s = [[] for _ in alns_by_rg]
        inf_reads = 0
        for i, alns in enumerate(alns_by_rg):
            for j, aln in enumerate(alns):
                cig = [CigarElement(op, n) for n, op in aln.cigar]
                diff = extract_cigar_bp_diff(
                    cig, aln.pos, region.start - region.period,
                    region.stop + region.period)
                if diff is None:
                    continue
                if diff < -(region.stop - region.start + 1):
                    continue
                inf_reads += 1
                str_bps[i].append(diff)
                p1s[i].append(log_p1s[i][j])
                p2s[i].append(log_p2s[i][j])
            if inf_reads > MAX_INF_READS:
                break
        if inf_reads < self.opts.min_reads:
            self.logger.log(f"Skipping locus {region}: too few informative "
                            f"reads for stutter training ({inf_reads})")
            self.counters.too_few_reads += 1
            return None
        return str_bps, p1s, p2s

    def learn_stutter_model(self, alns_by_rg, log_p1s, log_p2s, haploid,
                            rg_names, region: Region) -> Optional[StutterModel]:
        """Port of learn_stutter_model
        (genotyper_bam_processor.cpp:104-159)."""
        inputs = self.stutter_em_inputs(alns_by_rg, log_p1s, log_p2s, region)
        if inputs is None:
            return None
        str_bps, p1s, p2s = inputs
        em = EMStutterGenotyper(haploid, region.period, str_bps, p1s, p2s,
                                ref_allele=0)
        res = em.train(self.opts.max_em_iter, self.opts.abs_ll_converge,
                       self.opts.frac_ll_converge)
        if not res.converged:
            self.counters.em_fail += 1
            self.logger.log(f"Stutter EM failed for {region}")
            return None
        return res.stutter_model

    def left_align_reads(self, region: Region, chrom_seq: str, alns_by_rg,
                         log_p1s, log_p2s):
        """Port of left_align_reads (genotyper_bam_processor.cpp:38-102).

        Reference-matching reads (the vast majority) are converted in ONE
        native batch call per locus (native/left_align.cpp); only reads
        carrying indels run the NW realigner.  Dedup and ordering semantics
        are identical to the per-read path.
        """
        from .. import native as _native

        # pass 1: trim every read, collect the unique reference-matching
        # reads that will need a conversion
        entries = []       # (rg_index, aln, log_p1, log_p2)
        conv_keys: Dict[Tuple[str, int], int] = {}
        conv_batch = []
        for i, alns in enumerate(alns_by_rg):
            for j, aln in enumerate(alns):
                aln.trim_alignment(region.start - 40 if region.start > 40 else 1,
                                   region.stop + 40)
                if aln.length == 0:
                    continue
                entries.append((i, aln, log_p1s[i][j], log_p2s[i][j]))
                if aln.matches_reference():
                    key = (aln.bases, aln.pos)
                    if key not in conv_keys:
                        conv_keys[key] = len(conv_batch)
                        conv_batch.append((aln.pos, aln.bases, aln.cigar))
        conv_res = None
        if conv_batch:
            chrom_b = self.__dict__.get("_chrom_seq_bytes")
            if chrom_b is None or self.__dict__.get("_chrom_seq_for") \
                    is not chrom_seq:
                chrom_b = chrom_seq.encode("latin1")
                self._chrom_seq_bytes = chrom_b
                self._chrom_seq_for = chrom_seq
            conv_res = _native.convert_aln_batch_native(chrom_b, conv_batch)

        def materialize_convert(aln) -> Alignment:
            if conv_res is not None:
                stop, aln_str, cig = conv_res[conv_keys[(aln.bases, aln.pos)]]
                new_aln = Alignment(aln.pos, stop, aln.rec.is_reverse,
                                    aln.name, aln.quals, aln.bases.upper(),
                                    aln_str)
                new_aln.cigar = [CigarElement(op, n) for op, n in cig]
                return new_aln
            return convert_alignment(aln.pos, aln.name, aln.bases, aln.quals,
                                     aln.rec.is_reverse, aln.cigar, chrom_seq)

        # pass 2: original dedup/copy logic over the trimmed reads
        seq_to_aln: Dict[str, int] = {}
        left_alns: List[Alignment] = []
        filt_p1s = [[] for _ in alns_by_rg]
        filt_p2s = [[] for _ in alns_by_rg]
        for i, aln, p1, p2 in entries:
            idx = seq_to_aln.get(aln.bases)
            have_prev = idx is not None and \
                len(left_alns[idx].sequence) == len(aln.bases)
            if not have_prev:
                if aln.matches_reference():
                    new_aln = materialize_convert(aln)
                else:
                    new_aln = realign(aln.pos, aln.end_pos, aln.name,
                                      aln.bases, aln.quals,
                                      aln.rec.is_reverse, chrom_seq)
                if new_aln is None:
                    continue
                left_alns.append(new_aln)
                seq_to_aln[aln.bases] = len(left_alns) - 1
            else:
                prev = left_alns[idx]
                new_aln = Alignment(prev.start, prev.stop,
                                    aln.rec.is_reverse, aln.name,
                                    aln.quals, aln.bases.upper(),
                                    prev.alignment)
                new_aln.cigar = list(prev.cigar)
                left_alns.append(new_aln)
            left_alns[-1].use_for_haps = [getattr(aln, "pass_two", "0") == "1"]
            filt_p1s[i].append(p1)
            filt_p2s[i].append(p2)
        return left_alns, filt_p1s, filt_p2s
