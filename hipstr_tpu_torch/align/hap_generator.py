"""Copy of hipstr_tpu/align/hap_generator.py.

Candidate-allele discovery and haplotype construction.

Capability parity with the reference HaplotypeGenerator (reference:
src/SeqAlignment/HaplotypeGenerator.{h,cpp}): extracts each spanning read's
sequence over the padded STR region, keeps alleles passing the
strong-sample / fraction-of-samples / fraction-of-reads thresholds
(HaplotypeGenerator.h:52-65), trims shared prefix/suffix down to ~3 repeat
units, and fuses variant blocks with reference-only flank blocks capped at
REF_FLANK_LEN.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..io.regions import Region
from ..models.stutter import StutterModel
from .alignment_data import Alignment
from .haplotype import HapBlock, Haplotype, RepeatInfo

MIN_FRAC_READS = 0.05
MIN_FRAC_SAMPLES = 0.05
MIN_FRAC_STRONG_SAMPLE = 0.2
MIN_READS_STRONG_SAMPLE = 2
MIN_STRONG_SAMPLES = 1
LEFT_PAD = 5
RIGHT_PAD = 5
MIN_BLOCK_SPACING = 10
REF_FLANK_LEN = 35


def order_by_length_and_sequence(seq: str):
    """Sort key equivalent of the reference's orderByLengthAndSequence."""
    return (len(seq), seq)


class HaplotypeGenerator:
    def __init__(self, min_aln_start: int, max_aln_stop: int):
        self.min_aln_start = min_aln_start
        self.max_aln_stop = max_aln_stop
        self.hap_blocks: List[HapBlock] = []
        self.failure_msg = ""
        self.finished = False

    # ---- allele extraction ---------------------------------------------------
    @staticmethod
    def extract_sequence(aln: Alignment, region_start: int,
                         region_end: int) -> Optional[str]:
        """Sequence a spanning read implies over [region_start, region_end).

        Literal port of HaplotypeGenerator::extract_sequence
        (HaplotypeGenerator.cpp:82-155); walks the gapped alignment string.
        """
        if aln.start >= region_start or aln.stop <= region_end:
            return None
        align_index = 0
        char_index = 0
        pos = aln.start
        cigar = aln.cigar
        ci = 0
        parts: List[str] = []
        while ci < len(cigar):
            el = cigar[ci]
            if char_index == el.num:
                ci += 1
                char_index = 0
                continue
            if pos > region_end:
                return "".join(parts).upper()
            if pos == region_end:
                if el.type == "I":
                    parts.append(aln.alignment[align_index:align_index + el.num])
                    align_index += el.num
                    char_index = 0
                    ci += 1
                    continue
                return "".join(parts).upper()
            if pos >= region_start:
                num = min(region_end - pos, el.num - char_index)
                if el.type == "I":
                    num = el.num
                    parts.append(aln.alignment[align_index:align_index + num])
                elif el.type in "=X":
                    parts.append(aln.alignment[align_index:align_index + num])
                    pos += num
                elif el.type == "D":
                    pos += num
                else:
                    raise AssertionError("bad CIGAR op in extract_sequence")
                align_index += num
                char_index += num
            else:
                if el.type == "I":
                    num = el.num - char_index
                else:
                    num = min(region_start - pos, el.num - char_index)
                    pos += num
                align_index += num
                char_index += num
        raise AssertionError("logical error in extract_sequence")

    @staticmethod
    def _trim(ideal_min_length: int, region_start: int, region_end: int,
              sequences: List[str]) -> Tuple[int, int]:
        """Trim shared flanks (HaplotypeGenerator.cpp:12-80); returns new
        (region_start, region_end), mutating `sequences` in place."""
        min_len = min(len(s) for s in sequences)
        if min_len <= ideal_min_length:
            return region_start, region_end

        max_left = 0
        while max_left < min_len - ideal_min_length:
            if any(sequences[j][max_left] != sequences[j - 1][max_left]
                   for j in range(1, len(sequences))):
                break
            max_left += 1
        max_right = 0
        while max_right < min_len - ideal_min_length:
            c = sequences[0][len(sequences[0]) - 1 - max_right]
            if any(sequences[j][len(sequences[j]) - 1 - max_right] != c
                   for j in range(1, len(sequences))):
                break
            max_right += 1

        max_left = min(LEFT_PAD, max_left)
        max_right = min(RIGHT_PAD, max_right)
        max_left = max(0, min(min_len - RIGHT_PAD, max_left))
        max_right = max(0, min(min_len - LEFT_PAD, max_right))

        if min_len - 2 * min(max_left, max_right) <= ideal_min_length:
            left = right = min(max_left, max_right)
            while min_len - left - right < ideal_min_length:
                if left > right:
                    left -= 1
                else:
                    right -= 1
        else:
            if max_left > max_right:
                right = max_right
                left = min(max_left, min_len - ideal_min_length - max_right)
            else:
                left = max_left
                right = min(max_right, min_len - ideal_min_length - max_left)

        for i in range(len(sequences)):
            sequences[i] = sequences[i][left:len(sequences[i]) - right]
        return region_start + left, region_end - right

    def gen_candidate_seqs(self, ref_seq: str, ideal_min_length: int,
                           alignments_by_sample: List[List[Alignment]],
                           vcf_alleles: List[str],
                           region_start: int, region_end: int):
        """Returns (region_start, region_end, sequences) with ref first.

        Port of gen_candidate_seqs (HaplotypeGenerator.cpp:157-241).
        """
        sample_counts: Dict[str, float] = {}
        read_counts: Dict[str, int] = {}
        must_inc: Dict[str, int] = {}
        tot_reads = 0
        tot_samples = 0

        for sample_alns in alignments_by_sample:
            samp_reads = 0
            counts: Dict[str, int] = {}
            for aln in sample_alns:
                seq = self.extract_sequence(aln, region_start, region_end)
                if seq is not None:
                    read_counts[seq] = read_counts.get(seq, 0) + 1
                    counts[seq] = counts.get(seq, 0) + 1
                    tot_reads += 1
                    samp_reads += 1
            for seq, cnt in counts.items():
                if cnt >= MIN_READS_STRONG_SAMPLE and cnt >= MIN_FRAC_STRONG_SAMPLE * samp_reads:
                    must_inc[seq] = must_inc.get(seq, 0) + 1
                sample_counts[seq] = sample_counts.get(seq, 0.0) + cnt / samp_reads
            if samp_reads > 0:
                tot_samples += 1

        sequences: List[str] = []
        ref_index = -1
        for allele in vcf_alleles:
            sequences.append(allele)
            sample_counts.pop(allele, None)
            read_counts.pop(allele, None)
            must_inc.pop(allele, None)
            if allele == ref_seq:
                ref_index = len(sequences) - 1

        for seq, nsupport in sorted(must_inc.items()):
            if nsupport >= MIN_STRONG_SAMPLES:
                sample_counts.pop(seq, None)
                read_counts.pop(seq, None)
                sequences.append(seq)
                if seq == ref_seq:
                    ref_index = len(sequences) - 1

        for seq, frac in sorted(sample_counts.items()):
            if frac > MIN_FRAC_SAMPLES * tot_samples or \
                    read_counts.get(seq, 0) > MIN_FRAC_READS * tot_reads:
                sequences.append(seq)
                if ref_index == -1 and seq == ref_seq:
                    ref_index = len(sequences) - 1

        if ref_index == -1:
            sequences.insert(0, ref_seq)
        else:
            sequences[ref_index] = sequences[0]
            sequences[0] = ref_seq

        sequences[1:] = sorted(sequences[1:], key=order_by_length_and_sequence)
        region_start, region_end = self._trim(ideal_min_length, region_start,
                                              region_end, sequences)
        return region_start, region_end, sequences

    # ---- block construction --------------------------------------------------
    def add_haplotype_block(self, region: Region, chrom_seq: str,
                            alignments_by_sample: List[List[Alignment]],
                            vcf_alleles: List[str],
                            stutter_model: StutterModel) -> bool:
        """Port of add_haplotype_block (HaplotypeGenerator.cpp:286-337)."""
        assert not self.failure_msg
        if region.start < REF_FLANK_LEN + LEFT_PAD or \
                region.stop + REF_FLANK_LEN + RIGHT_PAD > len(chrom_seq):
            self.failure_msg = "Haplotype blocks are too near to the chromosome ends"
            return False

        region_start = region.start - LEFT_PAD
        region_end = region.stop + RIGHT_PAD
        ref_seq = chrom_seq[region_start:region_end].upper()
        # the spanning check uses the bounds of the HAP-GEN-ELIGIBLE reads
        # only (reference: get_aln_bounds over the passed alignments,
        # HaplotypeGenerator.cpp:297-307 — the locals shadow the
        # constructor-wide bounds); with zero eligible reads the reference's
        # INT_MAX/INT_MIN sentinels overflow and neither condition fires
        starts = [a.start for sub in alignments_by_sample for a in sub]
        stops = [a.stop for sub in alignments_by_sample for a in sub]
        if starts:
            if min(starts) + 5 >= region_start or \
                    max(stops) - 5 <= region_end:
                self.failure_msg = "No spanning alignments"
                return False

        padded_vcf = []
        if vcf_alleles:
            lflank = chrom_seq[region_start:region.start].upper()
            rflank = chrom_seq[region.stop:region_end].upper()
            padded_vcf = [lflank + a.upper() + rflank for a in vcf_alleles]
            assert padded_vcf[0] == ref_seq

        ideal_min_length = 3 * region.period
        region_start, region_end, sequences = self.gen_candidate_seqs(
            ref_seq, ideal_min_length, alignments_by_sample, padded_vcf,
            region_start, region_end)

        if self.hap_blocks and region_start < self.hap_blocks[-1].end + MIN_BLOCK_SPACING:
            self.failure_msg = "Haplotype blocks are too near to one another"
            return False

        block = HapBlock(region_start, region_end, sequences[0],
                         RepeatInfo(stutter_model.period, stutter_model))
        for alt in sequences[1:]:
            block.add_alternate(alt)
        self.hap_blocks.append(block)
        return True

    def add_vcf_haplotype_block(self, pos: int, chrom_seq: str,
                                vcf_alleles: List[str],
                                stutter_model: StutterModel) -> bool:
        """Port of add_vcf_haplotype_block (HaplotypeGenerator.cpp:256-284)."""
        assert not self.failure_msg and vcf_alleles
        region_start = pos
        region_end = region_start + len(vcf_alleles[0])
        assert vcf_alleles[0].upper() == \
            chrom_seq[region_start:region_end].upper()

        if region_start < REF_FLANK_LEN or \
                region_end + REF_FLANK_LEN >= len(chrom_seq):
            self.failure_msg = "Haplotype blocks are too near to the chromosome ends"
            return False
        if self.hap_blocks and region_start < self.hap_blocks[-1].end + MIN_BLOCK_SPACING:
            self.failure_msg = "Haplotype blocks are too near to one another"
            return False

        block = HapBlock(region_start, region_end, vcf_alleles[0].upper(),
                         RepeatInfo(stutter_model.period, stutter_model))
        for alt in vcf_alleles[1:]:
            block.add_alternate(alt.upper())
        self.hap_blocks.append(block)
        return True

    def fuse_haplotype_blocks(self, chrom_seq: str) -> bool:
        """Interleave variant blocks with reference flank blocks
        (HaplotypeGenerator.cpp:339-366)."""
        assert not self.failure_msg and self.hap_blocks
        assert REF_FLANK_LEN > 10
        assert self.hap_blocks[0].start >= REF_FLANK_LEN
        assert self.hap_blocks[-1].end + REF_FLANK_LEN <= len(chrom_seq)

        min_start = min(self.hap_blocks[0].start - 10,
                        max(self.hap_blocks[0].start - REF_FLANK_LEN,
                            self.min_aln_start))
        max_stop = max(self.hap_blocks[-1].end + 10,
                       min(self.hap_blocks[-1].end + REF_FLANK_LEN,
                           self.max_aln_stop))

        fused: List[HapBlock] = []
        start = min_start
        for blk in self.hap_blocks:
            end = blk.start
            fused.append(HapBlock(start, end, chrom_seq[start:end].upper()))
            fused.append(blk)
            start = blk.end
        fused.append(HapBlock(start, max_stop, chrom_seq[start:max_stop].upper()))
        self.hap_blocks = fused
        self.finished = True
        return True
