"""Copy of hipstr_tpu/phasing/snp_phasing.py.

Per-sample heterozygous-SNP sets and read phasing likelihoods.

Capability parity with the reference SNP phasing layer (reference:
src/snp_tree.{h,cpp} create_snp_trees, src/snp_phasing_quality.{h,cpp}):
phased het SNPs per sample over a locus window (with optional
pedigree-consistency filtering via the haplotype tracker), and per-read
log P(read | haplotype 1/2) factors from base qualities at overlapped SNPs.

The reference's centered interval tree over point SNPs is replaced by a
sorted position array + binary search (identical query semantics for point
intervals).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..io.regions import Region
from ..io.vcf_read import VCFReader
from ..models.base_quality import BaseQuality
from .pedigree import NuclearFamily

MAX_BEST_SCORE = 10          # reference: DenovoScanner constants
MIN_SECOND_BEST_SCORE = 100


@dataclass(frozen=True)
class SNP:
    pos: int     # 0-based
    base_one: str
    base_two: str


class SampleSNPs:
    """Sorted het-SNP set for one sample with range queries."""

    def __init__(self, snps: List[SNP]):
        self.snps = sorted(snps, key=lambda s: s.pos)
        self._positions = [s.pos for s in self.snps]

    def find_contained(self, start: int, stop: int) -> List[SNP]:
        """SNPs with start <= pos <= stop."""
        lo = bisect.bisect_left(self._positions, start)
        hi = bisect.bisect_right(self._positions, stop)
        return self.snps[lo:hi]

    def __len__(self):
        return len(self.snps)


def in_any_region(pos: int, skip_regions: Sequence[Region], pad: int) -> bool:
    return any(r.start - pad <= pos <= r.stop + pad for r in skip_regions)


def create_snp_sets(chrom: str, start: int, end: int,
                    skip_regions: Sequence[Region], skip_padding: int,
                    snp_vcf: VCFReader, tracker=None
                    ) -> Optional[Tuple[Dict[str, SampleSNPs], int]]:
    """Build per-sample phased-het-SNP sets over [start, end).

    Reference: create_snp_trees (snp_tree.cpp:25-113).  When a haplotype
    tracker is provided, SNPs at sites inconsistent with the family
    inheritance structure are removed (or all of a family's SNPs when its
    haplotypes can't be confidently matched).
    """
    if not snp_vcf.has_chrom(chrom):
        return None

    snps_by_sample: Dict[str, List[SNP]] = {s: [] for s in snp_vcf.samples}
    families = tracker.families if tracker is not None else []
    bad_sites_by_family: List[Set[int]] = [set() for _ in families]
    count = 0
    for variant in snp_vcf.query(chrom, start, end):
        if not variant.is_biallelic_snp():
            continue
        if in_any_region(variant.pos + 1, skip_regions, skip_padding):
            continue
        for fi, family in enumerate(families):
            if family.is_missing_genotype(variant) or \
                    not family.is_mendelian(variant):
                bad_sites_by_family[fi].add(variant.pos + 1)
        count += 1
        for s in snp_vcf.samples:
            gt = variant.genotype(s)
            if gt is None or not gt[2]:
                continue
            a, b, _ = gt
            if a != b:
                snps_by_sample[s].append(
                    SNP(variant.pos, variant.alleles[a][0],
                        variant.alleles[b][0]))

    if tracker is not None:
        for fi, family in enumerate(families):
            ok, _, _, bad = tracker.infer_haplotype_inheritance(
                family, MAX_BEST_SCORE, MIN_SECOND_BEST_SCORE,
                bad_sites_by_family[fi])
            for s in family.get_samples():
                if s not in snps_by_sample:
                    continue
                if not ok:
                    snps_by_sample[s] = []
                else:
                    bad0 = {p - 1 for p in bad}
                    snps_by_sample[s] = [
                        snp for snp in snps_by_sample[s]
                        if snp.pos not in bad0]

    return {s: SampleSNPs(v) for s, v in snps_by_sample.items()}, count


def extract_bases_and_qualities(aln, snps: List[SNP]) -> Tuple[List[str], List[str]]:
    """Base + quality at each SNP position in a read
    (reference: snp_phasing_quality.cpp:4-61).  `aln` needs .pos, .cigar
    [(n, op)], .bases, .quals."""
    bases: List[str] = []
    quals: List[str] = []
    pos = aln.pos
    snp_index = 0
    ci = 0
    base_index = 0
    cigar = aln.cigar
    while snp_index < len(snps) and ci < len(cigar):
        n, op = cigar[ci]
        if op in "M=X":
            if snps[snp_index].pos < pos + n:
                bases.append(aln.bases[snps[snp_index].pos - pos + base_index])
                quals.append(aln.quals[snps[snp_index].pos - pos + base_index])
                snp_index += 1
            else:
                pos += n
                base_index += n
                ci += 1
        elif op == "D":
            if snps[snp_index].pos < pos + n:
                bases.append("-")
                quals.append("-")
                snp_index += 1
            else:
                pos += n
                ci += 1
        elif op == "I":
            base_index += n
            ci += 1
        elif op == "S":
            if snps[snp_index].pos < pos:
                bases.append("-")
                quals.append("-")
                snp_index += 1
            else:
                base_index += n
                ci += 1
        elif op == "H":
            ci += 1
        else:
            raise AssertionError("bad CIGAR in extract_bases_and_qualities")
    return bases, quals


def add_log_phasing_probs(aln, sample_snps: SampleSNPs, bq: BaseQuality,
                          counts: dict) -> Tuple[float, float]:
    """Reference: snp_phasing_quality.cpp:63-94."""
    log_p1 = log_p2 = 0.0
    snps = sample_snps.find_contained(aln.pos, aln.end_pos - 1)
    if snps:
        bases, quals = extract_bases_and_qualities(aln, snps)
        for snp, base, qual in zip(snps, bases, quals):
            if base == "-":
                continue
            if base == snp.base_one:
                log_p1 += bq.log_prob_correct(qual)
                log_p2 += bq.log_prob_error(qual)
                counts["match"] = counts.get("match", 0) + 1
            elif base == snp.base_two:
                log_p1 += bq.log_prob_error(qual)
                log_p2 += bq.log_prob_correct(qual)
                counts["match"] = counts.get("match", 0) + 1
            else:
                log_p1 += bq.log_prob_error(qual)
                log_p2 += bq.log_prob_error(qual)
                counts["mismatch"] = counts.get("mismatch", 0) + 1
    return log_p1, log_p2


def calc_het_snp_factors(str_reads, mate_reads, bq: BaseQuality,
                         sample_snps: SampleSNPs, counts: dict
                         ) -> Tuple[List[float], List[float]]:
    """Reference: snp_phasing_quality.cpp:95-120 (paired + unpaired)."""
    log_p1s, log_p2s = [], []
    for i, read in enumerate(str_reads):
        p1, p2 = add_log_phasing_probs(read, sample_snps, bq, counts)
        if mate_reads is not None:
            m1, m2 = add_log_phasing_probs(mate_reads[i], sample_snps, bq,
                                           counts)
            p1 += m1
            p2 += m2
        log_p1s.append(p1)
        log_p2s.append(p2)
    return log_p1s, log_p2s
