"""Copy of hipstr_tpu/utils/simulate.py.

STR locus read simulator.

Generates diploid samples and stutter/error-bearing reads for end-to-end
tests and benchmarks — the same strategy as the reference's EM simulation
harness (reference: test/run_stutter_em_tests.sh), extended to full sequence
reads so the whole genotyping stack can be exercised and compared against the
reference binary on identical inputs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..align.alignment_data import Alignment
from ..align.realign import realign
from ..io.regions import Region
from ..models.stutter import StutterModel

BASES = "ACGT"

# standard Illumina TruSeq R1 adapter (the same constant family the
# reference trims, src/adapter_trimmer.cpp)
ADAPTER = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"


@dataclass
class SimulatedLocus:
    chrom: str
    chrom_seq: str
    region: Region
    motif: str
    ref_units: int
    allele_pool: List[int]          # repeat-unit counts
    true_genotypes: List[Tuple[int, int]]   # per-sample unit counts
    alns: List[Alignment] = field(default_factory=list)
    log_p1: List[List[float]] = field(default_factory=list)
    log_p2: List[List[float]] = field(default_factory=list)
    sample_names: List[str] = field(default_factory=list)
    raw_reads: List[dict] = field(default_factory=list)  # for BAM export
    snp: Optional[dict] = None


def _rand_seq(rng, n):
    return "".join(rng.choice(list(BASES), size=n))


def _sample_stutter(rng, model: StutterModel):
    r = rng.random()
    p = model
    if r < p.in_up:
        return int(rng.geometric(p.in_geom)) * p.period
    if r < p.in_up + p.in_down:
        return -int(rng.geometric(p.in_geom)) * p.period
    if r < p.in_up + p.in_down + p.out_up:
        d = int(rng.geometric(p.out_geom))
        if d % p.period == 0:
            d += 1
        return d
    if r < p.in_up + p.in_down + p.out_up + p.out_down:
        d = -int(rng.geometric(p.out_geom))
        if (-d) % p.period == 0:
            d -= 1
        return d
    return 0


def _realistic_quals(rng, n: int) -> str:
    """Position-decaying Illumina-like quality curve with jitter and
    occasional bad cycles (phred+33)."""
    pos = np.arange(n) / max(1, n - 1)
    q = 38.0 - 12.0 * pos ** 1.5 + rng.normal(0.0, 2.0, n)
    bad = rng.random(n) < 0.01
    q = q - np.where(bad, rng.uniform(10.0, 25.0, n), 0.0)
    q = np.clip(np.round(q), 2, 40).astype(int)
    return "".join(chr(33 + int(v)) for v in q)


def _messy_record(rng, rd: dict, read_len: int, chrom: str) -> List[dict]:
    """Apply real-data artifacts to one exported read record: decaying
    quality curves with quality-driven errors, N bases, soft-clipped ends,
    adapter read-through, MAPQ variation, XA multimappers, and PCR
    duplicates.  Returns the record(s) to export (realism affects the BAM
    surface both engines consume; the in-memory alns stay clean)."""
    seq = list(rd["seq"])
    quals = _realistic_quals(rng, read_len)
    for i in range(read_len):
        if rng.random() < 10.0 ** (-(ord(quals[i]) - 33) / 10.0):
            seq[i] = rng.choice([b for b in BASES if b != seq[i]])
    if rng.random() < 0.02:
        seq[int(rng.integers(0, read_len))] = "N"

    cigar = [(read_len, "M")]
    pos = rd["start"]
    if rng.random() < 0.10:              # left soft clip (garbage bases)
        k = int(rng.integers(3, 11))
        seq[:k] = list(_rand_seq(rng, k))
        cigar = [(k, "S"), (read_len - k, "M")]
        pos += k
    if rng.random() < 0.10:              # right clip / adapter read-through
        k = int(rng.integers(5, 18))
        tail = (list(ADAPTER[:k]) if rng.random() < 0.5
                else list(_rand_seq(rng, k)))
        seq[read_len - k:] = tail
        n_m, op = cigar[-1]
        cigar = cigar[:-1] + [(n_m - k, op), (k, "S")]

    out = dict(rd)
    out["seq"] = "".join(seq)
    out["quals"] = quals
    out["start"] = pos
    out["cigar"] = cigar
    out["mapq"] = 60
    r = rng.random()
    if r < 0.03:                         # multimapper: both engines drop it
        out["mapq"] = 0
        out["tags"] = {"XA": ("Z", f"{chrom},+{pos + 50},{read_len}M,2;")}
    elif r < 0.08:
        out["mapq"] = int(rng.choice([20, 30, 40]))
    recs = [out]
    if rng.random() < 0.05:              # PCR duplicate (dedup path)
        dup = dict(out)
        dup["name"] = out["name"] + "dup"
        recs.append(dup)
    return recs


def _messy_mate(rng, rd: dict, read_len: int) -> dict:
    """Position-preserving artifacts for one mate of a proper pair:
    decaying quality curve with quality-driven errors, N bases, and
    3'-end clips / adapter read-through (left clips would shift pos and
    desync the mate's mate_pos, so pairs only get right-end artifacts —
    which is also where real fragment-shorter-than-read adapter
    contamination lands)."""
    seq = list(rd["seq"])
    quals = _realistic_quals(rng, read_len)
    for i in range(read_len):
        if rng.random() < 10.0 ** (-(ord(quals[i]) - 33) / 10.0):
            seq[i] = rng.choice([b for b in BASES if b != seq[i]])
    if rng.random() < 0.02:
        seq[int(rng.integers(0, read_len))] = "N"
    cigar = [(read_len, "M")]
    if rng.random() < 0.15:
        k = int(rng.integers(5, 18))
        tail = (list(ADAPTER[:k]) if rng.random() < 0.5
                else list(_rand_seq(rng, k)))
        seq[read_len - k:] = tail
        cigar = [(read_len - k, "M"), (k, "S")]
    out = dict(rd)
    out["seq"] = "".join(seq)
    out["quals"] = quals
    out["cigar"] = cigar
    out["mapq"] = 60 if rng.random() > 0.05 else int(rng.choice([20, 30, 40]))
    return out


def _messy_pair(rng, rd1: dict, rd2: dict, read_len: int) -> List[dict]:
    """Apply real-data artifacts to a proper pair; occasionally emit a PCR
    duplicate of the whole pair."""
    a = _messy_mate(rng, rd1, read_len)
    b = _messy_mate(rng, rd2, read_len)
    recs = [a, b]
    if rng.random() < 0.05:
        da, db = dict(a), dict(b)
        da["name"] = a["name"] + "dup"
        db["name"] = b["name"] + "dup"
        recs += [da, db]
    return recs


def simulate_locus(seed: int = 0, n_samples: int = 4, reads_per_sample: int = 25,
                   period: int = 3, ref_units: int = 8, read_len: int = 70,
                   flank_len: int = 300, error_rate: float = 0.002,
                   stutter: Optional[StutterModel] = None,
                   allele_units: Optional[List[int]] = None,
                   qual_char: str = "I", chrom: str = "chrSim",
                   paired: bool = False,
                   phased_snp_offset: Optional[int] = None,
                   haploid: bool = False,
                   sample_names: Optional[List[str]] = None,
                   realism: bool = False) -> SimulatedLocus:
    rng = np.random.default_rng(seed)
    if stutter is None:
        stutter = StutterModel(0.9, 0.05, 0.08, 0.9, 0.01, 0.01, period)
    motif = _rand_seq(rng, period)
    # avoid accidental homopolymer motifs for multi-base periods (period-1
    # loci are homopolymers by definition and exercise that code path)
    while period > 1 and len(set(motif)) == 1:
        motif = _rand_seq(rng, period)
    if allele_units is None:
        allele_units = [ref_units - 2, ref_units - 1, ref_units, ref_units + 1]
    lflank = _rand_seq(rng, flank_len)
    rflank = _rand_seq(rng, flank_len)
    ref_str = motif * ref_units
    chrom_seq = lflank + ref_str + rflank
    region = Region(chrom, flank_len, flank_len + len(ref_str), period, "SIM1")

    locus = SimulatedLocus(chrom, chrom_seq, region, motif, ref_units,
                           list(allele_units), [])
    freqs = np.ones(len(allele_units)) / len(allele_units)

    # optional phased het SNP in the left flank: haplotype 1 carries the
    # reference base, haplotype 2 an alternate
    snp_pos = None
    snp_ref = snp_alt = None
    if phased_snp_offset is not None:
        snp_pos = region.start - phased_snp_offset
        snp_ref = chrom_seq[snp_pos]
        snp_alt = rng.choice([b for b in BASES if b != snp_ref])
        locus.snp = dict(pos=snp_pos, ref=snp_ref, alt=snp_alt)

    for s in range(n_samples):
        name = (sample_names[s] if sample_names is not None
                else f"SAMPLE{s:03d}")
        locus.sample_names.append(name)
        a1, a2 = rng.choice(allele_units, size=2, p=freqs)
        if haploid:
            a2 = a1
        locus.true_genotypes.append((int(a1), int(a2)))
        p1s, p2s = [], []
        sample_alns: List[Alignment] = []
        for r in range(reads_per_sample):
            from_hap_one = rng.random() < 0.5
            units = int(a1 if from_hap_one else a2)
            allele_seq = lflank + motif * units + rflank
            if snp_pos is not None and not from_hap_one:
                allele_seq = (allele_seq[:snp_pos] + snp_alt
                              + allele_seq[snp_pos + 1:])
            str_start = flank_len
            str_len = period * units
            d = _sample_stutter(rng, stutter)
            if d > 0:
                pos = int(rng.integers(0, str_len + 1))
                ins = (motif * ((d // period) + 2))[:d]
                hap_seq = (allele_seq[:str_start + pos] + ins
                           + allele_seq[str_start + pos:])
            elif d < 0 and str_len + d >= 0:
                pos = int(rng.integers(0, str_len + d + 1))
                hap_seq = (allele_seq[:str_start + pos]
                           + allele_seq[str_start + pos - d:])
            else:
                hap_seq = allele_seq

            # place the read to span the STR with margin
            str_end_in_hap = str_start + str_len + d
            lo = max(0, str_start - (read_len - (str_len + d) - 12))
            hi = max(lo + 1, str_start - 12)
            start_in_hap = int(rng.integers(lo, hi))
            if start_in_hap + read_len > len(hap_seq):
                start_in_hap = len(hap_seq) - read_len
            read = list(hap_seq[start_in_hap:start_in_hap + read_len])
            for i in range(len(read)):
                if rng.random() < error_rate:
                    read[i] = rng.choice([b for b in BASES if b != read[i]])
            read_seq = "".join(read)
            quals = qual_char * read_len

            # approximate original mapping position (true placement)
            map_start = start_in_hap
            map_end = map_start + read_len  # exclusive; indels shift ignored
            aln = realign(map_start, map_end, f"{name}_read{r}", read_seq,
                          quals, bool(rng.random() < 0.5), chrom_seq)
            if aln is None:
                continue
            aln.use_for_haps = [True]
            sample_alns.append(aln)
            p1s.append(math.log(0.5))
            p2s.append(math.log(0.5))
            if paired and map_start - 30 - read_len >= 0:
                # mate in the left flank (identical between haplotype and
                # chromosome, so its mapping is exact); FR orientation with
                # the mate upstream of the STR read
                gap = int(rng.integers(20, 60))
                mate_start = map_start - gap - read_len
                mate_seq = chrom_seq[mate_start:mate_start + read_len]
                str_rev = bool(aln.rev_strand)
                tlen = map_start + read_len - mate_start
                rd1 = dict(
                    name=f"{name}_read{r}", sample=name, seq=read_seq,
                    quals=quals, start=map_start, rev=str_rev,
                    hap=1 if from_hap_one else 2,
                    flag=(0x1 | 0x2 | 0x40 | (0x10 if str_rev else 0)
                          | (0x20 if not str_rev else 0)),
                    mate_pos=mate_start, tlen=-tlen)
                rd2 = dict(
                    name=f"{name}_read{r}", sample=name, seq=mate_seq,
                    quals=qual_char * read_len, start=mate_start,
                    rev=not str_rev, hap=1 if from_hap_one else 2,
                    flag=(0x1 | 0x2 | 0x80 | (0x10 if not str_rev else 0)
                          | (0x20 if str_rev else 0)),
                    mate_pos=map_start, tlen=tlen)
                if realism:
                    locus.raw_reads.extend(
                        _messy_pair(rng, rd1, rd2, read_len))
                else:
                    locus.raw_reads.append(rd1)
                    locus.raw_reads.append(rd2)
            else:
                rd = dict(
                    name=f"{name}_read{r}", sample=name, seq=read_seq,
                    quals=quals, start=map_start, rev=aln.rev_strand,
                    hap=1 if from_hap_one else 2)
                if realism:
                    locus.raw_reads.extend(
                        _messy_record(rng, rd, read_len, chrom))
                else:
                    locus.raw_reads.append(rd)
        # reads must be grouped per sample, ordered consistently
        locus.alns.extend(sorted(sample_alns, key=lambda a: a.name))
        locus.log_p1.append(p1s)
        locus.log_p2.append(p2s)
    return locus


def write_phased_snp_vcf(locus: SimulatedLocus, path: str) -> None:
    """Write a phased biallelic-SNP VCF for a simulated locus (every sample
    heterozygous ref|alt at the simulated SNP)."""
    assert getattr(locus, "snp", None) is not None
    snp = locus.snp
    lines = ["##fileformat=VCFv4.1",
             f"##contig=<ID={locus.chrom},length={len(locus.chrom_seq)}>",
             '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
             + "\t".join(locus.sample_names)]
    gt = "\t".join("0|1" for _ in locus.sample_names)
    lines.append(f"{locus.chrom}\t{snp['pos'] + 1}\t.\t{snp['ref']}\t"
                 f"{snp['alt']}\t.\t.\t.\tGT\t{gt}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
