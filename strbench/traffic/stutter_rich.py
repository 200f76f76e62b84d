"""Reads whose CIGARs carry their stutter: a frozen copy of
hipstr_tpu_torch/utils/simdata.stutter_rich_loci and write_stutter_rich.

Locus i has repeat period 1 + (i % periods), a reference repeat of 8-10
units (6-7 at periods 5-6), random flanks, per sample two alleles drawn
from the allele range around the reference, per-locus stutter rates
(in-frame up and down, geometric unit counts; a small out-of-frame share of
+-1 bp from period 2), sequencing errors, and one I or D at the repeat's
start carrying each read's net length change, so that the stutter EM runs
its loop.  Every locus has a het SNP left of the repeat, haplotype 2
carrying the alternate base in every sample.  The random stream per locus
is `default_rng(base_seed + i)`, as the original's; the traffic file's
parameters default to the original's constants, with which the bytes
written equal write_stutter_rich's (strbench/tests).
"""

from __future__ import annotations

import numpy as np

from .writers import cigar_end, clean_draws, encode_read

DEFAULTS = dict(periods=6, flank=300, margin=12, allele_units=[-3, 3],
                in_frame=[0.02, 0.15], out_frame=[0.005, 0.02], geom_p=0.9,
                error_rate=0.002, snp_offset=20, qual="I")
SNP_VCF = "snps.vcf.gz"     # bgzipped and tabix-indexed


def _motif(rng, period: int) -> str:
    """A repeat unit of `period` bases that is no repeat of a shorter one."""
    while True:
        m = "".join(rng.choice(list("ACGT"), size=period))
        if not any(period % p == 0 and m == m[:p] * (period // p)
                   for p in range(1, period)):
            return m


def sample_names(n_samples: int):
    return [f"SAMPLE{s:03d}" for s in range(n_samples)]


def locus(i: int, base_seed: int, n_samples: int, reads_per_sample: int,
          read_len: int, chrom_prefix: str, params: dict) -> dict:
    """Locus i: its contig, BED line, SNP record, encoded reads in
    coordinate order and, per sample, every read's net length change (the
    truth the EM's inputs are checked against)."""
    p = dict(DEFAULTS, **params)
    flank, margin = p["flank"], p["margin"]
    names = sample_names(n_samples)
    rng = np.random.default_rng(base_seed + i)
    period = 1 + (i % p["periods"])
    ref_units = (8 + (i // 6) % 3) if period <= 4 else 6 + (i // 6) % 2
    lo_u, hi_u = p["allele_units"]
    if period * (ref_units + hi_u) > read_len - 2 * margin:
        raise ValueError(f"locus {i}: the longest allele does not fit a "
                         f"{read_len}-bp read")
    motif = _motif(rng, period)
    lflank = "".join(rng.choice(list("ACGT"), size=flank))
    rflank = "".join(rng.choice(list("ACGT"), size=flank))
    chrom = f"{chrom_prefix}{i}"
    chrom_seq = lflank + motif * ref_units + rflank
    start, stop = flank, flank + period * ref_units
    in_up, in_down = rng.uniform(*p["in_frame"], 2)
    out_up, out_down = ((0.0, 0.0) if period == 1
                        else rng.uniform(*p["out_frame"], 2))
    pos = flank - p["snp_offset"]
    snp_ref = chrom_seq[pos]
    snp_alt = str(rng.choice([b for b in "ACGT" if b != snp_ref]))
    reads, truth = [], {}
    for name in names:
        units = [ref_units + int(u) for u in rng.integers(lo_u, hi_u + 1, 2)]
        diffs = truth.setdefault(name, [])
        for r in range(reads_per_sample):
            hap = int(rng.integers(0, 2))
            u = rng.random()
            fits = (read_len - 2 * margin) // period - units[hap]
            if u < in_up:
                d = period * min(int(rng.geometric(p["geom_p"])), fits)
            elif u < in_up + in_down:
                d = -period * min(int(rng.geometric(p["geom_p"])), units[hap])
            elif u < in_up + in_down + out_up:
                d = 1
            elif u < in_up + in_down + out_up + out_down:
                d = -1
            else:
                d = 0
            rep = motif * units[hap]
            rep = ((motif * (d // period + 1))[:d] + rep if d > 0
                   else rep[-d:])
            left = lflank
            if hap == 1:
                left = lflank[:pos] + snp_alt + lflank[pos + 1:]
            hap_seq = left + rep + rflank
            rstart = int(rng.integers(flank - (read_len - len(rep) - margin),
                                      flank - margin + 1))
            seq = list(hap_seq[rstart:rstart + read_len])
            if not clean_draws(rng, read_len, p["error_rate"]):
                for k in range(read_len):
                    if rng.random() < p["error_rate"]:
                        seq[k] = str(rng.choice(
                            [b for b in "ACGT" if b != seq[k]]))
            a = flank - rstart
            net = len(rep) - period * ref_units
            if net > 0:
                cigar = [(a, "M"), (net, "I"), (read_len - a - net, "M")]
            elif net < 0:
                cigar = [(a, "M"), (-net, "D"), (read_len - a, "M")]
            else:
                cigar = [(read_len, "M")]
            diffs.append(net)
            rev = bool(rng.random() < 0.5)
            reads.append((rstart, f"{chrom}_{name}_read{r}", rev, cigar,
                          "".join(seq), name))
    reads.sort(key=lambda rd: rd[0])
    encoded = [(rs, cigar_end(rs, cg), encode_read(
        nm, 0x10 if rev else 0, i, rs, cg, seq, p["qual"] * read_len,
        f"rg{smp}")) for rs, nm, rev, cg, seq, smp in reads]
    gt = "\t".join("0|1" for _ in names)
    return dict(
        chrom=chrom, seq=chrom_seq, period=period,
        bed=(f"{chrom}\t{start + 1}\t{stop}\t{period}\t"
             f"{(stop - start) / period:.1f}\tSR{i}\n"),
        snp=f"{chrom}\t{pos + 1}\t.\t{snp_ref}\t{snp_alt}\t.\t.\t.\tGT\t{gt}",
        reads=encoded, truth=truth)
