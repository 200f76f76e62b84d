"""Copy of hipstr_tpu/denovo/scanner.py; the batched jobs run on the
scanner's torch device.

De novo mutation scanners over HipSTR-style STR VCFs.

Capability parity with the reference DenovoScanner / TrioDenovoScanner
(reference: src/denovos/denovo_scanner.{h,cpp},
src/denovos/trio_denovo_scanner.{h,cpp}): per STR record, compute
log10-likelihoods of no-mutation vs one-de-novo vs one-transmitted-allele
mutation per child, using phased GLs + SNP-inferred transmission (family
scan) or unphased GLs (trio scan), and emit a per-family VCF.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Set

import numpy as np

from ..io.vcf_read import VCFReader, VcfVariant
from ..phasing.haplotype_tracker import HaplotypeTracker
from ..phasing.pedigree import NuclearFamily
from .likelihoods import (expand_phased_gls, expand_unphased_gls,
                          phased_family_lls, population_log10_freqs,
                          trio_unphased_lls, uniform_log10_freqs)

MAX_BEST_SCORE = 10
MIN_SECOND_BEST_SCORE = 100
WINDOW_SIZE = 500000


def _fmt(x: float) -> str:
    return f"{x:.2f}"


def _log10_mut_prior(num_alleles: int) -> float:
    import math
    return -math.log10(2) - math.log10(num_alleles - 1)


_LOG_THRESH = -6.907755278982137  # ln(0.001), reference mathops.h:36


def _ref_flse_vec(vals) -> float:
    """Reference fast_log_sum_exp over a vector (mathops.cpp:97-106):
    natural exp/log on the (log10-space) scenario values, dropping terms
    more than ln(1000) below the max."""
    import math
    m = max(float(v) for v in vals)
    total = 0.0
    for v in vals:
        d = float(v) - m
        if d > _LOG_THRESH:
            total += math.exp(d)
    return m + math.log(total)


def _ref_flse2(a: float, b: float) -> float:
    """Reference pairwise fast_log_sum_exp (mathops.cpp:86-95)."""
    import math
    hi, lo = (a, b) if a > b else (b, a)
    d = lo - hi
    return hi if d < _LOG_THRESH else hi + math.log(1.0 + math.exp(d))


def _check_device(device, device_batch: int) -> None:
    if device_batch and device is None:
        raise ValueError("device_batch > 0 needs the scanner's device")


def _founder_gts(variant: VcfVariant, families: List[NuclearFamily]):
    out = []
    for fam in families:
        for s in (fam.mother, fam.father):
            gt = variant.genotype(s)
            if gt is not None:
                out.append((gt[0], gt[1]))
    return out


def _info_line(variant: VcfVariant) -> str:
    start = variant.info.get("START", "")
    end = variant.info.get("END", "")
    period = variant.info.get("PERIOD", "")
    bp = variant.info.get("BPDIFFS", "")
    return f"BPDIFFS={bp};START={start};END={end};PERIOD={period}"


class DenovoScanner:
    """Family scan with phased GLs + SNP-haplotype transmission."""

    def __init__(self, families: List[NuclearFamily], out_stream,
                 use_pop_priors: bool = False, device=None):
        self.families = families
        self.out = out_stream
        self.use_pop_priors = use_pop_priors
        self.device = device     # torch device of the batched jobs

    def write_vcf_header(self, full_command: str) -> None:
        o = self.out
        o.write("##fileformat=VCFv4.1\n")
        o.write(f"##command={full_command}\n")
        o.write('##INFO=<ID=BPDIFFS,Number=A,Type=Integer,Description="Base pair difference of each alternate allele from the reference allele">\n')
        o.write('##INFO=<ID=START,Number=1,Type=Integer,Description="Inclusive start coodinate for the repetitive portion of the reference allele">\n')
        o.write('##INFO=<ID=END,Number=1,Type=Integer,Description="Inclusive end coordinate for the repetitive portion of the reference allele">\n')
        o.write('##INFO=<ID=PERIOD,Number=1,Type=Integer,Description="Length of STR motif">\n')
        o.write('##FORMAT=<ID=CHILDREN,Number=.,Type=String,Description="Ordered list of children in family that were tested for mutations. Specifies order of values for AFF, DENOVO and OTHER FORMAT fields">\n')
        o.write('##FORMAT=<ID=NOMUT,Number=1,Type=Float,Description="Log10-likelihood that no mutations occurred in any of the family members">\n')
        o.write('##FORMAT=<ID=ANYMUT,Number=1,Type=Float,Description="Log10-likelihood that a mutation occurred in any of the family members">\n')
        o.write('##FORMAT=<ID=DENOVO,Number=.,Type=Float,Description="Log10-likelihood that a single de novo mutation occurred in the family, and it occurred in the current child">\n')
        o.write('##FORMAT=<ID=OTHER,Number=.,Type=Float,Description="Log10-likelihood that a single mutation occurred in the family, and it occurred in the current child. In contrast to DENOVO, the mutated allele is also present in a parental genotype">\n')
        o.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT")
        for fam in self.families:
            o.write("\t" + fam.family_id)
        o.write("\n")

    def scan(self, snp_vcf: VCFReader, str_vcf: VCFReader,
             sites_to_skip: Optional[Set[str]] = None, logger=None,
             device_batch: int = 0) -> None:
        """device_batch > 0 stages (record, family) jobs and evaluates them
        on the scanner's device in batches grouped by (allele bucket,
        transmission pattern) — see likelihoods.phased_family_lls_batched;
        0 keeps the per-family host evaluation."""
        _check_device(self.device, device_batch)
        tracker = HaplotypeTracker(self.families, snp_vcf, WINDOW_SIZE)
        from .likelihoods import (bucket_alleles, pad_freqs, pad_gl,
                                  phased_family_lls_batched)
        pending: List[List] = []     # [prefix, cols]
        jobs: List[tuple] = []

        def fam_col(fam, nomut, denovo, other) -> str:
            # reference: fast_log_sum_exp(flse(denovo), flse(other))
            # (denovo_scanner.cpp:97) — hybrid natural-log aggregation
            anymut = _ref_flse2(_ref_flse_vec(denovo), _ref_flse_vec(other))
            return ":".join([
                ",".join(fam.children),
                _fmt(float(nomut)), _fmt(anymut),
                ",".join(_fmt(float(x)) for x in denovo),
                ",".join(_fmt(float(x)) for x in other)])

        def flush():
            groups = {}
            for j in jobs:
                groups.setdefault((j[2], j[7], j[8], len(j[6])), []).append(j)
            for (Ap, mat, pat, C), js in groups.items():
                gms = np.stack([pad_gl(j[4], Ap) for j in js])
                gfs = np.stack([pad_gl(j[5], Ap) for j in js])
                gcs = np.stack([[pad_gl(g, Ap) for g in j[6]] for j in js])
                fr = np.stack([pad_freqs(j[9], Ap) for j in js])
                mp = np.asarray([j[10] for j in js])
                nomut, denovo, other = phased_family_lls_batched(
                    gms, gfs, gcs, mat, pat, fr, mp, self.device)
                for i, j in enumerate(js):
                    pending[j[0]][1][j[1]] = fam_col(
                        j[3], nomut[i], denovo[i], other[i])
            jobs.clear()
            for prefix, cols in pending:
                self.out.write(prefix + "\t".join(cols) + "\n")
            pending.clear()

        for variant in str_vcf:
            A = variant.num_alleles()
            if A <= 1:
                continue
            gls = variant.gl_matrix("PHASEDGL")
            if not gls:
                continue
            tracker.advance(variant.chrom, variant.pos + 1,
                            sites_to_skip or set())

            if self.use_pop_priors:
                freqs = population_log10_freqs(
                    A, _founder_gts(variant, self.families))
            else:
                freqs = uniform_log10_freqs(A)
            mut_prior = _log10_mut_prior(A)

            cols = []
            rec_i = len(pending)
            for fam in self.families:
                ok, mat_idx, pat_idx, _ = tracker.infer_haplotype_inheritance(
                    fam, MAX_BEST_SCORE, MIN_SECOND_BEST_SCORE)
                ok &= all(s in gls for s in fam.get_samples())
                if not ok:
                    cols.append(".")
                    continue
                gm = expand_phased_gls(gls[fam.mother], A)
                gf = expand_phased_gls(gls[fam.father], A)
                gcs = [expand_phased_gls(gls[c], A) for c in fam.children]
                if device_batch:
                    jobs.append((rec_i, len(cols), bucket_alleles(A), fam,
                                 gm, gf, gcs, tuple(mat_idx), tuple(pat_idx),
                                 freqs, mut_prior))
                    cols.append("")
                    continue
                nomut, denovo, other = phased_family_lls(
                    np, gm, gf, gcs, mat_idx, pat_idx, freqs, mut_prior)
                cols.append(fam_col(fam, nomut, denovo, other))

            alt = ",".join(variant.alleles[1:]) if A > 1 else "."
            prefix = (f"{variant.chrom}\t{variant.pos + 1}\t{variant.vid}\t"
                      f"{variant.alleles[0]}\t{alt}\t.\t.\t"
                      f"{_info_line(variant)}\t"
                      "CHILDREN:NOMUT:ANYMUT:DENOVO:OTHER\t")
            if device_batch:
                pending.append([prefix, cols])
                if len(jobs) >= device_batch:
                    flush()
            else:
                self.out.write(prefix + "\t".join(cols) + "\n")
        if device_batch:
            flush()


class TrioDenovoScanner:
    """Trio scan with unphased GLs (reference: trio_denovo_scanner.cpp)."""

    def __init__(self, families: List[NuclearFamily], out_stream,
                 use_pop_priors: bool = False, device=None):
        self.families = families
        self.out = out_stream
        self.use_pop_priors = use_pop_priors
        self.device = device     # torch device of the batched jobs

    def write_vcf_header(self, full_command: str) -> None:
        o = self.out
        o.write("##fileformat=VCFv4.1\n")
        o.write(f"##command={full_command}\n")
        o.write('##INFO=<ID=BPDIFFS,Number=A,Type=Integer,Description="Base pair difference of each alternate allele from the reference allele">\n')
        o.write('##INFO=<ID=START,Number=1,Type=Integer,Description="Inclusive start coodinate for the repetitive portion of the reference allele">\n')
        o.write('##INFO=<ID=END,Number=1,Type=Integer,Description="Inclusive end coordinate for the repetitive portion of the reference allele">\n')
        o.write('##INFO=<ID=PERIOD,Number=1,Type=Integer,Description="Length of STR motif">\n')
        o.write('##FORMAT=<ID=NOMUT,Number=1,Type=Float,Description="Log10-likelihood that no mutations occurred in any of the family members">\n')
        o.write('##FORMAT=<ID=DENOVO,Number=.,Type=Float,Description="Log10-likelihood that a single de novo mutation occurred in the child">\n')
        o.write('##FORMAT=<ID=OTHER,Number=.,Type=Float,Description="Log10-likelihood that a single mutation occurred in the child and the mutated allele is also present in a parental genotype">\n')
        o.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT")
        for fam in self.families:
            for child in fam.children:
                o.write("\t" + child)
        o.write("\n")

    def scan(self, str_vcf: VCFReader, logger=None,
             device_batch: int = 0) -> None:
        """device_batch > 0 stages (record, trio) jobs for batches on the
        scanner's device grouped by allele bucket (see
        likelihoods.trio_unphased_lls_batched); 0 = host per-trio path."""
        _check_device(self.device, device_batch)
        from .likelihoods import (bucket_alleles, pad_freqs, pad_gl,
                                  trio_unphased_lls_batched)
        pending: List[List] = []
        jobs: List[tuple] = []

        def flush():
            groups = {}
            for j in jobs:
                groups.setdefault(j[2], []).append(j)
            for Ap, js in groups.items():
                gms = np.stack([pad_gl(j[3], Ap) for j in js])
                gfs = np.stack([pad_gl(j[4], Ap) for j in js])
                gcs = np.stack([pad_gl(j[5], Ap) for j in js])
                fr = np.stack([pad_freqs(j[6], Ap) for j in js])
                mp = np.asarray([j[7] for j in js])
                nomut, denovo, other = trio_unphased_lls_batched(
                    gms, gfs, gcs, fr, mp, self.device)
                for i, j in enumerate(js):
                    pending[j[0]][1][j[1]] = ":".join(
                        [_fmt(float(nomut[i])), _fmt(float(denovo[i])),
                         _fmt(float(other[i]))])
            jobs.clear()
            for prefix, cols in pending:
                self.out.write(prefix + "\t".join(cols) + "\n")
            pending.clear()

        for variant in str_vcf:
            A = variant.num_alleles()
            if A <= 1:
                continue
            gls = variant.gl_matrix("GL")
            if not gls:
                continue
            if self.use_pop_priors:
                freqs = population_log10_freqs(
                    A, _founder_gts(variant, self.families))
            else:
                freqs = uniform_log10_freqs(A)
            mut_prior = _log10_mut_prior(A)

            cols = []
            rec_i = len(pending)
            for fam in self.families:
                have_parents = fam.mother in gls and fam.father in gls
                for child in fam.children:
                    if not have_parents or child not in gls:
                        cols.append(".")
                        continue
                    gm = expand_unphased_gls(gls[fam.mother], A)
                    gf = expand_unphased_gls(gls[fam.father], A)
                    gc = expand_unphased_gls(gls[child], A)
                    if device_batch:
                        jobs.append((rec_i, len(cols), bucket_alleles(A),
                                     gm, gf, gc, freqs, mut_prior))
                        cols.append("")
                        continue
                    nomut, denovo, other = trio_unphased_lls(
                        np, gm, gf, gc, freqs, mut_prior)
                    cols.append(":".join([_fmt(float(nomut)),
                                          _fmt(float(denovo)),
                                          _fmt(float(other))]))

            alt = ",".join(variant.alleles[1:]) if A > 1 else "."
            prefix = (f"{variant.chrom}\t{variant.pos + 1}\t{variant.vid}\t"
                      f"{variant.alleles[0]}\t{alt}\t.\t.\t"
                      f"{_info_line(variant)}\tNOMUT:DENOVO:OTHER\t")
            if device_batch:
                pending.append([prefix, cols])
                if len(jobs) >= device_batch:
                    flush()
            else:
                self.out.write(prefix + "\t".join(cols) + "\n")
        if device_batch:
            flush()
