"""Copy of hipstr_tpu/io/vcf_write.py.

Sorted VCF emission (plain or bgzipped).

Capability parity with the reference VCFWriter (reference:
src/vcf_writer.{h,cpp}): records may arrive slightly out of order (regions
overlapping within the 50 bp pad); a min-heap buffer re-sorts before writing,
and the header matches Genotyper::get_vcf_header (src/genotyper.cpp:253-333).
"""

from __future__ import annotations

import heapq
from typing import List, Optional

from .bgzf import BgzfWriter

MAX_SORTING_PAD = 50


def build_vcf_header(fasta_path: str, full_command: str,
                     contig_lines: List[str], sample_names: List[str],
                     cfg) -> str:
    out = ["##fileformat=VCFv4.1",
           f"##command={full_command}",
           f"##reference={fasta_path}"]
    out.extend(contig_lines)
    info = [
        ("INFRAME_PGEOM", "1", "Float", "Parameter for in-frame geometric step size distribution"),
        ("INFRAME_UP", "1", "Float", "Probability that stutter causes an in-frame increase in obs. STR size"),
        ("INFRAME_DOWN", "1", "Float", "Probability that stutter causes an in-frame decrease in obs. STR size"),
        ("OUTFRAME_PGEOM", "1", "Float", "Parameter for out-of-frame geometric step size distribution"),
        ("OUTFRAME_UP", "1", "Float", "Probability that stutter causes an out-of-frame increase in read's STR size"),
        ("OUTFRAME_DOWN", "1", "Float", "Probability that stutter causes an out-of-frame decrease in read's STR size"),
        ("BPDIFFS", "A", "Integer", "Base pair difference of each alternate allele from the reference allele"),
        ("START", "1", "Integer", "Inclusive start coodinate for the repetitive portion of the reference allele"),
        ("END", "1", "Integer", "Inclusive end coordinate for the repetitive portion of the reference allele"),
        ("PERIOD", "1", "Integer", "Length of STR motif"),
        ("AN", "1", "Integer", "Total number of alleles in called genotypes"),
        ("REFAC", "1", "Integer", "Reference allele count"),
        ("AC", "A", "Integer", "Alternate allele counts"),
        ("NSKIP", "1", "Integer", "Number of samples not genotyped due to various issues"),
        ("NFILT", "1", "Integer", "Number of samples whose genotypes were filtered due to various issues"),
        ("DP", "1", "Integer", "Total number of valid reads used to genotype all samples"),
        ("DSNP", "1", "Integer", "Total number of reads with SNP phasing information"),
        ("DSTUTTER", "1", "Integer", "Total number of reads with a stutter indel in the STR region"),
        ("DFLANKINDEL", "1", "Integer", "Total number of reads with an indel in the regions flanking the STR"),
    ]
    for ident, num, typ, desc in info:
        out.append(f'##INFO=<ID={ident},Number={num},Type={typ},Description="{desc}">')

    fmt = [
        ("GT", "1", "String", "Genotype"),
        ("GB", "1", "String", "Base pair differences of genotype from reference"),
        ("Q", "1", "Float", "Posterior probability of unphased genotype"),
        ("PQ", "1", "Float", "Posterior probability of phased genotype"),
        ("DP", "1", "Integer", "Number of valid reads used for sample's genotype"),
        ("DSNP", "1", "Integer", "Number of reads with SNP phasing information"),
        ("PSNP", "1", "String", "Number of reads with SNPs supporting each haploid genotype"),
        ("PDP", "1", "String", "Fractional reads supporting each haploid genotype"),
        ("GLDIFF", "1", "Float", "Difference in likelihood between the reported and next best genotypes"),
        ("DSTUTTER", "1", "Integer", "Number of reads with a stutter indel in the STR region"),
        ("DFLANKINDEL", "1", "Integer", "Number of reads with an indel in the regions flanking the STR"),
        ("AB", "1", "Float", "log10 of the allele bias pvalue, where 0 is no bias and more negative values are increasingly biased. For homozygous genotypes, this can be negative if the haplotypes are heterozygous"),
        ("FS", "1", "Float", "log10 of the strand bias pvalue from Fisher's exact test, where 0 is no bias and more negative values are increasingly biased. For homozygous genotypes, this can be negative if the haplotypes are heterozygous"),
        ("DAB", "1", "Integer", "Number of reads used in the AB and FS calculations"),
    ]
    if getattr(cfg, "output_haplotype_data", False):
        # reference: genotyper.cpp:282-308 (--output-hap-fields)
        out.append('##INFO=<ID=LFLANKS,Number=.,Type=String,Description="Comma-separated sequence(s) of flank to the  left of the repeat. Only output if 1 or more non-ref  left flanks were detected">')
        out.append('##INFO=<ID=RFLANKS,Number=.,Type=String,Description="Comma-separated sequence(s) of flank to the right of the repeat. Only output if 1 or more non-ref right flanks were detected">')
    for ident, num, typ, desc in fmt:
        out.append(f'##FORMAT=<ID={ident},Number={num},Type={typ},Description="{desc}">')
    if getattr(cfg, "output_haplotype_data", False):
        out.append('##FORMAT=<ID=HQ,Number=1,Type=Float,Description="Posterior probability of unphased haplotypes. Only output if 1 or more non-ref flanks were detected">')
        out.append('##FORMAT=<ID=PHQ,Number=1,Type=Float,Description="Posterior probability of   phased haplotypes. Only output if 1 or more non-ref flanks were detected">')
        out.append('##FORMAT=<ID=LFGT,Number=1,Type=String,Description="Genotype of  left flank with corresponding sequences reported in LFLANKS. Only output if 1 or more non-ref  left flanks were detected">')
        out.append('##FORMAT=<ID=RFGT,Number=1,Type=String,Description="Genotype of right flank with corresponding sequences reported in RFLANKS. Only output if 1 or more non-ref right flanks were detected">')
    if cfg.output_allreads:
        out.append('##FORMAT=<ID=ALLREADS,Number=1,Type=String,Description="Base pair difference observed in each read\'s Needleman-Wunsch alignment">')
    if cfg.output_mallreads:
        out.append('##FORMAT=<ID=MALLREADS,Number=1,Type=String,Description="Maximum likelihood bp diff in each read based on haplotype alignments for reads that span the repeat region by at least 5 base pairs">')
    if cfg.output_gls:
        out.append('##FORMAT=<ID=GL,Number=G,Type=Float,Description="log10 genotype likelihoods">')
    if cfg.output_pls:
        out.append('##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Phred-scaled genotype likelihoods">')
    if cfg.output_phased_gls:
        out.append('##FORMAT=<ID=PHASEDGL,Number=.,Type=Float,Description="log10 genotype likelihood for each phased genotype. Value for phased genotype X|Y is stored at a 0-based index of X*A + Y, where A is the number of alleles. Not applicable to haploid genotypes">')
    if cfg.output_filters:
        out.append('##FORMAT=<ID=FILTER,Number=1,Type=String,Description="Reason for filtering the current call, or PASS if the call was not filtered">')

    out.append("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
               + "\t".join(sample_names))
    return "\n".join(out) + "\n"


class VCFWriter:
    """Buffered sorted writer (reference: src/vcf_writer.h:25-83)."""

    def __init__(self, path: str, header: str, bgzip: Optional[bool] = None,
                 build_index: Optional[bool] = None):
        if bgzip is None:
            bgzip = path.endswith(".gz")
        self._bgzip = bgzip
        self._path = path
        if bgzip:
            self._w = BgzfWriter(path)
        else:
            self._w = open(path, "w")
        self._tbi = None
        if build_index is None:
            build_index = bgzip
        if bgzip and build_index:
            from .tabix import TabixBuilder
            self._tbi = TabixBuilder()
        self._write(header)
        self._heap: List = []
        self._chrom: Optional[str] = None
        self._count = 0

    def _write(self, text: str) -> None:
        if self._bgzip:
            if self._tbi is not None and text and not text.startswith("#"):
                cols = text.split("\t", 4)
                beg = int(cols[1]) - 1
                v_start = self._w.virtual_offset
                self._w.write(text.encode())
                self._tbi.add(cols[0], beg, beg + len(cols[3]),
                              v_start, self._w.virtual_offset)
                return
            self._w.write(text.encode())
        else:
            self._w.write(text)

    def add_vcf_record(self, chrom: str, pos: int, record_text: str) -> None:
        if self._chrom is not None and chrom != self._chrom:
            self._drain(None)
        self._chrom = chrom
        self._count += 1
        heapq.heappush(self._heap, (pos, self._count, record_text))
        self._drain(pos - MAX_SORTING_PAD)

    def _drain(self, up_to: Optional[int]) -> None:
        while self._heap and (up_to is None or self._heap[0][0] < up_to):
            _, _, text = heapq.heappop(self._heap)
            self._write(text + "\n")

    def close(self) -> None:
        self._drain(None)
        self._w.close()
        if self._tbi is not None and self._tbi.names:
            self._tbi.write(self._path + ".tbi")
