"""Copy of hipstr_tpu/pipeline/adapter_trimmer.py.

Adapter trimming for reads overlapping STR regions.

Capability parity with the reference AdapterTrimmer (reference:
src/adapter_trimmer.{h,cpp}): TruSeq + Nextera adapter prefixes, at most one
mismatch per overlap (error rate < 0.15), minimum 5 bp overlap,
overhang-aware matching at both read ends, R1/R2 + strand-aware adapter
choice, and per-locus trimming statistics.
"""

from __future__ import annotations

from typing import List

from .bam_align import BamAlign

MIN_OVERLAP = 5
MAX_ERROR_RATE = 0.15

TRUSEQ_R1 = "AGATCGGAAGAGCAC"
TRUSEQ_R2 = "AGATCGGAAGAGCGT"
NEXTERA_R1 = "CTGTCTCTTATACAC"
NEXTERA_R2 = "CTGTCTCTTATACAC"

_COMP = str.maketrans("ACGTacgt", "TGCATGCA")


def reverse_complement(seq: str) -> str:
    return seq.translate(_COMP)[::-1]


def _mismatches(a: str, b: str) -> int:
    # early exit at 2: callers only distinguish 0 / 1 / more
    mm = 0
    for x, y in zip(a, b):
        if x != y:
            mm += 1
            if mm > 1:
                return mm
    return mm


def _trim_three_prime_index(bases: str, adapters: List[str]) -> int:
    """Leftmost index whose suffix matches an adapter prefix with <=1
    mismatch (mismatch allowed only when overlap >= 1/MAX_ERROR_RATE).
    Returns read_length when nothing matches."""
    from ..native import adapter_trim_native
    idx = adapter_trim_native(bases, adapters, MIN_OVERLAP, MAX_ERROR_RATE,
                              five_prime=False)
    if idx is not None:
        return idx
    read_len = len(bases)
    trim_index = read_len
    for adapter in adapters:
        alen = len(adapter)
        for index in range(0, read_len - MIN_OVERLAP + 1):
            max_match = min(alen, read_len - index)
            mm = _mismatches(bases[index:index + max_match],
                             adapter[:max_match])
            if mm == 0 or (mm == 1 and 1.0 / max_match < MAX_ERROR_RATE):
                if index < trim_index:
                    trim_index = index
                break
    return trim_index


def _trim_five_prime_index(bases: str, adapters: List[str]) -> int:
    """Rightmost index whose prefix matches an adapter suffix with <=1
    mismatch.  Returns -1 when nothing matches."""
    from ..native import adapter_trim_native
    idx = adapter_trim_native(bases, adapters, MIN_OVERLAP, MAX_ERROR_RATE,
                              five_prime=True)
    if idx is not None:
        return idx
    read_len = len(bases)
    trim_index = -1
    for adapter in adapters:
        alen = len(adapter)
        for index in range(read_len - 1, MIN_OVERLAP - 2, -1):
            max_match = min(alen, index + 1)
            mm = _mismatches(bases[index - max_match + 1:index + 1],
                             adapter[alen - max_match:])
            if mm == 0 or (mm == 1 and 1.0 / max_match < MAX_ERROR_RATE):
                if index > trim_index:
                    trim_index = index
                break
    return trim_index


class AdapterTrimmer:
    def __init__(self, trim: bool = True):
        self.trim = trim
        self.r1_fw = [TRUSEQ_R1, NEXTERA_R1]
        self.r2_fw = [TRUSEQ_R2, NEXTERA_R2]
        self.r1_rc = [reverse_complement(a) for a in self.r1_fw]
        self.r2_rc = [reverse_complement(a) for a in self.r2_fw]
        self.r1_trimmed_bases = self.r2_trimmed_bases = 0
        self.r1_trimmed_reads = self.r2_trimmed_reads = 0
        self.r1_total_reads = self.r2_total_reads = 0

    def trim_adapters(self, aln: BamAlign) -> None:
        if not self.trim or aln.length == 0:
            return
        rec = aln.rec
        if rec.is_first_mate or not rec.is_paired:
            if rec.is_reverse:
                n = self._trim_five(aln, self.r1_rc)
            else:
                n = self._trim_three(aln, self.r1_fw)
            self.r1_trimmed_bases += n
            self.r1_trimmed_reads += 1 if n else 0
            self.r1_total_reads += 1
        elif rec.is_second_mate:
            if rec.is_reverse:
                n = self._trim_five(aln, self.r2_rc)
            else:
                n = self._trim_three(aln, self.r2_fw)
            self.r2_trimmed_bases += n
            self.r2_trimmed_reads += 1 if n else 0
            self.r2_total_reads += 1

    def _trim_three(self, aln: BamAlign, adapters: List[str]) -> int:
        idx = _trim_three_prime_index(aln.bases, adapters)
        n = len(aln.bases) - idx
        if n > 0:
            _trim_num_bases(aln, 0, n)
        return n

    def _trim_five(self, aln: BamAlign, adapters: List[str]) -> int:
        idx = _trim_five_prime_index(aln.bases, adapters)
        if idx >= 0:
            _trim_num_bases(aln, idx + 1, 0)
        return idx + 1

    def stats_msg(self) -> str:
        def pct(t, n):
            return 0 if n == 0 else 100.0 * t / n
        return (f"Adapter trimming removed\n"
                f"\t{self.r1_trimmed_bases} likely adapter bases from "
                f"{self.r1_trimmed_reads}/{self.r1_total_reads} R1 reads "
                f"({pct(self.r1_trimmed_reads, self.r1_total_reads):.2g}%)\n"
                f"\t{self.r2_trimmed_bases} likely adapter bases from "
                f"{self.r2_trimmed_reads}/{self.r2_total_reads} R2 reads "
                f"({pct(self.r2_trimmed_reads, self.r2_total_reads):.2g}%)")


def _trim_num_bases(aln: BamAlign, left: int, right: int) -> None:
    """Unconditionally trim `left`/`right` read bases, adjusting CIGAR and
    coordinates (reference: BamAlignment::TrimNumBases)."""
    # left trim
    n = left
    while n > 0 and aln.cigar:
        length, op = aln.cigar[0]
        if op in "M=XIS":
            take = min(n, length)
            if op in "M=X":
                aln.pos += take
            n -= take
            if take == length:
                aln.cigar.pop(0)
            else:
                aln.cigar[0] = (length - take, op)
        elif op == "D":
            aln.pos += length
            aln.cigar.pop(0)
        else:  # H
            aln.cigar.pop(0)
    n = right
    while n > 0 and aln.cigar:
        length, op = aln.cigar[-1]
        if op in "M=XIS":
            take = min(n, length)
            if op in "M=X":
                aln.end_pos -= take
            n -= take
            if take == length:
                aln.cigar.pop()
            else:
                aln.cigar[-1] = (length - take, op)
        elif op == "D":
            aln.end_pos -= length
            aln.cigar.pop()
        else:
            aln.cigar.pop()
    # drop leading/trailing deletions exposed by the trim
    while aln.cigar and aln.cigar[0][1] == "D":
        aln.pos += aln.cigar[0][0]
        aln.cigar.pop(0)
    while aln.cigar and aln.cigar[-1][1] == "D":
        aln.end_pos -= aln.cigar[-1][0]
        aln.cigar.pop()
    aln.bases = aln.bases[left:len(aln.bases) - right]
    aln.quals = aln.quals[left:len(aln.quals) - right]
