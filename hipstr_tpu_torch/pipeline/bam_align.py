"""Copy of hipstr_tpu/pipeline/bam_align.py.

Mutable alignment wrapper with the trimming/filter operations the region
pipeline applies to raw BAM records.

Capability parity with the reference BamAlignment helpers (reference:
src/bam_io.{h,cpp}: TrimAlignment/TrimLowQualityEnds at bam_io.cpp, filter
predicates in src/alignment_filters.cpp, Z-algorithm scans in
src/zalgorithm.cpp).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..io.bam import BamRecord


class BamAlign:
    """One read undergoing pipeline trimming; wraps an immutable BamRecord."""

    def __init__(self, rec: BamRecord, filename: str, ref_name: str):
        self.rec = rec
        self.filename = filename
        self.ref_name = ref_name
        self.name = rec.name
        self.pos = rec.pos
        self.cigar: List[Tuple[int, str]] = list(rec.cigar)
        self.bases = rec.seq
        self.quals = rec.qual
        self.end_pos = rec.end_position()  # exclusive

    # ---- basic props ---------------------------------------------------------
    @property
    def length(self) -> int:
        return len(self.bases)

    def starts_with_hard_clip(self) -> bool:
        return bool(self.cigar) and self.cigar[0][1] == "H"

    def ends_with_hard_clip(self) -> bool:
        return bool(self.cigar) and self.cigar[-1][1] == "H"

    def matches_reference(self) -> bool:
        return all(op in "M=" for _, op in self.cigar)

    def get_tag(self, tag: str):
        t = self.rec.tags.get(tag)
        return None if t is None else t[1]

    def to_record(self, extra_tags: Optional[dict] = None) -> BamRecord:
        """Current (possibly trimmed) state as a writable BAM record, with
        optional extra string tags (reference: BamProcessor
        add_passes_filters_tag / write_filtered_alignment,
        bam_processor.cpp:21-58 — PF/FT tags on --pass-bam/--filt-bam output)."""
        tags = dict(self.rec.tags)
        for k, v in (extra_tags or {}).items():
            tags[k] = ("Z", v)
        r = self.rec
        return BamRecord(name=self.name, flag=r.flag, ref_id=r.ref_id,
                         pos=self.pos, mapq=r.mapq, cigar=list(self.cigar),
                         mate_ref_id=r.mate_ref_id, mate_pos=r.mate_pos,
                         tlen=r.tlen, seq=self.bases, qual=self.quals,
                         tags=tags)

    # ---- trimming ------------------------------------------------------------
    def trim_alignment(self, min_read_start: int, max_read_stop: int,
                       min_base_qual: str = "~") -> None:
        """Reference: BamAlignment::TrimAlignment (bam_io.cpp)."""
        ltrim = 0
        start_pos = self.pos
        while start_pos < min_read_start and self.cigar:
            n, op = self.cigar[0]
            if op in "M=XIS" and self.quals[ltrim] > min_base_qual:
                break
            if op in "M=X":
                ltrim += 1
                start_pos += 1
            elif op == "D":
                start_pos += 1
            elif op in "IS":
                ltrim += 1
            elif op == "H":
                pass
            else:
                raise AssertionError("bad CIGAR in trim_alignment")
            if n == 1:
                self.cigar.pop(0)
            else:
                self.cigar[0] = (n - 1, op)

        rtrim = 0
        qlast = len(self.quals) - 1
        end_pos = self.end_pos
        while end_pos > max_read_stop and self.cigar:
            n, op = self.cigar[-1]
            if op in "M=XIS" and self.quals[qlast - rtrim] > min_base_qual:
                break
            if op in "M=X":
                rtrim += 1
                end_pos -= 1
            elif op == "D":
                end_pos -= 1
            elif op in "IS":
                rtrim += 1
            elif op == "H":
                pass
            else:
                raise AssertionError("bad CIGAR in trim_alignment")
            if n == 1:
                self.cigar.pop()
            else:
                self.cigar[-1] = (n - 1, op)

        self.pos = start_pos
        self.end_pos = end_pos
        self.bases = self.bases[ltrim:len(self.bases) - rtrim]
        self.quals = self.quals[ltrim:len(self.quals) - rtrim]

    def trim_low_quality_ends(self, min_base_qual: str) -> None:
        self.trim_alignment(2 ** 31 - 1, -2 ** 31, min_base_qual)

    # ---- filter predicates ---------------------------------------------------
    def end_dist_to_indel(self) -> Tuple[int, int]:
        """Reference: AlignmentFilters::GetEndDistToIndel."""

        def walk(cigar):
            i = 0
            if i < len(cigar) and cigar[i][1] == "H":
                i += 1
            if i < len(cigar) and cigar[i][1] == "S":
                i += 1
            dist = 0
            while i < len(cigar):
                n, op = cigar[i]
                if op in "M=X":
                    dist += n
                elif op in "ID":
                    return dist
                elif op in "SH":
                    return -1
                else:
                    raise AssertionError("bad CIGAR")
                i += 1
            return -1

        return walk(self.cigar), walk(self.cigar[::-1])

    def num_end_matches(self, ref_seq: str, ref_start: int) -> Tuple[int, int]:
        """Reference: AlignmentFilters::GetNumEndMatches."""
        if self.pos < ref_start:
            return (-1, -1)
        read_index = 0
        ref_index = self.pos - ref_start
        ci = 0
        cigar = self.cigar
        beginning = True
        match_run = 0
        head_match = 0
        if ci < len(cigar) and cigar[ci][1] == "H":
            ci += 1
        if ci < len(cigar) and cigar[ci][1] == "S":
            read_index += cigar[ci][0]
            ci += 1
        while ci < len(cigar) and ref_index < len(ref_seq) and \
                read_index < len(self.bases):
            n, op = cigar[ci]
            if op in "M=X":
                if ref_index + n > len(ref_seq):
                    return (-1, -1)
                for _ in range(n):
                    if ref_seq[ref_index].lower() == self.bases[read_index].lower():
                        match_run += 1
                    else:
                        if beginning:
                            head_match = match_run
                        beginning = False
                        match_run = 0
                    read_index += 1
                    ref_index += 1
            elif op == "I":
                if beginning:
                    head_match = match_run
                beginning = False
                match_run = 0
                read_index += n
            elif op == "D":
                if beginning:
                    head_match = match_run
                beginning = False
                match_run = 0
                ref_index += n
            elif op in "SH":
                break
            else:
                raise AssertionError("bad CIGAR")
            ci += 1
        if ci < len(cigar) and cigar[ci][1] == "S":
            read_index += cigar[ci][0]
            ci += 1
        if ci < len(cigar) and cigar[ci][1] == "H":
            ci += 1
        if ci != len(cigar):
            if ref_index >= len(ref_seq):
                return (-1, -1)
            raise AssertionError("improper CIGAR")
        if read_index != len(self.bases):
            if ref_index >= len(ref_seq):
                return (-1, -1)
            raise AssertionError("CIGAR/base mismatch")
        if beginning:
            return (match_run, match_run)
        return (head_match, match_run)

    def _unclipped_info(self) -> Tuple[str, int, int]:
        start = self.pos
        end = self.pos - 1
        begin = True
        start_index = 0
        num_bases = 0
        for n, op in self.cigar:
            if op == "D":
                end += n
                begin = False
            elif op == "H":
                pass
            elif op == "S":
                if begin:
                    start_index += n
            elif op in "M=X":
                end += n
                num_bases += n
                begin = False
            elif op == "I":
                num_bases += n
                begin = False
            else:
                raise AssertionError("bad CIGAR")
        return self.bases[start_index:start_index + num_bases], start, end

    def has_largest_end_matches(self, ref_seq: str, ref_start: int,
                                max_external: int, max_internal: int) -> bool:
        """Reference: AlignmentFilters::HasLargestEndMatches.

        Works on a bounded, lowercased window of the reference (lowercasing
        the whole chromosome per read is quadratic on real genomes)."""
        from ..native import end_match_counts_native
        bases, start, end = self._unclipped_info()
        lb = bases.lower()
        L = len(lb)

        def scan(lo, hi, suffix):
            # the match can reach at most L characters beyond the window
            wlo = max(0, lo - L) if suffix else lo
            whi = hi if suffix else min(len(ref_seq) - 1, hi + L)
            seg = ref_seq[wlo:whi + 1].lower()
            res = end_match_counts_native(lb, seg, lo - wlo, hi - wlo, suffix)
            if res is not None:
                return res
            return (_suffix_match_counts if suffix
                    else _prefix_match_counts)(lb, seg, lo - wlo, hi - wlo)

        if start >= ref_start and start < ref_start + len(ref_seq):
            start_index = start - ref_start
            lo = max(0, start_index - max_external)
            hi = min(len(ref_seq) - 1, start_index + max_internal)
            counts = scan(lo, hi, suffix=False)
            align_index = start_index - lo
            num = counts[align_index]
            for i, c in enumerate(counts):
                if i != align_index and c >= num:
                    return False
        if end >= ref_start and end < ref_start + len(ref_seq):
            end_index = end - ref_start
            lo = max(0, end_index - max_internal)
            hi = min(len(ref_seq) - 1, end_index + max_external)
            counts = scan(lo, hi, suffix=True)
            align_index = end_index - lo
            num = counts[align_index]
            for i, c in enumerate(counts):
                if i != align_index and c >= num:
                    return False
        return True


def _prefix_match_counts(s1: str, s2: str, lo: int, hi: int) -> List[int]:
    """count[i-lo] = length of the common prefix of s1 and s2[i:]."""
    out = []
    for i in range(lo, hi + 1):
        a = 0
        while a < len(s1) and i + a < len(s2) and s1[a] == s2[i + a]:
            a += 1
        out.append(a)
    return out


def _suffix_match_counts(s1: str, s2: str, lo: int, hi: int) -> List[int]:
    """count[i-lo] = length of the common suffix of s1 and s2[:i+1]."""
    out = []
    for i in range(lo, hi + 1):
        a = 0
        while a < len(s1) and i - a >= 0 and s1[len(s1) - 1 - a] == s2[i - a]:
            a += 1
        out.append(a)
    return out
