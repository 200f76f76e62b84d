"""Copy of hipstr_tpu/align/traceback.py.

Alignment traceback records and read->reference trace stitching.

Capability parity with the reference AlignmentTrace + stitch functions
(reference: src/SeqAlignment/AlignmentTraceback.{h,cpp}): per-read maximum-
likelihood alignment data (hap-alignment string, per-block stutter sizes and
STR sequences, flank sequences/indels/SNPs) and the merge of a read->haplotype
alignment with a haplotype->reference alignment into a read->reference
Alignment.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .alignment_data import Alignment, CigarElement, condense_cigar


class AlignmentTrace:
    """Reference: AlignmentTraceback.h:10-108."""

    def __init__(self, num_blocks: int):
        self.hap_aln = ""
        self.traced_aln: Optional[Alignment] = None
        self.flank_ins_size = 0
        self.flank_del_size = 0
        self._str_data: List[Optional[Tuple[int, str]]] = [None] * num_blocks
        self.flank_seqs: List[str] = [""] * num_blocks
        self.flank_indels: List[Tuple[int, int]] = []
        self.flank_snps: List[Tuple[int, str]] = []

    def add_flank_indel(self, indel: Tuple[int, int]) -> None:
        self.flank_indels.append(indel)

    def add_flank_snp(self, pos: int, base: str) -> None:
        self.flank_snps.append((pos, base))

    def inc_flank_ins(self) -> None:
        self.flank_ins_size += 1

    def inc_flank_del(self) -> None:
        self.flank_del_size += 1

    def add_flank_data(self, block_index: int, flank_seq: str) -> None:
        self.flank_seqs[block_index] += flank_seq

    def add_str_data(self, block_index: int, stutter_size: int, str_seq: str) -> None:
        assert self._str_data[block_index] is None
        self._str_data[block_index] = (stutter_size, str_seq)

    def has_stutter(self) -> bool:
        return any(d is not None and d[0] != 0 for d in self._str_data)

    def total_stutter_size(self) -> int:
        return sum(d[0] for d in self._str_data if d is not None)

    def stutter_size(self, block_index: int) -> int:
        assert self._str_data[block_index] is not None
        return self._str_data[block_index][0]

    def str_seq(self, block_index: int) -> str:
        assert self._str_data[block_index] is not None
        return self._str_data[block_index][1]

    def flank_seq(self, block_index: int) -> str:
        return self.flank_seqs[block_index]


def _stitch(hap_aln: str, read_aln: str, h_index: int, r_index: int,
            increment: int) -> str:
    """Merge op strings walking in one direction (reference:
    AlignmentTraceback.cpp:7-53)."""
    from ..native import stitch_ops_native
    res = stitch_ops_native(hap_aln, read_aln, h_index, r_index, increment)
    if res is not None:
        return res
    out = []
    while 0 <= r_index < len(read_aln):
        rc = read_aln[r_index]
        if rc == "S":
            out.append("S")
            r_index += increment
            continue
        assert 0 <= h_index < len(hap_aln)
        hc = hap_aln[h_index]
        if hc == "D":
            if rc == "I":
                out.append("M")
                r_index += increment
                h_index += increment
            else:
                out.append("D")
                h_index += increment
        elif rc == "I":
            out.append("I")
            r_index += increment
        elif rc == "D":
            if hc == "M":
                out.append("D")
            elif hc == "I":
                pass
            else:
                raise AssertionError("stitch: bad op pair")
            r_index += increment
            h_index += increment
        elif rc == "M":
            if hc not in "MI":
                raise AssertionError("stitch: bad op pair")
            out.append(hc)
            r_index += increment
            h_index += increment
        else:
            raise AssertionError("stitch: bad read op")
    return "".join(out)


def stitch_alignment_trace(hap_start: int, hap_aln_to_ref: str,
                           read_aln_to_hap: str, hap_index: int,
                           seed_base: int, orig_aln: Alignment,
                           try_native: bool = True) -> Alignment:
    """Read->haplotype + haplotype->reference => read->reference Alignment.

    Literal port of stitch_alignment_trace
    (reference: AlignmentTraceback.cpp:55-144).  An invalid op pairing
    raises AssertionError from the pure-Python path, matching the
    reference's assertion behavior; callers that already saw the native
    side reject the same job pass try_native=False to skip the retry.
    """
    # one-call native path: index walks, both stitches, soft-clip
    # conversion, CIGAR RLE and aligned-string assembly all in C
    from ..native import stitch_trace_native
    res = (stitch_trace_native(hap_aln_to_ref, read_aln_to_hap, hap_start,
                               hap_index, seed_base, orig_aln.sequence)
           if try_native else None)
    if res is not None:
        start, stop, cig_ops, cig_num, aligned = res
        new_aln = Alignment(start, stop, False, "TRACE",
                            orig_aln.base_qualities, orig_aln.sequence,
                            aligned)
        new_aln.cigar = [CigarElement(chr(op), int(n))
                         for op, n in zip(cig_ops, cig_num)]
        return new_aln

    hap_aln_index = 0
    seed_pos = hap_start
    hi = hap_index
    while hi > 0 and hap_aln_index < len(hap_aln_to_ref):
        c = hap_aln_to_ref[hap_aln_index]
        if c in "MI":
            hi -= 1
        if c in "MD":
            seed_pos += 1
        hap_aln_index += 1
    while (hap_aln_index < len(hap_aln_to_ref)
           and hap_aln_to_ref[hap_aln_index] == "D"):
        hap_aln_index += 1
    assert hap_aln_index != len(hap_aln_to_ref)

    read_aln_index = 0
    sb = seed_base
    while sb > 0 and read_aln_index < len(read_aln_to_hap):
        if read_aln_to_hap[read_aln_index] in "MIS":
            sb -= 1
        read_aln_index += 1
    while (read_aln_index < len(read_aln_to_hap)
           and read_aln_to_hap[read_aln_index] == "D"):
        read_aln_index += 1
    assert read_aln_index != len(read_aln_to_hap)

    left = _stitch(hap_aln_to_ref, read_aln_to_hap,
                   hap_aln_index - 1, read_aln_index - 1, -1)[::-1]
    right = _stitch(hap_aln_to_ref, read_aln_to_hap,
                    hap_aln_index + 1, read_aln_index + 1, 1)
    full = left + "M" + right

    # convert leading insertions into soft clips
    chars = list(full)
    for i in range(len(chars)):
        if chars[i] == "I":
            chars[i] = "S"
        else:
            break
    full = "".join(chars)

    start = seed_pos - sum(1 for c in left if c in "DM")
    stop = seed_pos + sum(1 for c in right if c in "DM")

    cigar = condense_cigar(full)

    read_index = 0
    aln_parts = []
    bases = orig_aln.sequence
    for c in full:
        if c == "S":
            read_index += 1
        elif c in "MI":
            aln_parts.append(bases[read_index])
            read_index += 1
        elif c == "D":
            aln_parts.append("-")
        else:
            raise AssertionError("bad op in stitched alignment")

    new_aln = Alignment(start, stop, False, "TRACE", orig_aln.base_qualities,
                        orig_aln.sequence, "".join(aln_parts))
    new_aln.cigar = cigar
    return new_aln
