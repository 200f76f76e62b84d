"""Copy of hipstr_tpu/align/alignment_data.py.

Alignment records and CIGAR utilities.

Capability parity with the reference's Alignment/CigarElement PODs
(reference: src/SeqAlignment/AlignmentData.h:12-137) and the lobSTR-derived
ExtractCigar (reference: src/extract_indels.cpp:18-101).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class CigarElement:
    type: str
    num: int


@dataclass
class Alignment:
    """One aligned read: [start, stop] reference span + CIGAR + strings.

    `alignment` is the gapped alignment string (read bases with '-' at
    deletions); `stop` is the inclusive reference coordinate of the last
    aligned base.
    """

    start: int
    stop: int
    rev_strand: bool
    name: str
    base_qualities: str
    sequence: str
    alignment: str
    cigar: List[CigarElement] = field(default_factory=list)
    use_for_haps: List[bool] = field(default_factory=list)
    # mate metadata used by filters/pipeline
    mapq: int = 0
    is_paired: bool = False

    def cigar_string(self) -> str:
        return "".join(f"{c.num}{c.type}" for c in self.cigar)

    def num_indels(self) -> int:
        return sum(1 for c in self.cigar if c.type in "ID")

    def num_mismatches(self) -> int:
        return sum(1 for c in self.cigar if c.type == "X")

    def num_matched_bases(self) -> int:
        return sum(c.num for c in self.cigar if c.type in "M=")

    def use_for_hap_generation(self, region_index: int) -> bool:
        return self.use_for_haps[region_index]

    def sort_key(self):
        return (self.start, self.stop)


def condense_cigar(ops: str) -> List[CigarElement]:
    """Run-length encode an op-character string into a CIGAR list."""
    out: List[CigarElement] = []
    for ch in ops:
        if out and out[-1].type == ch:
            out[-1].num += 1
        else:
            out.append(CigarElement(ch, 1))
    return out


def extract_cigar_bp_diff(cigar: List[CigarElement], cigar_start: int,
                          region_start: int, region_end: int) -> Optional[int]:
    """Net inserted-minus-deleted bp of a read inside [region_start, region_end].

    Literal port of ExtractCigar (reference: src/extract_indels.cpp:18-101);
    returns None where the reference returns false.
    """
    assert cigar_start >= 0 and region_end >= region_start
    consumes_ref = set("M=XD")
    match_types = set("M=X")

    region_len = sum(c.num for c in cigar if c.type in consumes_ref)
    if region_start < cigar_start:
        return None
    if region_end >= cigar_start + region_len:
        return None

    pos = cigar_start
    start_index = 0
    last_match = 0
    while pos < region_start and start_index < len(cigar):
        c = cigar[start_index]
        if c.type in consumes_ref:
            pos += c.num
        if c.type in match_types:
            last_match = start_index
        start_index += 1
    start_index = last_match
    if start_index == 0 and cigar[start_index].type not in match_types:
        return None

    end_index = len(cigar) - 1
    last_match = len(cigar) - 1
    pos = cigar_start + region_len
    while pos > region_end:
        c = cigar[end_index]
        if c.type in consumes_ref:
            pos -= c.num
        if c.type in match_types:
            last_match = end_index
        if end_index == 0:
            break
        end_index -= 1
    end_index = last_match
    if end_index == len(cigar) - 1 and cigar[end_index].type not in match_types:
        return None

    diff = 0
    for i in range(start_index, end_index + 1):
        if cigar[i].type == "D":
            diff -= cigar[i].num
        elif cigar[i].type == "I":
            diff += cigar[i].num
    return diff
