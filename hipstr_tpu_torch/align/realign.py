"""Copy of hipstr_tpu/align/realign.py.

Read realignment against the reference window.

Port of AlignmentOps::realign / convertAlignment (reference:
src/SeqAlignment/AlignmentOps.cpp:8-167): each read is re-aligned to the
chromosome window +/-75 bp around its mapped span with the NW aligner, and the
result is stored as an Alignment whose gapped string/cigar drive haplotype
generation and the HMM.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .alignment_data import Alignment, CigarElement
from .nw import align as nw_align

ALIGN_WINDOW_WIDTH = 75


def realign(read_start: int, read_end: int, name: str, sequence: str,
            qualities: str, rev_strand: bool, chrom_seq: str) -> Optional[Alignment]:
    """Realign one read; read_end is the exclusive end position of the
    original mapping (BamAlignment::GetEndPosition semantics)."""
    start = max(read_start - ALIGN_WINDOW_WIDTH - 1, 0)
    stop = min(read_end + ALIGN_WINDOW_WIDTH - 1, len(chrom_seq) - 1)
    ref_seq = chrom_seq[start:stop + 1]
    read_seq = sequence

    aligned, ref_al, read_al, score, cigar_list = nw_align(ref_seq, read_seq)

    num_lead = 0
    while num_lead < len(read_al) and read_al[num_lead] == "-":
        num_lead += 1
    start_position = start + num_lead

    trail_index = len(read_al) - 1
    while trail_index >= 0 and read_al[trail_index] == "-":
        trail_index -= 1
    num_trail = len(read_al) - 1 - trail_index

    end_position = start_position
    for el in cigar_list:
        if el.type in "X=D":
            end_position += el.num
        elif el.type == "I":
            pass
        elif el.type == "S":
            break
        else:
            raise AssertionError(f"Invalid CIGAR char {el.type} in realign")
    end_position -= 1

    num_head_sclips = 0
    while num_head_sclips < len(ref_al) and ref_al[num_head_sclips] == "-":
        num_head_sclips += 1
    num_back = len(ref_al) - 1
    while num_back > 0 and ref_al[num_back] == "-":
        num_back -= 1
    num_back_sclips = len(ref_al) - 1 - num_back

    assert len(sequence) == len(qualities)
    base_quals = qualities[num_head_sclips:len(read_seq) - num_back_sclips]
    seq = read_seq[num_head_sclips:len(read_seq) - num_back_sclips].upper()
    aln_str = read_al[num_head_sclips + num_lead:
                      len(read_al) - num_trail - num_back_sclips].upper()

    new_aln = Alignment(start_position, end_position, rev_strand, name,
                        base_quals, seq, aln_str)

    # trim CIGAR for clipped bases (AlignmentOps.cpp:77-97)
    head, tail = num_head_sclips, num_back_sclips
    end_iter = len(cigar_list) - 1
    while end_iter > 0 and tail > cigar_list[end_iter].num:
        tail -= cigar_list[end_iter].num
        end_iter -= 1
    for el in cigar_list[:end_iter]:
        if head >= el.num:
            head -= el.num
        elif head > 0:
            new_aln.cigar.append(CigarElement(el.type, el.num - head))
            head = 0
        else:
            new_aln.cigar.append(CigarElement(el.type, el.num))
    last = cigar_list[end_iter]
    if head + tail > last.num:
        raise AssertionError("CIGAR trim exceeds element length")
    if head + tail < last.num:
        new_aln.cigar.append(CigarElement(last.type, last.num - head - tail))

    return new_aln if aligned else None


def convert_alignment(read_start: int, name: str, sequence: str,
                      qualities: str, rev_strand: bool,
                      cigar: list, chrom_seq: str) -> Alignment:
    """Convert a reference-matching mapping (cigar all M/=/S/H) without NW.

    Port of AlignmentOps::convertAlignment (AlignmentOps.cpp:102-167):
    M runs split into =/X against the reference; end = last aligned base.
    """
    import numpy as np

    read_seq = sequence.upper()
    seq_index = 0
    ref_index = read_start
    aln_parts = []
    out_cigar = []

    for n, op in cigar:
        if op == "H":
            continue
        if op == "S":
            out_cigar.append(CigarElement("S", n))
            seq_index += n
        elif op == "I":
            out_cigar.append(CigarElement("I", n))
            aln_parts.append(read_seq[seq_index:seq_index + n])
            seq_index += n
        elif op == "D":
            out_cigar.append(CigarElement("D", n))
            aln_parts.append("-" * n)
            ref_index += n
        elif op in "M=X":
            # split the M run into =/X elements: one vectorized compare +
            # run-length encoding instead of a per-base Python loop
            rs = read_seq[seq_index:seq_index + n]
            cs = chrom_seq[ref_index:ref_index + n].upper()
            same = (np.frombuffer(rs.encode("latin1"), np.uint8)
                    == np.frombuffer(cs.encode("latin1"), np.uint8))
            flips = np.nonzero(same[1:] != same[:-1])[0]
            prev = 0
            eq = bool(same[0]) if n else True
            for f in flips.tolist():
                out_cigar.append(CigarElement("=" if eq else "X", f + 1 - prev))
                prev = f + 1
                eq = not eq
            if n > prev:
                out_cigar.append(CigarElement("=" if eq else "X", n - prev))
            aln_parts.append(rs)
            seq_index += n
            ref_index += n
        else:
            raise AssertionError("bad CIGAR in convert_alignment")

    aln = Alignment(read_start, ref_index - 1, rev_strand, name, qualities,
                    read_seq, "".join(aln_parts))
    aln.cigar = out_cigar
    return aln
