"""Copy of hipstr_tpu/align/nw.py.

Needleman-Wunsch affine aligner with indel left-alignment.

Capability parity with the reference aligner (reference:
src/SeqAlignment/NeedlemanWunsch.{h,cpp}): match=2, mismatch=-2, gap open 5,
gap extend 0.125, N matches everything, free leading/trailing reference gaps
unless `use_ref_end_penalty`, and ties resolved toward leftmost indel
placement.

Re-design notes: rows are vectorized numpy ops (the within-row reference-gap
recurrence becomes a cumulative max after an affine transform); traceback
decisions are recomputed from the score matrices instead of storing trace
matrices.  Left-alignment is applied as a score-preserving post-pass that
slides each indel run as far left as the sequence context allows (the
reference achieves the same end via bit-packed indel-location tie-breaking,
NeedlemanWunsch.cpp:10-76; a native implementation with the exact packed
tie-break is planned for the host C++ library).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .alignment_data import CigarElement, condense_cigar

MATCH = 2.0
MISMATCH = -2.0
GAPOPEN = 5.0
GAPEXTEND = 0.125
LARGE = 1000000.0

_CODE = np.full(256, 4, dtype=np.int8)
for i, c in enumerate("ACGT"):
    _CODE[ord(c)] = i
    _CODE[ord(c.lower())] = i


def _codes(s: str) -> np.ndarray:
    return _CODE[np.frombuffer(s.encode("latin1"), dtype=np.uint8)]


def _scores(ref_codes, read_code):
    """Score of one read base against every ref base (N matches all)."""
    eq = (ref_codes == read_code) | (ref_codes == 4) | (read_code == 4)
    return np.where(eq, np.float32(MATCH), np.float32(MISMATCH))


def align(ref_seq: str, read_seq: str, use_ref_end_penalty: bool = False):
    """Global alignment; returns (ok, ref_al, read_al, score, cigar).

    ok is False when the read extends past the reference boundaries
    (soft-clip at either end), matching NeedlemanWunsch::Align
    (NeedlemanWunsch.cpp:380-420).  Uses the native C++ kernel when built
    (native/nw_kernel.cpp), falling back to the vectorized numpy DP.
    """
    from ..native import nw_align_native
    res = nw_align_native(ref_seq, read_seq, use_ref_end_penalty)
    if res is not None:
        ref_al, read_al, score = res
        cigar = cigar_from_alignment(ref_al, read_al)
        ok = not (cigar and (cigar[0].type == "S" or cigar[-1].type == "S"))
        return ok, ref_al, read_al, score, cigar
    L1, L2 = len(ref_seq), len(read_seq)
    ref_codes = _codes(ref_seq).astype(np.int16)
    read_codes = _codes(read_seq).astype(np.int16)

    M = np.full((L2 + 1, L1 + 1), -LARGE, dtype=np.float32)
    Iref = np.full((L2 + 1, L1 + 1), -LARGE, dtype=np.float32)
    Iread = np.full((L2 + 1, L1 + 1), -LARGE, dtype=np.float32)
    M[0, 0] = 0.0
    cols = np.arange(1, L1 + 1, dtype=np.float32)
    if use_ref_end_penalty:
        Iref[0, 1:] = -GAPOPEN - (cols - 1) * GAPEXTEND
    else:
        Iref[0, 1:] = 0.0
    rows = np.arange(1, L2 + 1, dtype=np.float32)
    Iread[1:, 0] = -GAPOPEN - (rows - 1) * GAPEXTEND

    jidx = np.arange(L1, dtype=np.float32)
    for i in range(1, L2 + 1):
        s = _scores(ref_codes, read_codes[i - 1]).astype(np.float32)
        prevM, prevIref, prevIread = M[i - 1], Iref[i - 1], Iread[i - 1]
        # M[i][j] from (i-1, j-1)
        diag_best = np.maximum(prevM, np.maximum(prevIref, prevIread))
        M[i, 1:] = diag_best[:-1] + s
        # Iread[i][j] from (i-1, j)
        Iread[i, 1:] = np.maximum(
            prevM[1:] - GAPOPEN,
            np.maximum(prevIref[1:] - GAPOPEN, prevIread[1:] - GAPEXTEND))
        # Iref[i][j] from (i, j-1): within-row recurrence
        #   Iref[j] = max(M[j-1]-GO, Iread[j-1]-GO, Iref[j-1]-GE)
        # solved as a cumulative max: with A[k] = max(M[k], Iread[k]) - GO
        # (k = j-1) and B[k] = A[k] + k*GE, Iref[j] = cummax(B)[j-1]-(j-1)*GE.
        A = np.maximum(M[i, :-1], Iread[i, :-1]) - GAPOPEN
        A[0] = max(A[0], Iref[i, 0] - GAPEXTEND)  # border chain (impossible)
        B = A + jidx * GAPEXTEND
        Iref[i, 1:] = np.maximum.accumulate(B) - jidx * GAPEXTEND

    # pick optimal stop (reference findOptimalStop[EndPenalty])
    if use_ref_end_penalty:
        cands = np.array([M[L2, L1], Iref[L2, L1], Iread[L2, L1]])
        best_type = int(np.argmax([cands[0], cands[1] - 0, cands[2]]))
        # ties: M wins, then Iref, then Iread (> comparisons in reference)
        best_val = float(cands[best_type])
        best_col = L1
    else:
        lastM, lastIref, lastIread = M[L2], Iref[L2], Iread[L2]
        best_val, best_col, best_type = -LARGE, -1, -1
        stacked = np.stack([lastM, lastIref, lastIread])
        # replicate reference scan order: columns ascending; >= for M, > for others
        for col in range(L1 + 1):
            if lastM[col] >= best_val:
                best_val, best_col, best_type = float(lastM[col]), col, 0
            if lastIref[col] > best_val:
                best_val, best_col, best_type = float(lastIref[col]), col, 1
            if lastIread[col] > best_val:
                best_val, best_col, best_type = float(lastIread[col]), col, 2

    ref_al, read_al, cigar_ops = _trace(M, Iref, Iread, ref_seq, read_seq,
                                        best_col, best_type)
    cigar = condense_cigar(cigar_ops)
    ok = not (cigar and (cigar[0].type == "S" or cigar[-1].type == "S"))
    return ok, ref_al, read_al, best_val, cigar


def _best3(s1, s2, s3):
    """Reference bestIndex tie-break (NeedlemanWunsch.cpp:120-141)."""
    if s2 > s1:
        return 1 if s2 > s3 else 2
    return 2 if s3 > s1 else 0


def _trace(M, Iref, Iread, ref_seq, read_seq, best_col, best_type):
    L1, L2 = len(ref_seq), len(read_seq)
    ref_parts, read_parts, ops = [], [], []
    for i in range(L1, best_col, -1):
        ref_parts.append(ref_seq[i - 1])
        read_parts.append("-")
    row, col, typ = L2, best_col, best_type
    while row > 0:
        if typ == 0:
            ref_parts.append(ref_seq[col - 1])
            read_parts.append(read_seq[row - 1])
            same = (_CODE[ord(ref_seq[col - 1])]
                    == _CODE[ord(read_seq[row - 1])])
            ops.append("=" if same else "X")
            typ = _best3(M[row - 1, col - 1], Iref[row - 1, col - 1],
                         Iread[row - 1, col - 1])
            row -= 1
            col -= 1
        elif typ == 1:
            ref_parts.append(ref_seq[col - 1])
            read_parts.append("-")
            ops.append("D")
            typ = _best3(M[row, col - 1] - GAPOPEN,
                         Iref[row, col - 1] - GAPEXTEND,
                         Iread[row, col - 1] - GAPOPEN)
            col -= 1
        else:
            ref_parts.append("-")
            read_parts.append(read_seq[row - 1])
            ops.append("I")
            typ = _best3(M[row - 1, col] - GAPOPEN,
                         Iref[row - 1, col] - GAPOPEN,
                         Iread[row - 1, col] - GAPEXTEND)
            row -= 1
    for i in range(col, 0, -1):
        ref_parts.append(ref_seq[i - 1])
        read_parts.append("-")
    ref_al = "".join(reversed(ref_parts))
    read_al = "".join(reversed(read_parts))
    ops = "".join(reversed(ops))
    # leading/trailing read-gap columns outside the aligned read span are not
    # CIGAR ops (they are reference overhang); soft clips appear only when the
    # read hangs over, which the D/I ops already encode as S via caller checks
    return ref_al, read_al, ops


def left_shift_indels(ref_al: str, read_al: str) -> Tuple[str, str]:
    """Slide each indel run leftward while the alignment score is unchanged.

    Score-preserving shifts move a gap one position left when the displaced
    base matches its new partner exactly as well as before; iterate to a fixed
    point.  Combined with align(), this reproduces the reference LeftAlign's
    leftmost-indel tie-breaking on repetitive contexts.
    """
    ref = list(ref_al)
    read = list(read_al)
    n = len(ref)
    changed = True
    while changed:
        changed = False
        i = 0
        while i < n:
            if read[i] == "-" or ref[i] == "-":
                gap_in_read = read[i] == "-"
                seq = ref if gap_in_read else read
                other = read if gap_in_read else ref
                j = i
                while j < n and other[j] == "-":
                    j += 1
                # gap run [i, j); try moving left: position i-1 must hold a
                # base in both strings, and seq[i-1] must equal seq[j-1]
                if (i > 0 and ref[i - 1] != "-" and read[i - 1] != "-"
                        and seq[i - 1].upper() == seq[j - 1].upper()):
                    # rotate: base at i-1 moves to j-1
                    other[j - 1] = other[i - 1]
                    other[i - 1] = "-"
                    changed = True
                    i = max(i - 2, 0)
                    continue
                i = j
            else:
                i += 1
    return "".join(ref), "".join(read)


def cigar_from_alignment(ref_al: str, read_al: str) -> List[CigarElement]:
    ops = []
    started = False
    # trailing/leading reference overhang (read gap at the ends) is not part
    # of the CIGAR
    first = 0
    last = len(read_al) - 1
    while first < len(read_al) and read_al[first] == "-":
        first += 1
    while last >= 0 and read_al[last] == "-":
        last -= 1
    for i in range(first, last + 1):
        if read_al[i] == "-":
            ops.append("D")
        elif ref_al[i] == "-":
            ops.append("I")
        else:
            same = _CODE[ord(ref_al[i])] == _CODE[ord(read_al[i])]
            ops.append("=" if same else "X")
    return condense_cigar("".join(ops))


def left_align(ref_seq: str, read_seq: str, use_ref_end_penalty: bool = False):
    """NW + indel left-shifting; returns (ok, ref_al, read_al, score, cigar).

    Counterpart of NeedlemanWunsch::LeftAlign (NeedlemanWunsch.cpp:576-643).
    """
    ok, ref_al, read_al, score, cigar = align(ref_seq, read_seq,
                                              use_ref_end_penalty)
    if not ok:
        return ok, ref_al, read_al, score, cigar
    if any(c.type in "ID" for c in cigar):
        ref_al, read_al = left_shift_indels(ref_al, read_al)
        cigar = cigar_from_alignment(ref_al, read_al)
    return True, ref_al, read_al, score, cigar
