"""Copy of hipstr_tpu/align/packing.py.

Host-side packing of haplotypes + read pools into device tensors.

Bridges the string world (align/haplotype.py) and the batched device HMM
(ops/hmm.py).  A locus's haplotypes share one row structure: flank blocks are
length-preserving across options (SNP alternates only — indel flanks are
masked upstream, mirroring the reference's same-length flank rule,
src/seq_stutter_genotyper.cpp:40-217) and a repeat block always collapses to
one DP row, so all per-haplotype variation lives in dense [haps, rows] char /
transition tables.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..models.alignment_model import (
    LOG_MATCH_TO_DEL,
    LOG_MATCH_TO_INS,
    LOG_MATCH_TO_MATCH,
    MAX_HOMOP_LEN,
)
from ..models.base_quality import BaseQuality
from .haplotype import Haplotype

BASE_CODES = {"A": 0, "C": 1, "G": 2, "T": 3}
IMPOSSIBLE = -1.0e9


_CODE_BY_BYTE = np.full(256, 4, dtype=np.int8)
for _b, _c in BASE_CODES.items():
    _CODE_BY_BYTE[ord(_b)] = _c


def seq_to_codes(seq: str) -> np.ndarray:
    return _CODE_BY_BYTE[np.frombuffer(seq.encode("latin1"), dtype=np.uint8)]


@dataclass
class RowStructure:
    """Structural (hap-independent) row layout for one orientation."""

    rows: List[Tuple[int, int]]   # (block, coord); repeat block -> one row
    stutter_row: int
    repeat_block: int
    row_of: dict                  # (block, coord_key) -> row; repeat uses 'last'


def build_row_structure(block_lens: List[int], is_stutter: List[bool]) -> RowStructure:
    assert sum(is_stutter) == 1, "exactly one repeat block per locus supported"
    assert not is_stutter[0] and not is_stutter[-1], \
        "haplotype must start and end with flank blocks"
    rows: List[Tuple[int, int]] = []
    row_of = {}
    stutter_row = -1
    repeat_block = is_stutter.index(True)
    for b, (blen, stut) in enumerate(zip(block_lens, is_stutter)):
        if stut:
            stutter_row = len(rows)
            rows.append((b, -1))
            row_of[(b, "last")] = stutter_row
        else:
            start_c = 1 if b == 0 else 0
            if b == 0:
                rows.append((0, 0))
                row_of[(0, 0)] = 0
            for c in range(start_c, blen):
                row_of[(b, c)] = len(rows)
                rows.append((b, c))
    return RowStructure(rows, stutter_row, repeat_block, row_of)


@dataclass
class PackedHaplotypes:
    """All numpy arrays consumed by ops.hmm.hmm_forward for one locus."""

    R: int
    H: int
    O: int
    period: int
    fw: dict
    rev: dict
    seed: dict
    num_seeds: int


def _pack_orientation(src: Haplotype, digit_rows: List[List[int]],
                      struct: RowStructure, L: int,
                      rep_emission_codes: np.ndarray, rep_len: np.ndarray,
                      lpmf: np.ndarray, hap_opt: np.ndarray,
                      art_sizes: np.ndarray) -> dict:
    H = len(digit_rows)
    R = len(struct.rows)
    row_char = np.zeros((H, R), dtype=np.int8)
    row_m2m = np.zeros((H, R), dtype=np.float64)
    row_m2i = np.zeros((H, R), dtype=np.float64)
    row_m2d = np.zeros((H, R), dtype=np.float64)

    # contiguous row span per non-repeat block (build_row_structure emits
    # blocks in order; the repeat block is the single stutter row)
    spans = {}
    for r, (b, c) in enumerate(struct.rows):
        if c < 0:
            continue
        lo, c0, _ = spans.get(b, (r, c, r))
        spans[b] = (lo, c0, r)

    m2m_lut = np.asarray(LOG_MATCH_TO_MATCH)
    m2i_lut = np.asarray(LOG_MATCH_TO_INS)
    m2d_lut = np.asarray(LOG_MATCH_TO_DEL)
    codes_cache = {}
    for b, (lo, c0, hi) in spans.items():
        span = hi - lo + 1
        # per-option char codes, gathered over haplotypes in one shot
        n_opt = src.blocks[b].num_options()
        opt_mat = np.empty((n_opt, span), dtype=np.int8)
        for d in range(n_opt):
            ck = (b, d)
            codes = codes_cache.get(ck)
            if codes is None:
                codes = codes_cache[ck] = seq_to_codes(src.blocks[b].get_seq(d))
            opt_mat[d] = codes[c0:c0 + span]
        dvec = np.fromiter((dg[b] for dg in digit_rows), dtype=np.int64,
                           count=H)
        row_char[:, lo:hi + 1] = opt_mat[dvec]
        # transition tables depend on the WHOLE digit tuple (homopolymer
        # runs cross block boundaries); the per-digit run arrays are cached
        # inside homopolymer_array, and the three LUT gathers run once over
        # the stacked [H, span] matrix instead of per haplotype
        hp_rows = np.empty((H, span), dtype=np.int64)
        for h in range(H):
            raw = src.homopolymer_array(digit_rows[h], b)
            prev = np.concatenate([raw[:1], raw[:-1]]) if raw.size else raw
            hp = np.minimum(MAX_HOMOP_LEN, np.maximum(raw, prev))
            hp_rows[h] = hp[c0:c0 + span]
        row_m2m[:, lo:hi + 1] = m2m_lut[hp_rows]
        row_m2i[:, lo:hi + 1] = m2i_lut[hp_rows]
        row_m2d[:, lo:hi + 1] = m2d_lut[hp_rows]
    # init / forced-match rows carry no transitions
    for r0 in (0, struct.stutter_row + 1):
        if 0 <= r0 < R:
            row_m2m[:, r0] = 0.0
            row_m2i[:, r0] = 0.0
            row_m2d[:, r0] = 0.0

    # repeat-row entry offsets (j - rep_len - D) are computed on device from
    # rep_len + hap_opt; nothing per-[H, nD, L] is shipped from host
    return dict(row_char=row_char, row_m2m=row_m2m, row_m2i=row_m2i,
                row_m2d=row_m2d, stutter_row=struct.stutter_row,
                rep_rev_codes=rep_emission_codes, rep_len=rep_len,
                lpmf=lpmf, hap_opt=hap_opt)


def pack_haplotypes(haplotype: Haplotype, L: int) -> PackedHaplotypes:
    """Pack all combinations of `haplotype` for segment length L."""
    blocks = haplotype.blocks
    is_stutter = [b.is_repeat for b in blocks]
    rb = is_stutter.index(True)
    rep = blocks[rb]
    rinfo = rep.repeat_info
    period = rinfo.period

    # flank blocks must be length-preserving across options
    for b, stut in zip(blocks, is_stutter):
        if not stut:
            assert len({len(s) for s in b.seqs}) == 1, \
                "flank block options must share a length"

    fw_lens = [b.size(0) for b in blocks]
    fw_struct = build_row_structure(fw_lens, is_stutter)
    rev_lens = list(reversed(fw_lens))
    rev_struct = build_row_structure(rev_lens, list(reversed(is_stutter)))
    R = len(fw_struct.rows)
    assert len(rev_struct.rows) == R

    H = haplotype.num_combs
    O = rep.num_options()
    digit_rows = [haplotype.digits(h) for h in range(H)]
    rev_digit_rows = [list(reversed(d)) for d in digit_rows]
    hap_opt = np.array([d[rb] for d in digit_rows], dtype=np.int32)

    art_sizes = np.arange(rinfo.max_deletion, rinfo.max_insertion + 1, period,
                          dtype=np.int64)
    nD = len(art_sizes)
    rep_len = np.array([rep.size(o) for o in range(O)], dtype=np.int32)
    Bmax = int(rep_len.max()) + 1
    fw_codes = np.full((O, Bmax), 4, dtype=np.int8)    # right-to-left (fw pass)
    rev_codes = np.full((O, Bmax), 4, dtype=np.int8)   # left-to-right (rev pass)
    lpmf = np.full((O, nD), IMPOSSIBLE, dtype=np.float64)
    for o in range(O):
        s = rep.get_seq(o)
        fw_codes[o, :len(s)] = seq_to_codes(s[::-1])
        rev_codes[o, :len(s)] = seq_to_codes(s)
        for d, D in enumerate(art_sizes):
            if len(s) + D >= 0:
                lpmf[o, d] = rinfo.log_prob_pcr_artifact(o, int(D))

    rev_hap = haplotype.reversed_view()
    fw = _pack_orientation(haplotype, digit_rows, fw_struct, L,
                           fw_codes, rep_len, lpmf, hap_opt, art_sizes)
    rev = _pack_orientation(rev_hap, rev_digit_rows, rev_struct, L,
                            rev_codes, rep_len, lpmf, hap_opt, art_sizes)

    # ---- seed tables ---------------------------------------------------------
    n = len(blocks)
    seeds = []
    seed_groups = []   # (block, c_lo, c_hi, first seed index) per flank block
    for b in range(n):
        if is_stutter[b]:
            continue
        lo = 1 if b == 0 else 0
        hi = fw_lens[b] - 1 if b == n - 1 else fw_lens[b]
        if hi > lo:
            seed_groups.append((b, lo, hi, len(seeds)))
        for c in range(lo, hi):
            seeds.append((b, c))

    def fw_row_for(b, c):
        if is_stutter[b]:
            assert c == fw_lens[b] - 1 or c == -1
            return fw_struct.row_of[(b, "last")]
        return fw_struct.row_of[(b, c)]

    def rev_row_for(b, c):
        """Row of the rev structure for the mirror of fw position (b, c)."""
        rb_ = n - 1 - b
        if is_stutter[b]:
            assert c == 0  # mirror of repeat's first char = rev repeat's last
            return rev_struct.row_of[(rb_, "last")]
        rc = fw_lens[b] - 1 - c
        return rev_struct.row_of[(rb_, rc)]

    S = len(seeds)
    seed_fw_row = np.zeros(S, dtype=np.int32)
    seed_rev_row = np.zeros(S, dtype=np.int32)
    seed_char = np.zeros((H, S), dtype=np.int32)
    # anchor rows: flank rows are consecutive within a block
    # (build_row_structure emits them in order), so each group is an
    # arithmetic ramp; only the block-boundary first element needs the dict
    for b, lo, hi, s0 in seed_groups:
        cnt = hi - lo
        # left anchors: fw rows of (b, lo-1 .. hi-2), with the c == 0 seed
        # anchored at the previous block's last position
        if lo > 0:
            base = fw_row_for(b, lo - 1)
        else:
            base = fw_row_for(b - 1, fw_lens[b - 1] - 1)
        seed_fw_row[s0] = base
        if cnt > 1:
            r1 = fw_row_for(b, lo)   # rows (b, lo .. hi-2) are consecutive
            seed_fw_row[s0 + 1:s0 + cnt] = np.arange(r1, r1 + cnt - 1,
                                                     dtype=np.int32)
        # right anchors: mirrors of (b, lo+1 .. hi), descending in the rev
        # structure; the c == hi-1 seed anchors at the next block's start
        if hi < fw_lens[b]:
            last_anchor = rev_row_for(b, hi)
        else:
            last_anchor = rev_row_for(b + 1, 0)
        if cnt > 1:
            r1 = rev_row_for(b, lo + 1)
            seed_rev_row[s0:s0 + cnt - 1] = np.arange(
                r1, r1 - (cnt - 1), -1, dtype=np.int32)
        seed_rev_row[s0 + cnt - 1] = last_anchor

    codes32_cache: dict = {}

    def codes32(b, d):
        got = codes32_cache.get((b, d))
        if got is None:
            got = codes32_cache[(b, d)] = \
                seq_to_codes(blocks[b].get_seq(d)).astype(np.int32)
        return got

    for h, digits in enumerate(digit_rows):
        for b, lo, hi, s0 in seed_groups:
            seed_char[h, s0:s0 + (hi - lo)] = codes32(b, digits[b])[lo:hi]

    num_seeds = sum(fw_lens[b] for b in range(n) if not is_stutter[b])
    first_char = np.array([codes32(0, d[0])[0] for d in digit_rows],
                          dtype=np.int32)
    last_char = np.array([codes32(n - 1, d[-1])[-1] for d in digit_rows],
                         dtype=np.int32)

    seed = dict(seed_fw_row=seed_fw_row, seed_rev_row=seed_rev_row,
                seed_char=seed_char, seed_valid=np.ones(S, dtype=bool),
                first_char=first_char, last_char=last_char,
                log_num_seeds=-float(np.log(num_seeds)))

    return PackedHaplotypes(R=R, H=H, O=O, period=period,
                            fw=fw, rev=rev, seed=seed, num_seeds=num_seeds)


@dataclass
class PackedReads:
    """Reads as raw codes + quality bytes; the device expands qualities to
    log-probabilities through the BaseQuality tables (one tiny gather), so
    the host ships 2 bytes/base instead of 20."""

    l_codes: np.ndarray   # [P, L] int8
    l_quals: np.ndarray   # [P, L] uint8 raw quality bytes (0 = padding)
    l_last: np.ndarray
    r_codes: np.ndarray
    r_quals: np.ndarray
    r_last: np.ndarray
    seed_codes: np.ndarray  # [P] int8
    seed_quals: np.ndarray  # [P] uint8


def pack_reads(seqs: List[str], quals: List[str], seeds: List[int],
               L: int) -> PackedReads:
    """Split reads at their seed base and pad segments to width L.

    The right segment is reversed (aligned against the reversed haplotype),
    matching HapAligner::process_read (src/SeqAlignment/HapAligner.cpp:605-609).
    """
    P = len(seqs)
    l_codes = np.full((P, L), 4, dtype=np.int8)
    r_codes = np.full((P, L), 4, dtype=np.int8)
    l_quals = np.zeros((P, L), dtype=np.uint8)
    r_quals = np.zeros((P, L), dtype=np.uint8)
    l_last = np.zeros(P, dtype=np.int32)
    r_last = np.zeros(P, dtype=np.int32)
    seed_codes = np.zeros(P, dtype=np.int8)
    seed_quals = np.zeros(P, dtype=np.uint8)

    for p, (seq, qual, seed) in enumerate(zip(seqs, quals, seeds)):
        assert 0 < seed < len(seq) - 1, "seed must be interior"
        codes = seq_to_codes(seq)
        qbytes = np.frombuffer(qual.encode("latin1"), dtype=np.uint8)
        nl = seed
        nr = len(seq) - seed - 1
        assert nl <= L and nr <= L
        l_codes[p, :nl] = codes[:seed]
        l_quals[p, :nl] = qbytes[:seed]
        l_last[p] = nl - 1
        r_codes[p, :nr] = codes[seed + 1:][::-1]
        r_quals[p, :nr] = qbytes[seed + 1:][::-1]
        r_last[p] = nr - 1
        seed_codes[p] = codes[seed]
        seed_quals[p] = qbytes[seed]

    return PackedReads(l_codes, l_quals, l_last,
                       r_codes, r_quals, r_last,
                       seed_codes, seed_quals)
