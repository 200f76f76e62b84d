"""Copy of hipstr_tpu/align/hmm_reference.py.

Reference-semantics oracle for the stutter-aware read<->haplotype HMM.

A literal, unvectorized transcription of the reference's forward pass
(reference: src/SeqAlignment/HapAligner.cpp:26-231 `align_seq_to_hap` /
`compute_aln_logprob` and src/SeqAlignment/StutterAlignerClass.cpp).  It runs
per (read, haplotype) in pure Python/numpy and exists for two jobs:

1. Ground truth for the batched TPU kernel (tests compare the kernel's LL
   against this oracle on randomized inputs).
2. The host-side single-alignment recompute used for traceback (the device
   returns best-hap / best-artifact summaries; the rare reads that need a full
   alignment string re-run here).

The only intentional numerical difference vs the C++: log-sum-exp here is
exact (the reference uses the Mineiro fast-math approximation,
src/mathops.cpp:97-106).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..models.alignment_model import (
    LOG_DEL_TO_DEL,
    LOG_DEL_TO_MATCH,
    LOG_INS_TO_INS,
    LOG_INS_TO_MATCH,
    LOG_MATCH_TO_DEL,
    LOG_MATCH_TO_INS,
    LOG_MATCH_TO_MATCH,
    MAX_HOMOP_LEN,
)
from .haplotype import Haplotype, RepeatInfo

IMPOSSIBLE = -1000000000.0


def _lse(vals) -> float:
    vals = np.asarray(vals, dtype=np.float64)
    m = vals.max()
    return float(m + np.log(np.sum(np.exp(vals - m))))


def _num_upstream_matches(seq: str, period: int) -> np.ndarray:
    """Forward-orientation periodic match-run lengths.

    Reference: StutterAlignerClass::num_upstream_matches
    (src/SeqAlignment/StutterAlignerClass.h:35-42).
    """
    n = len(seq)
    out = np.zeros(n, dtype=np.int64)
    for i in range(period, n):
        out[i] = 0 if seq[i - period] != seq[i] else 1 + out[i - 1]
    return out


class StutterAlignerOracle:
    """Per-allele stutter-block emission engine (reference-exact).

    Transcribed from src/SeqAlignment/StutterAlignerClass.cpp.  Works in the
    "reverse" convention: offsets index read suffixes from the segment's last
    base; b_rev[k] is the k-th block char from the right.
    """

    def __init__(self, block_seq: str, period: int, left_align: bool,
                 repeat_info: RepeatInfo):
        self.block_seq = block_seq
        self.block_len = len(block_seq)
        self.period = period
        self.left_align = left_align
        assert repeat_info.max_insertion % period == 0
        assert repeat_info.max_deletion % period == 0

        self.num_insertions = repeat_info.max_insertion // period
        self.num_deletions = -(repeat_info.max_deletion // period)
        while self.num_deletions * period > self.block_len:
            self.num_deletions -= 1
        self.max_insertion = period * self.num_insertions
        self.max_deletion = -period * self.num_deletions

        # upstream_match_lengths_[m] = runs for shift (m+1)*period
        # (reference ctor, StutterAlignerClass.h:71-75)
        self.upstream_match_lengths: List[np.ndarray] = []
        shift = period
        while shift <= -self.max_deletion:
            self.upstream_match_lengths.append(_num_upstream_matches(block_seq, shift))
            shift += period
        if self.max_deletion == 0:
            self.upstream_match_lengths.append(
                np.zeros(0, dtype=np.int64) if not block_seq
                else _num_upstream_matches(block_seq, period))

        self._match_probs = None
        self._ins_probs = None
        self._del_probs = None
        self._read = None
        self._blw = None
        self._blc = None

    def _b_rev(self, k: int) -> str:
        return self.block_seq[self.block_len - 1 - k]

    def load_read(self, seq: str, blw: np.ndarray, blc: np.ndarray) -> None:
        """Precompute reverse cumulative match/ins/del tables for a segment.

        Reference: StutterAlignerClass::load_read
        (src/SeqAlignment/StutterAlignerClass.cpp:12-53).  `seq` is the whole
        read segment; offset o corresponds to the suffix whose rightmost base
        is seq[L-1-o].
        """
        L = len(seq)
        self._read, self._blw, self._blc = seq, blw, blc
        self._match_probs = np.full(L, np.nan)
        self._ins_probs = np.full((L, self.num_insertions), np.nan)
        self._del_probs = np.full((L, max(self.num_deletions, 1)), np.nan)

        def sc(read_idx: int, block_char: str) -> float:
            return blc[read_idx] if seq[read_idx] == block_char else blw[read_idx]

        for o in range(L):
            log_prob = 0.0
            j = 0
            while j < min(L - o, -self.max_deletion):
                log_prob += sc(L - 1 - o - j, self._b_rev(j))
                if (j + 1) % self.period == 0:
                    self._del_probs[o, (j + 1) // self.period - 1] = log_prob
                j += 1
            # slots for deletions longer than the remaining read are left
            # unset (stale in the reference; NaN here to catch misuse)
            while j < min(L - o, self.block_len):
                log_prob += sc(L - 1 - o - j, self._b_rev(j))
                j += 1
            self._match_probs[o] = log_prob

            log_ins = 0.0
            j = 0
            while j < min(self.max_insertion, L - o):
                if j % self.period < self.block_len:
                    log_ins += sc(L - 1 - o - j, self._b_rev(j % self.period))
                else:
                    log_ins += blc[L - 1 - o - j]
                if (j + 1) % self.period == 0:
                    self._ins_probs[o, (j + 1) // self.period - 1] = log_ins
                j += 1
            while j < self.max_insertion:
                if (j + 1) % self.period == 0:
                    self._ins_probs[o, (j + 1) // self.period - 1] = log_ins
                j += 1

    # -- the three emission modes (reverse orientation) ------------------------
    def align_no_artifact_reverse(self, offset: int) -> float:
        return float(self._match_probs[offset])

    def align_pcr_insertion_reverse(self, base_seq_len: int, j: int, offset: int,
                                    D: int):
        """Reference: StutterAlignerClass.cpp:59-104.  Returns (LL, best_pos).

        `j` is the read-segment index of the rightmost base (base_seq pointer).
        """
        seq, blw, blc = self._read, self._blw, self._blc
        assert D > 0 and base_seq_len <= self.block_len + D and D % self.period == 0

        def sc(idx: int, block_char: str) -> float:
            return blc[idx] if seq[idx] == block_char else blw[idx]

        log_probs = []
        log_prior = -math.log(self.block_len + 1)
        um = self.upstream_match_lengths[0]  # shift = period

        log_prob = (log_prior + self._ins_probs[offset, D // self.period - 1]
                    + (self._match_probs[offset + D] if base_seq_len > D else 0.0))
        best_pos = 0
        best_LL = log_prob
        log_probs.append(log_prob)

        i = 0
        limit = -min(max(0, base_seq_len - D), self.block_len)
        while i > limit:
            if -i + self.period < self.block_len:
                um_i = int(um[self.block_len - 1 + i])
                if um_i == 0:
                    index = i - self.period
                    while index >= i - D:
                        log_prob -= sc(j + index, self._b_rev(-i))
                        log_prob += sc(j + index, self._b_rev(-i + self.period))
                        index -= self.period
                    log_probs.append(log_prob)
                else:
                    log_probs.append(math.log(um_i) + log_prob)
                    i -= (um_i - 1)
            else:
                log_probs.append(log_prob)

            if log_prob > best_LL or (self.left_align and log_prob == best_LL):
                best_pos = 1 - i
                best_LL = log_prob
            i -= 1

        if i > -self.block_len:
            log_probs.append(math.log(self.block_len + i) + log_prob)

        return _lse(log_probs), best_pos

    def align_pcr_deletion_reverse(self, base_seq_len: int, j: int, offset: int,
                                   D: int):
        """Reference: StutterAlignerClass.cpp:106-150.  Returns (LL, best_pos)."""
        seq, blw, blc = self._read, self._blw, self._blc
        assert D < 0 and self.block_len + D >= 0 and base_seq_len <= self.block_len + D

        def sc(idx: int, block_char: str) -> float:
            return blc[idx] if seq[idx] == block_char else blw[idx]

        log_probs = []
        um = self.upstream_match_lengths[-D // self.period - 1]
        log_prior = -math.log(self.block_len + D + 1)
        log_prob = log_prior
        if offset + D >= 0:
            log_prob += (self._match_probs[offset + D]
                         - self._del_probs[offset + D, -D // self.period - 1])
        else:
            for jj in range(0, -base_seq_len, -1):
                log_prob += sc(j + jj, self.block_seq[self.block_len - 1 + jj + D])
        best_pos = 0
        best_LL = log_prob
        log_probs.append(log_prob)

        i = 0
        while i > -base_seq_len:
            um_i = int(um[self.block_len - 1 + i])
            if um_i == 0:
                log_prob -= sc(j + i, self.block_seq[self.block_len - 1 + i + D])
                log_prob += sc(j + i, self.block_seq[self.block_len - 1 + i])
                log_probs.append(log_prob)
            else:
                log_probs.append(math.log(um_i) + log_prob)
                i -= (um_i - 1)

            if log_prob > best_LL or (self.left_align and log_prob == best_LL):
                best_pos = 1 - i
                best_LL = log_prob
            i -= 1

        if -i < self.block_len + D:
            log_probs.append(math.log(self.block_len + D + i) + log_prob)

        return _lse(log_probs), best_pos

    def align_stutter_region_reverse(self, base_seq_len: int, j: int, offset: int,
                                     D: int):
        if D == 0:
            return self.align_no_artifact_reverse(offset), -1
        if D > 0:
            return self.align_pcr_insertion_reverse(base_seq_len, j, offset, D)
        return self.align_pcr_deletion_reverse(base_seq_len, j, offset, D)


@dataclass
class BlockInstance:
    """One realized haplotype block for a specific combination."""

    seq: str
    repeat_info: Optional[RepeatInfo]
    option: int
    stutter_aligner: Optional[StutterAlignerOracle]

    @property
    def is_stutter(self) -> bool:
        return self.repeat_info is not None


class HaplotypeInstance:
    """A concrete haplotype (fw or rev) realized from Haplotype + index h."""

    def __init__(self, haplotype: Haplotype, h: int, reverse: bool):
        self.reversed = reverse
        src = haplotype.reversed_view() if reverse else haplotype
        digits = (haplotype.reversed_digits(h) if reverse else haplotype.digits(h))
        self._src = src
        self._digits = digits
        self.blocks: List[BlockInstance] = []
        for b, d in zip(src.blocks, digits):
            aligner = None
            if b.repeat_info is not None:
                aligner = StutterAlignerOracle(
                    b.get_seq(d), b.repeat_info.period,
                    left_align=not reverse, repeat_info=b.repeat_info)
            self.blocks.append(BlockInstance(b.get_seq(d), b.repeat_info, d, aligner))
        self.cur_size = sum(len(bi.seq) for bi in self.blocks)

    def num_blocks(self) -> int:
        return len(self.blocks)

    def homopolymer_length(self, block_index: int, base_index: int) -> int:
        return self._src.homopolymer_length_digits(self._digits, block_index, base_index)

    def homop_table(self, block_index: int) -> List[int]:
        """Per-base transition index min(MAX, max(h[b], h[b-1])), cached."""
        tables = getattr(self, "_homop_tables", None)
        if tables is None:
            tables = self._homop_tables = {}
        tbl = tables.get(block_index)
        if tbl is None:
            hl = self._src.homopolymer_array(self._digits, block_index)
            prev = np.concatenate([hl[:1], hl[:-1]]) if hl.size else hl
            tbl = np.minimum(MAX_HOMOP_LEN, np.maximum(hl, prev))
            tables[block_index] = tbl
        return tbl

    def walk_meta(self):
        """Flat block metadata for the C traceback walk
        (native/hmm_kernel.cpp hmm_retrace_walk); built once per instance."""
        cached = getattr(self, "_walk_meta", None)
        if cached is not None:
            return cached
        nb = self.num_blocks()
        seqs = [bi.seq.encode("latin1") for bi in self.blocks]
        bseq_pool = np.frombuffer(b"".join(seqs), np.uint8).copy() \
            if any(seqs) else np.zeros(1, np.uint8)
        offs, o = [], 0
        for s in seqs:
            offs.append(o)
            o += len(s)
        blk_off = np.asarray(offs, np.int32)
        blk_len = np.asarray([len(s) for s in seqs], np.int32)
        blk_is_st = np.asarray([1 if bi.is_stutter else 0
                                for bi in self.blocks], np.uint8)
        blk_start = np.asarray([b.start for b in self._src.blocks], np.int32)
        hp, hoffs, ho = [], [], 0
        for bi_idx, bi in enumerate(self.blocks):
            hoffs.append(ho)
            if bi.is_stutter:
                hp.extend([0] * len(bi.seq))
            else:
                hp.extend(self.homop_table(bi_idx))
            ho += len(bi.seq)
        homop_pool = np.asarray(hp, np.int32) if hp else np.zeros(1, np.int32)
        homop_off = np.asarray(hoffs, np.int32)
        m2m = np.asarray(LOG_MATCH_TO_MATCH, np.float64)
        m2i = np.asarray(LOG_MATCH_TO_INS, np.float64)
        m2d = np.asarray(LOG_MATCH_TO_DEL, np.float64)
        ptr_block = (nb, bseq_pool.ctypes.data, blk_off.ctypes.data,
                     blk_len.ctypes.data, blk_is_st.ctypes.data,
                     blk_start.ctypes.data, homop_pool.ctypes.data,
                     homop_off.ctypes.data)
        cached = (nb, bseq_pool, blk_off, blk_len, blk_is_st, blk_start,
                  homop_pool, homop_off, m2m, m2i, m2d,
                  float(LOG_INS_TO_INS), float(LOG_INS_TO_MATCH),
                  float(LOG_DEL_TO_DEL), float(LOG_DEL_TO_MATCH), ptr_block)
        self._walk_meta = cached
        return cached

    def get_first_char(self) -> str:
        return self.blocks[0].seq[0]

    def get_last_char(self) -> str:
        return self.blocks[-1].seq[-1]

    def get_coordinates(self, hap_pos: int):
        for i, bi in enumerate(self.blocks):
            if hap_pos < len(bi.seq):
                return i, hap_pos
            hap_pos -= len(bi.seq)
        raise AssertionError("hap position out of range")

    def native_meta(self):
        """Flat row/stutter metadata for the C++ DP kernel
        (native/hmm_kernel.cpp); built once per realized haplotype."""
        cached = getattr(self, "_native_meta", None)
        if cached is not None:
            return cached
        H = self.cur_size
        row_kind = np.zeros(H, dtype=np.uint8)
        row_char = np.zeros(H, dtype=np.uint8)
        row_homop = np.zeros(H, dtype=np.int32)
        st_row, st_block, st_seqs, st_len = [], [], [], []
        st_period, st_max_ins, st_max_del, st_left = [], [], [], []
        st_nD, st_art_off, art_sizes, art_lpmf = [], [], [], []

        row_kind[0] = 0
        row_char[0] = ord(self.get_first_char())
        hap_index = 1
        stutter_R = -1
        for block_index, bi in enumerate(self.blocks):
            block_seq = bi.seq
            if bi.is_stutter:
                rep = bi.repeat_info
                blen = len(block_seq)
                for k in range(blen - 1):
                    row_kind[hap_index + k] = 4
                row = hap_index + blen - 1
                row_kind[row] = 3
                st_row.append(row)
                st_block.append(block_index)
                st_seqs.append(block_seq.encode("latin1"))
                st_len.append(blen)
                st_period.append(rep.period)
                st_max_ins.append(rep.max_insertion)
                st_max_del.append(rep.max_deletion)
                st_left.append(0 if self.reversed else 1)
                arts = list(range(rep.max_deletion, rep.max_insertion + 1,
                                  rep.period))
                st_nD.append(len(arts))
                st_art_off.append(len(art_sizes))
                art_sizes.extend(arts)
                art_lpmf.extend(rep.log_prob_pcr_artifact(bi.option, D)
                                for D in arts)
                stutter_R = row
                hap_index += blen
            else:
                coord0 = 1 if block_index == 0 else 0
                cnt = len(block_seq) - coord0
                if cnt > 0:
                    r0 = hap_index
                    row_char[r0:r0 + cnt] = np.frombuffer(
                        block_seq.encode("latin1"), np.uint8)[coord0:]
                    row_kind[r0:r0 + cnt] = 1
                    row_homop[r0:r0 + cnt] = np.asarray(
                        self.homop_table(block_index))[coord0:]
                    fm = stutter_R + 1   # forced-match row after the repeat
                    if r0 <= fm < r0 + cnt:
                        row_kind[fm] = 2
                        row_homop[fm] = 0
                    hap_index += cnt
        assert hap_index == H
        seq_pool = b"".join(st_seqs)
        offs, o = [], 0
        for s in st_seqs:
            offs.append(o)
            o += len(s)
        arrays = (row_kind, row_char, row_homop,
                  np.asarray(st_row, np.int32),
                  np.asarray(st_block, np.int32),
                  np.frombuffer(seq_pool, np.uint8).copy() if seq_pool
                  else np.zeros(1, np.uint8),
                  np.asarray(offs, np.int32), np.asarray(st_len, np.int32),
                  np.asarray(st_period, np.int32),
                  np.asarray(st_max_ins, np.int32),
                  np.asarray(st_max_del, np.int32),
                  np.asarray(st_left, np.int32), np.asarray(st_nD, np.int32),
                  np.asarray(st_art_off, np.int32),
                  np.asarray(art_sizes, np.int32) if art_sizes
                  else np.zeros(1, np.int32),
                  np.asarray(art_lpmf, np.float64) if art_lpmf
                  else np.zeros(1, np.float64),
                  np.asarray(LOG_MATCH_TO_MATCH, np.float64),
                  np.asarray(LOG_MATCH_TO_INS, np.float64),
                  np.asarray(LOG_MATCH_TO_DEL, np.float64))
        a = arrays
        # precomputed raw-pointer argument block for the C kernel; the
        # arrays above are kept alive in the same tuple
        ptr_block = (H, self.num_blocks(), a[0].ctypes.data, a[1].ctypes.data,
                     a[2].ctypes.data, len(st_row), a[3].ctypes.data,
                     a[4].ctypes.data, a[5].ctypes.data, a[6].ctypes.data,
                     a[7].ctypes.data, a[8].ctypes.data, a[9].ctypes.data,
                     a[10].ctypes.data, a[11].ctypes.data, a[12].ctypes.data,
                     a[13].ctypes.data, a[14].ctypes.data, a[15].ctypes.data,
                     a[16].ctypes.data, a[17].ctypes.data, a[18].ctypes.data,
                     float(LOG_INS_TO_INS), float(LOG_INS_TO_MATCH),
                     float(LOG_DEL_TO_DEL), float(LOG_DEL_TO_MATCH))
        meta = arrays + (ptr_block,)
        self._native_meta = meta
        return meta


def align_seq_to_hap(hap: HaplotypeInstance, seq: str,
                     blw: np.ndarray, blc: np.ndarray):
    """Forward DP of one read segment against one haplotype.

    Semantics of HapAligner::align_seq_to_hap
    (src/SeqAlignment/HapAligner.cpp:26-161) with numpy-vectorized rows: the
    within-row insert recurrence is a cumulative max (same transform as the
    device kernel), the delete/match states are shifted previous-row ops, and
    stutter rows marginalize the per-offset artifact emissions.  Matrices are
    [hap_size, seq_len]; rows inside a stutter block other than its last are
    never written (NaN).  Returns (match, insert, delete, best_artifact_size,
    best_artifact_pos, left_prob).
    """
    L = len(seq)
    H = hap.cur_size
    codes = np.frombuffer(seq.encode("latin1"), dtype=np.uint8)

    # native C++ fast path (identical semantics; see native/hmm_kernel.cpp).
    # The C kernel writes every row it (or any consumer) reads — inner
    # stutter rows are skipped on both sides — so uninitialized buffers are
    # safe here and save three NaN fills per segment.
    from .. import native as _native
    if _native.available():
        match = np.empty((H, L))
        insert = np.empty((H, L))
        delete = np.empty((H, L))
        best_art_size = np.full((hap.num_blocks(), L), -10000, dtype=np.int64)
        best_art_pos = np.full((hap.num_blocks(), L), -1, dtype=np.int64)
        blw64 = np.ascontiguousarray(blw, dtype=np.float64)
        blc64 = np.ascontiguousarray(blc, dtype=np.float64)
        lp = _native.hmm_fill_dp_native(
            np.ascontiguousarray(codes), blw64, blc64, hap.native_meta(),
            match, insert, delete, best_art_size, best_art_pos)
        if lp is not None:
            return match, insert, delete, best_art_size, best_art_pos, lp

    match = np.full((H, L), np.nan)
    insert = np.full((H, L), np.nan)
    delete = np.full((H, L), np.nan)
    best_art_size = np.full((hap.num_blocks(), L), -10000, dtype=np.int64)
    best_art_pos = np.full((hap.num_blocks(), L), -1, dtype=np.int64)

    def emit_row(hap_char: str) -> np.ndarray:
        eq = codes == ord(hap_char)
        return np.where(eq, blc, blw)

    C = np.cumsum(blc)
    Csh = np.concatenate([[0.0], C[:-1]])
    jj = np.arange(L)

    # first row: every read base vs the leftmost haplotype char
    first_char = hap.get_first_char()
    match[0] = emit_row(first_char) + Csh
    insert[0] = C
    delete[0] = IMPOSSIBLE
    left_prob = float(C[-1])

    hap_index = 1
    stutter_R = -1
    for block_index, bi in enumerate(hap.blocks):
        block_seq = bi.seq
        if bi.is_stutter:
            rep = bi.repeat_info
            period = rep.period
            block_len = len(block_seq)
            prev_row = hap_index - 1
            row = hap_index + block_len - 1
            aligner = bi.stutter_aligner
            Mprev = match[prev_row]
            # dense emission tensor (verified identical to the incremental
            # aligner; see ops/stutter_emission.py and its oracle test)
            from ..ops.stutter_emission import stutter_emissions
            brev = np.frombuffer(block_seq[::-1].encode("latin1"),
                                 dtype=np.uint8).astype(np.int32)
            E = stutter_emissions(np, codes.astype(np.int32), blw, blc,
                                  np.concatenate([brev, np.full(1, 255,
                                                                np.int32)]),
                                  block_len, period)  # [L, nD]
            art_list = list(range(rep.max_deletion, rep.max_insertion + 1,
                                  period))
            nD = len(art_list)
            probs_cols = np.full((nD, L), IMPOSSIBLE)
            jjj = np.arange(L)
            for ai, D in enumerate(art_list):
                if block_len + D < 0:
                    continue
                lpmf = rep.log_prob_pcr_artifact(bi.option, D)
                shift = block_len + D
                pre = np.where(jjj - shift >= 0,
                               Mprev[np.clip(jjj - shift, 0, L - 1)], 0.0)
                probs_cols[ai] = lpmf + E[:, ai] + pre
            best = np.full(L, IMPOSSIBLE)
            for ai, D in enumerate(art_list):
                upd = probs_cols[ai] > best
                best = np.where(upd, probs_cols[ai], best)
                best_art_size[block_index][upd] = D
            # best positions for the winning artifact only (traceback)
            loaded = False
            for j in range(L):
                D = int(best_art_size[block_index, j])
                if D == -10000 or D == 0:
                    best_art_pos[block_index, j] = -1
                    continue
                if not loaded:
                    aligner.load_read(seq, blw, blc)
                    loaded = True
                base_len = min(block_len + D, j + 1)
                _, art_pos = aligner.align_stutter_region_reverse(
                    base_len, j, L - 1 - j, D)
                best_art_pos[block_index, j] = art_pos
            m = probs_cols.max(axis=0)
            match[row] = m + np.log(
                np.sum(np.exp(probs_cols - m[None, :]), axis=0))
            insert[row] = IMPOSSIBLE
            delete[row] = IMPOSSIBLE

            stutter_R = hap_index + block_len - 1
            hap_index += block_len
        else:
            coord = 1 if block_index == 0 else 0
            while coord < len(block_seq):
                hap_char = block_seq[coord]
                r = hap_index
                emit = emit_row(hap_char)
                Mp = match[r - 1]
                Dp = delete[r - 1]

                if r == stutter_R + 1:
                    # stutter block must be exited via a match
                    row_m = np.empty(L)
                    row_m[0] = emit[0]
                    row_m[1:] = emit[1:] + Mp[:-1]
                    match[r] = row_m
                    insert[r] = IMPOSSIBLE
                    delete[r] = IMPOSSIBLE
                else:
                    homop = min(
                        MAX_HOMOP_LEN,
                        max(hap.homopolymer_length(block_index, coord),
                            hap.homopolymer_length(block_index,
                                                   max(0, coord - 1))))
                    am = LOG_MATCH_TO_MATCH[homop]
                    ai_ = LOG_MATCH_TO_INS[homop]
                    ad = LOG_MATCH_TO_DEL[homop]

                    Dnew = np.maximum(Mp + LOG_DEL_TO_MATCH,
                                      Dp + LOG_DEL_TO_DEL)
                    # insert: I[j] = blc[j] + max(A[j], I[j-1]+ii), A[0]=0
                    A = np.empty(L)
                    A[0] = 0.0
                    A[1:] = Mp[:-1] + LOG_INS_TO_MATCH
                    F = A - Csh - jj * LOG_INS_TO_INS
                    Inew = C + jj * LOG_INS_TO_INS + np.maximum.accumulate(F)

                    T = np.empty(L)
                    T[0] = 0.0
                    T[1:] = np.maximum(
                        Inew[:-1] + ai_,
                        np.maximum(Mp[:-1] + am, Dp[:-1] + ad))
                    match[r] = emit + T
                    insert[r] = Inew
                    delete[r] = Dnew
                coord += 1
                hap_index += 1

    assert hap_index == H
    return match, insert, delete, best_art_size, best_art_pos, left_prob


def seed_meta(fw_hap: HaplotypeInstance):
    """Cached per-instance seed metadata: rows that can anchor the seed,
    their haplotype characters, and the anchor ordering the reference
    iterates (off-hap-left, off-hap-right, then interior rows)."""
    meta = getattr(fw_hap, "_seed_meta", None)
    if meta is None:
        mid_rows, mid_chars = [], []
        hap_index = 1
        for block_index, bi in enumerate(fw_hap.blocks):
            if bi.is_stutter:
                hap_index += len(bi.seq)
                continue
            coord = 1 if block_index == 0 else 0
            end_coord = (len(bi.seq) - 1
                         if block_index == fw_hap.num_blocks() - 1
                         else len(bi.seq))
            while coord < end_coord:
                mid_rows.append(hap_index)
                mid_chars.append(ord(bi.seq[coord]))
                coord += 1
                hap_index += 1
        num_seeds = sum(len(bi.seq) for bi in fw_hap.blocks
                        if not bi.is_stutter)
        meta = (np.asarray(mid_rows, dtype=np.int64),
                np.asarray(mid_chars, dtype=np.int64),
                -math.log(num_seeds),
                ord(fw_hap.get_first_char()), ord(fw_hap.get_last_char()))
        fw_hap._seed_meta = meta
    return meta


def compute_aln_logprob(fw_hap: HaplotypeInstance,
                        seq: str, seed_base: int,
                        blw: np.ndarray, blc: np.ndarray,
                        l_match: np.ndarray, l_prob: float,
                        r_match: np.ndarray, r_prob: float):
    """Seed-anchored combination of the two flank DPs.

    Reference: HapAligner::compute_aln_logprob
    (src/SeqAlignment/HapAligner.cpp:163-231).  Returns (LL, max_index).
    """
    hapsize = fw_hap.cur_size
    seed_char_code = ord(seq[seed_base])

    mid_rows, mid_chars, seed_log_prior, first_code, last_code = \
        seed_meta(fw_hap)

    blc_s = blc[seed_base]
    blw_s = blw[seed_base]
    lp0 = (seed_log_prior + (blc_s if seed_char_code == first_code else blw_s)
           + l_prob + r_match[hapsize - 2, -1])
    lp1 = (seed_log_prior + (blc_s if seed_char_code == last_code else blw_s)
           + r_prob + l_match[hapsize - 2, -1])
    mids = (seed_log_prior
            + np.where(mid_chars == seed_char_code, blc_s, blw_s)
            + l_match[mid_rows - 1, -1]
            + r_match[hapsize - mid_rows - 2, -1])
    log_probs = np.concatenate([[lp0, lp1], mids])
    best = int(np.argmax(log_probs))  # first max wins, like the scalar loop
    if best == 0:
        max_index = 0
    elif best == 1:
        max_index = hapsize - 1
    else:
        max_index = int(mid_rows[best - 2])
    return _lse(log_probs), max_index


def process_read(haplotype: Haplotype, h: int, seq: str, seed_base: int,
                 blw: np.ndarray, blc: np.ndarray) -> float:
    """Full per-(read, haplotype) forward LL (reference HapAligner::process_read,
    src/SeqAlignment/HapAligner.cpp:573-709), without traceback."""
    assert 0 < seed_base < len(seq) - 1
    fw = HaplotypeInstance(haplotype, h, reverse=False)
    rev = HaplotypeInstance(haplotype, h, reverse=True)

    l_seq = seq[:seed_base]
    l_blw, l_blc = blw[:seed_base], blc[:seed_base]
    r_seq = seq[seed_base + 1:][::-1]
    r_blw = blw[seed_base + 1:][::-1].copy()
    r_blc = blc[seed_base + 1:][::-1].copy()

    l_match, _, _, _, _, l_prob = align_seq_to_hap(fw, l_seq, l_blw, l_blc)
    r_match, _, _, _, _, r_prob = align_seq_to_hap(rev, r_seq, r_blw, r_blc)

    LL, _ = compute_aln_logprob(fw, seq, seed_base, blw, blc,
                                l_match, l_prob, r_match, r_prob)
    return LL
