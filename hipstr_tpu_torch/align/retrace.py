"""Copy of hipstr_tpu/align/retrace.py.

Maximum-likelihood alignment retrace (host slow path).

Port of the reference's Viterbi-style traceback (reference:
src/SeqAlignment/HapAligner.cpp:345-571 `retrace` and the retrace branch of
`process_read` :573-709, plus Haplotype::aln_haps_to_ref/adjust_indels,
src/SeqAlignment/Haplotype.cpp:8-86).

In the TPU design the device only returns per-(pool, haplotype) likelihoods;
the handful of reads that need a full alignment string (stutter-candidate
mining, MALLREADS, flank assembly, visualization) re-run a single
(read, haplotype) DP here on host and walk it backwards.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

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
from .alignment_data import Alignment, CigarElement
from .haplotype import Haplotype
from .hmm_reference import HaplotypeInstance, align_seq_to_hap, compute_aln_logprob
from .nw import align as nw_align
from .traceback import AlignmentTrace, stitch_alignment_trace

MIN_SNP_LOG_PROB_CORRECT = -0.0043648054
TRACE_LL_TOL = 0.001


def _triple_min_index(v1, v2, v3):
    if v1 > v2 + TRACE_LL_TOL:
        return 0 if v1 > v3 + TRACE_LL_TOL else 2
    return 1 if v2 > v3 + TRACE_LL_TOL else 2


def _rev_triple_min_index(v1, v2, v3):
    if v3 > v2 + TRACE_LL_TOL:
        return 2 if v3 > v1 + TRACE_LL_TOL else 0
    return 1 if v2 > v1 + TRACE_LL_TOL else 0


def _pair_min_index(v1, v2):
    return 0 if v1 > v2 + TRACE_LL_TOL else 1


def _apply_walk_events(hap: HaplotypeInstance, trace: AlignmentTrace,
                       res) -> str:
    """Apply one C walk's event arrays (hmm_retrace_walk layout) to the
    trace; returns the segment's op string."""
    (aln_b, frag_block, frag_end, frag_pool, str_block, str_size,
     str_end, str_pool, snp_pos, snp_base, indel_pos, indel_size,
     n_ins, n_del) = res
    nb = hap.num_blocks()
    prev = 0
    for bi_idx, end in zip(frag_block, frag_end):
        frag = frag_pool[prev:end].tobytes().decode("latin1")
        prev = end
        if hap.reversed:
            trace.add_flank_data(nb - 1 - int(bi_idx), frag)
        else:
            trace.add_flank_data(int(bi_idx), frag[::-1])
    prev = 0
    for bi_idx, size, end in zip(str_block, str_size, str_end):
        s = str_pool[prev:end].tobytes().decode("latin1")
        prev = end
        if hap.reversed:
            trace.add_str_data(nb - 1 - int(bi_idx), int(size), s)
        else:
            trace.add_str_data(int(bi_idx), int(size), s[::-1])
    for pos_, base_ in zip(snp_pos, snp_base):
        trace.add_flank_snp(int(pos_), chr(int(base_)))
    for pos_, size_ in zip(indel_pos, indel_size):
        trace.add_flank_indel((int(pos_), int(size_)))
    trace.flank_ins_size += n_ins
    trace.flank_del_size += n_del
    return aln_b.tobytes().decode("latin1")


def _rev_pair_min_index(v1, v2):
    return 1 if v2 > v1 + TRACE_LL_TOL else 0


def retrace(hap: HaplotypeInstance, read_seq: str, blc: np.ndarray,
            seq_len: int, block_index: int, base_index: int,
            row: int, col: int,
            M: np.ndarray, I: np.ndarray, D: np.ndarray,
            best_art_size: np.ndarray, best_art_pos: np.ndarray,
            trace: AlignmentTrace) -> str:
    """Walk one segment's DP backwards (reference HapAligner.cpp:363-571).

    (row, col) is the starting cell (haplotype position, read index);
    matrix_type starts at MATCH.
    """
    # native C walk (identical semantics; see native/hmm_kernel.cpp)
    from .. import native as _native
    if _native.available():
        res = _native.hmm_retrace_walk_native(
            np.frombuffer(read_seq.encode("latin1"), dtype=np.uint8),
            np.ascontiguousarray(blc, dtype=np.float64), hap.walk_meta(),
            hap.reversed, block_index, base_index, row, col,
            M, I, D, best_art_size, best_art_pos,
            MIN_SNP_LOG_PROB_CORRECT, TRACE_LL_TOL)
        if res is not None:
            return _apply_walk_events(hap, trace, res)

    MATCH_T, DEL_T, INS_T, NONE_T = 0, 1, 2, -1
    seq_index = seq_len - 1
    matrix_type = MATCH_T
    aln = []

    if not hap.reversed:
        pair_fn, triple_fn = _pair_min_index, _triple_min_index
    else:
        pair_fn, triple_fn = _rev_pair_min_index, _rev_triple_min_index

    while block_index >= 0:
        bi = hap.blocks[block_index]
        if bi.is_stutter:
            block_seq = bi.seq
            block_len = len(block_seq)
            stutter_size = int(best_art_size[block_index, seq_index])
            art_pos = int(best_art_pos[block_index, seq_index])
            assert matrix_type == MATCH_T and base_index + 1 == block_len
            str_parts = []

            i = 0
            while i < min(seq_index + 1, art_pos):
                aln.append("M")
                str_parts.append(read_seq[seq_index - i])
                i += 1
            if stutter_size < 0:
                aln.append("D" * (-stutter_size))
            else:
                while i < min(seq_index + 1, art_pos + stutter_size):
                    aln.append("I")
                    str_parts.append(read_seq[seq_index - i])
                    i += 1
            while i < min(block_len + stutter_size, seq_index + 1):
                aln.append("M")
                str_parts.append(read_seq[seq_index - i])
                i += 1
            str_seq = "".join(str_parts)

            if hap.reversed:
                trace.add_str_data(hap.num_blocks() - 1 - block_index,
                                   stutter_size, str_seq)
            else:
                trace.add_str_data(block_index, stutter_size, str_seq[::-1])

            if block_len + stutter_size >= seq_index + 1:
                return "".join(aln)  # read doesn't span the stutter block
            consumed = block_len + stutter_size
            seq_index -= consumed
            col -= consumed
            row -= block_len
            matrix_type = MATCH_T
        else:
            prev_matrix_type = NONE_T
            block_seq = bi.seq
            pos = (hap._src.blocks[block_index].start
                   + (-base_index if hap.reversed else base_index))
            increment = 1 if hap.reversed else -1
            indel_seq_index = -1
            indel_position = -1
            flank_parts = []

            homop_tbl = hap.homop_table(block_index)
            while base_index >= 0 and seq_index >= 0:
                homop = homop_tbl[base_index]

                if matrix_type != prev_matrix_type:
                    if prev_matrix_type == DEL_T:
                        if hap.reversed:
                            trace.add_flank_indel(
                                (indel_position, indel_position - pos))
                        else:
                            trace.add_flank_indel((pos + 1, pos - indel_position))
                    elif prev_matrix_type == INS_T:
                        trace.add_flank_indel(
                            (indel_position + (0 if hap.reversed else 1),
                             indel_seq_index - seq_index))
                    if matrix_type in (DEL_T, INS_T):
                        indel_seq_index = seq_index
                        indel_position = pos
                    prev_matrix_type = matrix_type

                if matrix_type == MATCH_T:
                    if (block_seq[base_index] != read_seq[seq_index]
                            and blc[seq_index] > MIN_SNP_LOG_PROB_CORRECT):
                        trace.add_flank_snp(pos, read_seq[seq_index])
                    flank_parts.append(read_seq[seq_index])
                    aln.append("M")
                    seq_index -= 1
                    base_index -= 1
                    pos += increment
                elif matrix_type == DEL_T:
                    trace.inc_flank_del()
                    aln.append("D")
                    base_index -= 1
                    pos += increment
                elif matrix_type == INS_T:
                    trace.inc_flank_ins()
                    flank_parts.append(read_seq[seq_index])
                    aln.append("I")
                    seq_index -= 1
                else:
                    raise AssertionError("invalid matrix type in retrace")

                if seq_index == -1 or (base_index == -1 and block_index == 0):
                    while seq_index != -1:
                        aln.append("S")
                        seq_index -= 1
                    flank_seq = "".join(flank_parts)
                    if hap.reversed:
                        trace.add_flank_data(hap.num_blocks() - 1 - block_index,
                                             flank_seq)
                    else:
                        trace.add_flank_data(block_index, flank_seq[::-1])
                    return "".join(aln)

                if matrix_type == MATCH_T:
                    best = triple_fn(
                        I[row, col - 1] + LOG_MATCH_TO_INS[homop],
                        D[row - 1, col - 1] + LOG_MATCH_TO_DEL[homop],
                        M[row - 1, col - 1] + LOG_MATCH_TO_MATCH[homop])
                    if best == 0:
                        matrix_type = INS_T
                        col -= 1
                    elif best == 1:
                        matrix_type = DEL_T
                        row -= 1
                        col -= 1
                    else:
                        matrix_type = MATCH_T
                        row -= 1
                        col -= 1
                elif matrix_type == DEL_T:
                    best = pair_fn(D[row - 1, col] + LOG_DEL_TO_DEL,
                                   M[row - 1, col] + LOG_DEL_TO_MATCH)
                    matrix_type = DEL_T if best == 0 else MATCH_T
                    row -= 1
                else:  # INS
                    best = pair_fn(I[row, col - 1] + LOG_INS_TO_INS,
                                   M[row - 1, col - 1] + LOG_INS_TO_MATCH)
                    if best == 0:
                        matrix_type = INS_T
                        col -= 1
                    else:
                        matrix_type = MATCH_T
                        row -= 1
                        col -= 1

            flank_seq = "".join(flank_parts)
            if hap.reversed:
                trace.add_flank_data(hap.num_blocks() - 1 - block_index, flank_seq)
            else:
                trace.add_flank_data(block_index, flank_seq[::-1])
        block_index -= 1
        if block_index >= 0:
            base_index = len(hap.blocks[block_index].seq) - 1
    return "".join(aln)


class HapAlignInfo:
    """Haplotype-to-reference alignment strings (lazy per combination).

    Reference: Haplotype::aln_haps_to_ref + adjust_indels
    (src/SeqAlignment/Haplotype.cpp:8-86).
    """

    def __init__(self, haplotype: Haplotype, content_cache=None):
        self.haplotype = haplotype
        self._cache: Dict[int, str] = {}
        self._bytes_cache: Dict[int, bytes] = {}
        self._ref_seq = haplotype.seq(0)
        # optional alt-seq-keyed cache shared across a locus's haplotype
        # rebuilds: the NW align depends only on (ref seq, alt seq, block
        # coordinates), all invariant per locus, so surviving alleles skip
        # the realign after mining/pruning changes the combination indexing
        self._content_cache = content_cache

    def aln_info_bytes(self, h: int) -> bytes:
        """aln_info(h) pre-encoded for the native batched stitch (cached)."""
        cache = self._bytes_cache
        b = cache.get(h)
        if b is None:
            b = cache[h] = self.aln_info(h).encode("latin1")
        return b

    def aln_info_ptr(self, h: int):
        """(data pointer, length) of aln_info_bytes(h), cached — the bytes
        object is pinned by _bytes_cache for this object's lifetime."""
        cache = getattr(self, "_ptr_cache", None)
        if cache is None:
            cache = self._ptr_cache = {}
        p = cache.get(h)
        if p is None:
            import ctypes
            b = self.aln_info_bytes(h)
            p = cache[h] = (
                ctypes.cast(ctypes.c_char_p(b), ctypes.c_void_p).value or 0,
                len(b))
        return p

    def aln_info(self, h: int) -> str:
        info = self._cache.get(h)
        if info is None:
            alt_seq = self.haplotype.seq(h)
            shared = self._content_cache
            info = shared.get(alt_seq) if shared is not None else None
            if info is None:
                ok, ref_al, alt_al, score, _ = nw_align(
                    self._ref_seq, alt_seq, use_ref_end_penalty=True)
                if not ok:
                    raise RuntimeError(
                        "failed to align haplotype to reference")
                if self.haplotype.num_blocks() == 3:
                    ref_al, alt_al = self._adjust_indels(ref_al, alt_al)
                parts = []
                for rc, ac in zip(ref_al, alt_al):
                    if rc == "-":
                        parts.append("I")
                    elif ac == "-":
                        parts.append("D")
                    else:
                        parts.append("M")
                info = "".join(parts)
                if shared is not None:
                    shared[alt_seq] = info
            self._cache[h] = info
        return info

    def _adjust_indels(self, ref_al: str, alt_al: str) -> Tuple[str, str]:
        """Slide flank indels rightward into/before the repeat block
        (reference Haplotype.cpp:8-56)."""
        ref_hap = list(ref_al)
        alt_hap = list(alt_al)
        ref_pos = self.haplotype.blocks[0].start
        str_pos = self.haplotype.blocks[1].start
        aln_index = 0
        n = len(alt_hap)
        while aln_index < n:
            if alt_hap[aln_index] == "-" and ref_pos < str_pos:
                index = aln_index
                while index < n and alt_hap[index] == "-":
                    index += 1
                pos = ref_pos
                del_index = aln_index
                del_size = index - aln_index
                while (index < n and pos < str_pos
                       and ref_hap[del_index] == ref_hap[index]):
                    alt_hap[del_index] = alt_hap[index]
                    alt_hap[index] = "-"
                    index += 1
                    del_index += 1
                    pos += 1
                aln_index = index
                ref_pos = pos + del_size
            elif ref_hap[aln_index] == "-" and ref_pos < str_pos:
                index = aln_index
                while index < n and ref_hap[index] == "-":
                    index += 1
                pos = ref_pos
                ins_index = aln_index
                while (index < n and pos < str_pos
                       and alt_hap[ins_index] == alt_hap[index]):
                    ref_hap[ins_index] = ref_hap[index]
                    ref_hap[index] = "-"
                    index += 1
                    ins_index += 1
                    pos += 1
                aln_index = index
                ref_pos = pos
            else:
                if ref_hap[aln_index] != "-":
                    ref_pos += 1
                aln_index += 1
        return "".join(ref_hap), "".join(alt_hap)


def _instances_for(haplotype: Haplotype, h: int):
    """(fw, rev) realized instances, cached on the haplotype — immutable
    w.r.t. (h, reverse), so repeated traces reuse the native row metadata.

    A second, content-keyed cache (attached by the genotyper as
    `_inst_content_cache`, shared across a locus's haplotype rebuilds)
    lets the adaptive rounds reuse instances whose realized sequences are
    unchanged — the per-instance native metadata is the expensive part."""
    cache = getattr(haplotype, "_inst_cache", None)
    if cache is None:
        cache = haplotype._inst_cache = {}
    fw = cache.get((h, False))
    rev = cache.get((h, True))
    if fw is not None and rev is not None:
        return fw, rev
    content = getattr(haplotype, "_inst_content_cache", None)
    if content is not None:
        digits = haplotype.digits(h)
        key = tuple(
            (b.get_seq(d), b.start,
             id(b.repeat_info.stutter_model) if b.repeat_info else None)
            for b, d in zip(haplotype.blocks, digits))
        pair = content.get(key)
        if pair is None:
            pair = (HaplotypeInstance(haplotype, h, reverse=False),
                    HaplotypeInstance(haplotype, h, reverse=True))
            content[key] = pair
        cache[(h, False)], cache[(h, True)] = pair
        return pair
    if fw is None:
        fw = cache[(h, False)] = HaplotypeInstance(haplotype, h, reverse=False)
    if rev is None:
        rev = cache[(h, True)] = HaplotypeInstance(haplotype, h, reverse=True)
    return fw, rev


def _assemble_native(haplotype: Haplotype, h: int, aln: Alignment,
                     seed_base: int, hap_info: HapAlignInfo,
                     fw: HaplotypeInstance, rev: HaplotypeInstance,
                     res, stitch_sink=None) -> Tuple[float, AlignmentTrace]:
    """Build the (LL, AlignmentTrace) from one native trace result
    (hmm_trace_full / hmm_trace_batch layout).

    With `stitch_sink` (a list), the read->reference stitch is DEFERRED:
    the job inputs are appended to the sink and `trace.traced_aln` is left
    None for the caller to fill from one batched native stitch call."""
    seq = aln.sequence
    trace = AlignmentTrace(fw.num_blocks())
    LL, max_index, left_res, right_res = res
    if left_res is None:
        left_aln = "S" * seed_base
    else:
        left_aln = _apply_walk_events(fw, trace, left_res)
    left_aln = left_aln[::-1]
    assert len(left_aln) - left_aln.count("D") == seed_base

    fw_block, _fw_coord = fw.get_coordinates(max_index)
    if not fw.blocks[fw_block].is_stutter:
        trace.add_flank_data(fw_block, seq[seed_base])

    rlen = len(seq) - 1 - seed_base
    if right_res is None:
        right_aln = "S" * rlen
    else:
        right_aln = _apply_walk_events(rev, trace, right_res)
    assert len(right_aln) - right_aln.count("D") == rlen

    read_aln_to_hap = left_aln + "M" + right_aln
    trace.hap_aln = read_aln_to_hap
    if stitch_sink is not None:
        stitch_sink.append((trace, h, read_aln_to_hap, max_index,
                            seed_base, aln))
        return LL, trace
    trace.traced_aln = stitch_alignment_trace(
        haplotype.blocks[0].start, hap_info.aln_info(h),
        read_aln_to_hap, max_index, seed_base, aln)
    return LL, trace


def trace_threads() -> int:
    """Threads for the native trace batch.  Deterministic at any count
    (jobs write disjoint output slots); HIPSTR_TRACE_THREADS overrides —
    the worker pool pins 1 per worker process to avoid oversubscription."""
    import os
    v = os.environ.get("HIPSTR_TRACE_THREADS")
    if v:
        try:
            return max(1, int(v))
        except ValueError:
            pass
    # honor CPU affinity / cgroup quotas where exposed (a containerized or
    # taskset-restricted run sees fewer usable cores than os.cpu_count())
    try:
        n_cores = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        n_cores = os.cpu_count() or 1
    return min(4, n_cores)


def trace_batch(haplotype: Haplotype, jobs, hap_info: HapAlignInfo,
                n_threads: int = 0):
    """Run many traces of one locus through ONE native FFI call.

    `jobs` is a list of (h, pooled_aln, seed_base, blw, blc).  Returns a
    list of (LL, AlignmentTrace) in job order — jobs the C side rejects
    fall back to trace_optimal_aln individually — or None when the native
    batched entry is unavailable (caller loops trace_optimal_aln).
    """
    from .. import native as _native
    if not jobs or not _native.available():
        return None
    from .hmm_reference import seed_meta as _seed_meta
    njobs = []
    insts = []
    for h, aln, seed_base, blw, blc in jobs:
        fw, rev = _instances_for(haplotype, h)
        mid_rows, mid_chars, slp, first_code, last_code = _seed_meta(fw)
        codes = getattr(aln, "_codes_np", None)
        if codes is None:
            codes = np.frombuffer(aln.sequence.encode("latin1"),
                                  dtype=np.uint8)
            aln._codes_np = codes
        njobs.append((codes,
                      np.ascontiguousarray(blw, dtype=np.float64),
                      np.ascontiguousarray(blc, dtype=np.float64),
                      seed_base, fw, rev, mid_rows, mid_chars, slp,
                      first_code, last_code))
        insts.append((fw, rev))
    res_list = _native.hmm_trace_batch_native(
        njobs, MIN_SNP_LOG_PROB_CORRECT, TRACE_LL_TOL,
        n_threads or trace_threads())
    if res_list is None:
        return None
    out = []
    # always defer the stitches: _stitch_deferred batches them in one
    # native call and falls back per job when the entry is unavailable
    sink = []
    for (h, aln, seed_base, blw, blc), (fw, rev), res in zip(jobs, insts,
                                                             res_list):
        if res is None:
            out.append(trace_optimal_aln(haplotype, h, aln, seed_base,
                                         blw, blc, hap_info))
        else:
            out.append(_assemble_native(haplotype, h, aln, seed_base,
                                        hap_info, fw, rev, res,
                                        stitch_sink=sink))
    if sink:
        _stitch_deferred(haplotype, hap_info, sink)
    return out


def _stitch_deferred(haplotype: Haplotype, hap_info: HapAlignInfo,
                     sink) -> None:
    """Resolve deferred read->reference stitches with ONE native call
    (semantics of stitch_alignment_trace per job; C-rejected jobs fall
    back to the per-job path)."""
    from .. import native as _native
    hap_start = haplotype.blocks[0].start
    sjobs = []
    for trace, h, read_aln, max_index, seed_base, aln in sink:
        sjobs.append((hap_info.aln_info_bytes(h),
                      read_aln.encode("latin1"), hap_start, max_index,
                      seed_base, aln.sequence.encode("latin1")))
    results = _native.stitch_trace_batch_native(sjobs)
    for (trace, h, read_aln, max_index, seed_base, aln), res in zip(
            sink, results if results is not None else [None] * len(sink)):
        if res is None:
            # the batch entry already rejected this job; skip the identical
            # single-call native retry and go straight to the Python path
            # (which asserts on genuinely invalid op pairings, matching the
            # reference's assertion behavior)
            trace.traced_aln = stitch_alignment_trace(
                hap_start, hap_info.aln_info(h), read_aln, max_index,
                seed_base, aln,
                try_native=results is None)
        else:
            start, stop, cig_ops, cig_num, aligned = res
            new_aln = Alignment(start, stop, False, "TRACE",
                                aln.base_qualities, aln.sequence, aligned)
            new_aln.cigar = [CigarElement(chr(op), int(n))
                             for op, n in zip(cig_ops, cig_num)]
            trace.traced_aln = new_aln


def trace_optimal_aln(haplotype: Haplotype, h: int, aln: Alignment,
                      seed_base: int, blw: np.ndarray, blc: np.ndarray,
                      hap_info: HapAlignInfo) -> Tuple[float, AlignmentTrace]:
    """Align one read against one haplotype with full traceback.

    Port of the retrace branch of HapAligner::process_read
    (HapAligner.cpp:614-691) + trace_optimal_aln (:711-722).
    """
    seq = aln.sequence
    assert 0 < seed_base < len(seq) - 1
    fw, rev = _instances_for(haplotype, h)
    trace = AlignmentTrace(fw.num_blocks())

    # consolidated native path: both fills + seed combine + both walks in
    # ONE FFI call (native/hmm_kernel.cpp hmm_trace_full); python only
    # assembles the AlignmentTrace from the walk event arrays
    from .. import native as _native
    if _native.available():
        from .hmm_reference import seed_meta as _seed_meta
        mid_rows, mid_chars, slp, first_code, last_code = _seed_meta(fw)
        codes = np.frombuffer(seq.encode("latin1"), dtype=np.uint8)
        res = _native.hmm_trace_full_native(
            np.ascontiguousarray(codes),
            np.ascontiguousarray(blw, dtype=np.float64),
            np.ascontiguousarray(blc, dtype=np.float64), seed_base,
            fw, rev, mid_rows, mid_chars, slp, first_code, last_code,
            MIN_SNP_LOG_PROB_CORRECT, TRACE_LL_TOL)
        if res is not None:
            return _assemble_native(haplotype, h, aln, seed_base, hap_info,
                                    fw, rev, res)

    l_seq = seq[:seed_base]
    l_blw, l_blc = blw[:seed_base], blc[:seed_base]
    r_seq = seq[seed_base + 1:][::-1]
    r_blw = blw[seed_base + 1:][::-1].copy()
    r_blc = blc[seed_base + 1:][::-1].copy()

    lM, lI, lD, l_bas, l_bap, l_prob = align_seq_to_hap(fw, l_seq, l_blw, l_blc)
    rM, rI, rD, r_bas, r_bap, r_prob = align_seq_to_hap(rev, r_seq, r_blw, r_blc)

    LL, max_index = compute_aln_logprob(fw, seq, seed_base, blw, blc,
                                        lM, l_prob, rM, r_prob)

    hapsize = fw.cur_size
    # left of seed
    if max_index == 0:
        left_aln = "S" * seed_base
    else:
        fw_block, fw_coord = fw.get_coordinates(max_index)
        row, col = max_index - 1, seed_base - 1
        if fw_coord == 0:
            prev_size = len(fw.blocks[fw_block - 1].seq)
            left_aln = retrace(fw, l_seq, l_blc, seed_base, fw_block - 1,
                               prev_size - 1, row, col, lM, lI, lD,
                               l_bas, l_bap, trace)
        else:
            left_aln = retrace(fw, l_seq, l_blc, seed_base, fw_block,
                               fw_coord - 1, row, col, lM, lI, lD,
                               l_bas, l_bap, trace)
    left_aln = left_aln[::-1]
    assert len(left_aln) - left_aln.count("D") == seed_base

    # seed base contributes to its flank's sequence
    fw_block, fw_coord = fw.get_coordinates(max_index)
    if not fw.blocks[fw_block].is_stutter:
        trace.add_flank_data(fw_block, seq[seed_base])

    # right of seed
    rev_max_index = hapsize - 1 - max_index
    rlen = len(seq) - 1 - seed_base
    if rev_max_index == 0:
        right_aln = "S" * rlen
    else:
        rev_block, rev_coord = rev.get_coordinates(rev_max_index)
        row, col = rev_max_index - 1, rlen - 1
        if rev_coord == 0:
            prev_size = len(rev.blocks[rev_block - 1].seq)
            right_aln = retrace(rev, r_seq, r_blc, rlen, rev_block - 1,
                                prev_size - 1, row, col, rM, rI, rD,
                                r_bas, r_bap, trace)
        else:
            right_aln = retrace(rev, r_seq, r_blc, rlen, rev_block,
                                rev_coord - 1, row, col, rM, rI, rD,
                                r_bas, r_bap, trace)
    assert len(right_aln) - right_aln.count("D") == rlen

    read_aln_to_hap = left_aln + "M" + right_aln
    trace.hap_aln = read_aln_to_hap
    trace.traced_aln = stitch_alignment_trace(
        haplotype.blocks[0].start, hap_info.aln_info(h), read_aln_to_hap,
        max_index, seed_base, aln)
    return LL, trace
