"""Copy of hipstr_tpu/native.py.

ctypes bindings for the native host kernels (native/nw_kernel.cpp).

The port builds the repository's top-level `native/*.cpp` host sources
itself, lazily on first use, with the flags of native/Makefile: one C++
compiler process per source, all at once, then one link, into
`build/hipstr_tpu_torch/native/` (gitignored) under a name keyed by a hash
of the sources and the flags, so a stale build is never loaded.  It neither
runs `make` nor loads native/libhipstr_native.so.  Every entry point has a
pure-Python fallback so the framework stays fully functional without a
toolchain.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_ROOT, "native")
BUILD_DIR = os.path.join(_ROOT, "build", "hipstr_tpu_torch", "native")
# the sources and flags of native/Makefile
SOURCES = ("nw_kernel.cpp", "hmm_kernel.cpp", "bam_filter.cpp", "debruijn.cpp",
           "cram_decode.cpp", "left_align.cpp", "spec_scan.cpp",
           "pair_reads.cpp")
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-march=native",
            "-pthread"]
LDFLAGS = ["-shared", "-lz", "-pthread"]
_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> str:
    """Where the host library is built: keyed by its sources and flags."""
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(_NATIVE_DIR, name), "rb") as fh:
            h.update(name.encode() + fh.read())
    h.update(" ".join(CXXFLAGS + LDFLAGS).encode())
    return os.path.join(BUILD_DIR, f"libhipstr_native-{h.hexdigest()[:16]}.so")


def _build(so: str) -> None:
    """Compile every source at once, link, and move the library into place;
    a file lock lets one process build while the others wait."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(so):
            return
        cxx = os.environ.get("CXX", "g++")
        tmp = f"{so}.{os.getpid()}"

        def compile_one(name):
            obj = f"{tmp}.{name}.o"
            subprocess.run([cxx, *CXXFLAGS, "-c",
                            os.path.join(_NATIVE_DIR, name), "-o", obj],
                           check=True, capture_output=True, timeout=300)
            return obj

        with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
            objs = list(pool.map(compile_one, SOURCES))
        try:
            subprocess.run([cxx, *objs, "-o", tmp, *LDFLAGS], check=True,
                           capture_output=True, timeout=300)
            os.replace(tmp, so)
        finally:
            for obj in objs:
                os.remove(obj)


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("HIPSTR_TPU_NO_NATIVE"):
            return None
        so = library_path()
        if not os.path.exists(so):
            try:
                _build(so)
            except Exception:
                return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        lib.nw_align.restype = ctypes.c_float
        lib.nw_align.argtypes = [
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32)]
        lib.bgzf_inflate_all.restype = ctypes.c_int64
        lib.bgzf_inflate_all.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
        vp = ctypes.c_void_p
        lib.hmm_fill_dp.restype = ctypes.c_int32
        # raw data pointers: cheaper per call than typed POINTER casts, and
        # the meta pointer block is cached per haplotype instance
        lib.hmm_fill_dp.argtypes = [
            vp, ctypes.c_int32, vp, vp,                            # seq,L,blw,blc
            ctypes.c_int32, ctypes.c_int32,                        # H, n_blocks
            vp, vp, vp,                                            # row meta
            ctypes.c_int32,                                        # n_st
            vp, vp, vp, vp, vp, vp, vp, vp, vp,                    # st tables
            vp, vp, vp, vp,                                        # nD/art_off/art/lpmf
            vp, vp, vp,                                            # m2m/m2i/m2d
            ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double,                      # i2i,i2m,d2d,d2m
            vp, vp, vp, vp, vp, vp]                                # outputs
        vp2 = ctypes.c_void_p
        lib.hmm_retrace_walk.restype = ctypes.c_int32
        lib.hmm_retrace_walk.argtypes = (
            [vp2, ctypes.c_int32, vp2,                       # seq, seg_len, blc
             ctypes.c_int32, vp2, vp2, vp2, vp2, vp2, vp2, vp2,  # blocks+homop
             ctypes.c_int32,                                 # reversed
             ctypes.c_int32, ctypes.c_int32,
             ctypes.c_int32, ctypes.c_int32,                 # start state
             vp2, vp2, vp2, ctypes.c_int32,                  # M I D Lcols
             vp2, vp2,                                       # bas bap
             vp2, vp2, vp2,                                  # m2m m2i m2d
             ctypes.c_double, ctypes.c_double,
             ctypes.c_double, ctypes.c_double,               # i2i i2m d2d d2m
             ctypes.c_double, ctypes.c_double]               # min_snp, tol
            + [vp2] * 16)
        try:
            lib.hmm_trace_full.restype = ctypes.c_int32
            lib.hmm_trace_full.argtypes = (
                [vp2, ctypes.c_int32, vp2, vp2, ctypes.c_int32]  # seq,L,blw,blc,seed
                + [ctypes.c_void_p] * 4                          # fill/walk structs
                + [vp2, vp2, ctypes.c_int32,                     # mid rows/chars/n
                   ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
                   ctypes.c_double, ctypes.c_double,             # snp/tol
                   ctypes.c_void_p, ctypes.c_void_p,             # max_index, LL
                   ctypes.c_void_p, ctypes.c_void_p,             # left valid/out
                   ctypes.c_void_p, ctypes.c_void_p])            # right valid/out
        except AttributeError:
            pass  # stale library without the consolidated entry
        try:
            lib.hmm_trace_batch.restype = ctypes.c_int32
            lib.hmm_trace_batch.argtypes = (
                [ctypes.c_int32]
                + [ctypes.c_void_p] * 4 + [ctypes.c_void_p]   # seq,L,blw,blc,seed
                + [ctypes.c_void_p] * 4                       # fill/walk ptr arrays
                + [ctypes.c_void_p] * 3                       # mids
                + [ctypes.c_void_p] * 3                       # slp, first, last
                + [ctypes.c_double, ctypes.c_double, ctypes.c_int32]
                + [ctypes.c_void_p] * 4                       # LL,max,rc,valid
                + [ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p]  # aln
                + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32]  # frags
                + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int32]                            # str
                + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
                   ctypes.c_void_p]                           # snps
                + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
                   ctypes.c_void_p]                           # indels
                + [ctypes.c_void_p, ctypes.c_void_p])         # flanks
        except AttributeError:
            pass  # stale library without the batched entry
        try:
            lib.hmm_trace_summary_batch.restype = ctypes.c_int32
            lib.hmm_trace_summary_batch.argtypes = (
                [ctypes.c_int32]
                + [ctypes.c_void_p] * 5                       # seq,L,blw,blc,seed
                + [ctypes.c_void_p] * 4                       # fill/walk ptr arrays
                + [ctypes.c_void_p] * 3                       # mids
                + [ctypes.c_void_p] * 3                       # slp, first, last
                + [ctypes.c_void_p] * 3                       # hap aln/len/start
                + [ctypes.c_double, ctypes.c_double, ctypes.c_int32]
                + [ctypes.c_void_p] * 3                       # rc, LL, max
                + [ctypes.c_void_p] * 2                       # start/stop
                + [ctypes.c_void_p] * 2                       # flank ins/del
                + [ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p]  # stutter
                + [ctypes.c_int32] + [ctypes.c_void_p] * 3    # str pool/off/len
                + [ctypes.c_int32] + [ctypes.c_void_p] * 3    # flank pool/off/len
                + [ctypes.c_int32] + [ctypes.c_void_p] * 5)   # cigar + aligned
        except AttributeError:
            pass  # stale library without the summary entry
        try:
            lib.bam_filter_batch.restype = ctypes.c_int32
            lib.bam_filter_batch.argtypes = (
                [ctypes.c_char_p, ctypes.c_int64,          # blob
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,  # offs
                 ctypes.c_int64, ctypes.c_int64,           # fetch window
                 ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,    # region
                 ctypes.c_int32,                           # qual trim
                 ctypes.c_int64, ctypes.c_int64,           # trim2 window
                 ctypes.c_char_p, ctypes.c_int64]          # chrom seq
                + [ctypes.c_int32] * 5                     # filter consts
                + [ctypes.c_char_p] * 8                    # adapters
                + [ctypes.c_int32, ctypes.c_int32, ctypes.c_double]
                + [ctypes.c_int32, ctypes.c_int32]         # strides
                + [ctypes.c_void_p] * 47)                  # outputs + qsum
        except AttributeError:
            pass  # stale library without the filter entry
        try:
            lib.convert_aln_batch.restype = ctypes.c_int32
            lib.convert_aln_batch.argtypes = (
                [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
                 ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,  # seqs
                 ctypes.c_void_p,                                    # pos
                 ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,  # cigars
                 ctypes.c_void_p]
                + [ctypes.c_void_p] * 10)                  # outputs
        except AttributeError:
            pass  # stale library without the convert entry
        try:
            lib.spec_scan.restype = ctypes.c_int32
            lib.spec_scan.argtypes = (
                [ctypes.c_int32, ctypes.c_int32,            # P, S
                 ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,  # seqs
                 ctypes.c_void_p, ctypes.c_void_p,          # start/stop
                 ctypes.c_char_p, ctypes.c_void_p,          # cigars
                 ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p,                           # ps_counts
                 ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p,                           # repeat blocks
                 ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p,          # repeat options
                 ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_char_p, ctypes.c_void_p,          # flank blocks
                 ctypes.c_void_p, ctypes.c_int64,           # out pool/cap
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p,                           # blk/off/len/sup
                 ctypes.c_int32, ctypes.c_void_p])          # max, cnt
        except AttributeError:
            pass  # stale library without the spec-scan entry
        try:
            lib.pair_filter_batch.restype = ctypes.c_int32
            lib.pair_filter_batch.argtypes = (
                [ctypes.c_char_p, ctypes.c_int32]
                + [ctypes.c_void_p] * 16                   # record columns
                + [ctypes.c_char_p, ctypes.c_int32]        # chrom
                + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int32]
                + [ctypes.c_void_p] * 6)                   # outputs
        except AttributeError:
            pass  # stale library without the pairing entry
        try:
            lib.split_bam_records.restype = ctypes.c_int64
            lib.split_bam_records.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64)]
        except AttributeError:
            pass  # stale library without the splitter entry
        try:
            lib.seed_scan.restype = ctypes.c_int32
            lib.seed_scan.argtypes = (
                [ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p,
                 ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                 ctypes.c_void_p])
        except AttributeError:
            pass  # stale library without the seed entry
        try:
            lib.flank_assembly_batch.restype = ctypes.c_int32
            lib.flank_assembly_batch.argtypes = (
                [ctypes.c_char_p, ctypes.c_int32,          # ref seq
                 ctypes.c_int32, ctypes.c_int32,           # min_k, max_k
                 ctypes.c_int32,                           # n_samples
                 ctypes.c_char_p,                          # strings blob
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_int64,                           # n_strings
                 ctypes.c_void_p,                          # call_skip
                 ctypes.c_double, ctypes.c_int32,          # prune
                 ctypes.c_int32, ctypes.c_int32,           # paths
                 ctypes.c_int64]                           # seq_stride
                + [ctypes.c_void_p] * 6)                   # outputs
        except AttributeError:
            pass  # stale library without the assembly entry
        try:
            lib.cram_decode_container.restype = ctypes.c_int64
            lib.cram_decode_container.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,            # container body
                ctypes.c_int32, ctypes.c_int32,             # n_blocks, ver
                ctypes.c_char_p, ctypes.c_void_p,           # refs blob/offs
                ctypes.c_void_p, ctypes.c_int32,            # refs avail/n
                ctypes.c_char_p, ctypes.c_void_p,           # rg blob/offs
                ctypes.c_int32,                             # n_rg
                ctypes.c_void_p, ctypes.c_int64,            # out blob, cap
                ctypes.c_void_p, ctypes.c_void_p,           # out offs/lens
                ctypes.c_int32, ctypes.c_void_p]            # max_recs, n_out
        except AttributeError:
            pass  # stale library without the cram entry
        lib.stitch_ops.restype = ctypes.c_int32
        lib.stitch_ops.argtypes = [
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_char_p]
        try:
            lib.stitch_trace.restype = ctypes.c_int32
            lib.stitch_trace.argtypes = [
                ctypes.c_char_p, ctypes.c_int32,      # hap_aln
                ctypes.c_char_p, ctypes.c_int32,      # read_aln
                ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_char_p, ctypes.c_int32,      # bases
                ctypes.c_void_p, ctypes.c_void_p,     # start/stop
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # cigar
                ctypes.c_char_p, ctypes.c_void_p]     # aligned string
        except AttributeError:
            pass  # stale library without the full-stitch entry
        try:
            lib.stitch_trace_batch.restype = ctypes.c_int32
            lib.stitch_trace_batch.argtypes = [
                ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_void_p,     # hap_aln ptrs/lens
                ctypes.c_void_p, ctypes.c_void_p,     # read_aln ptrs/lens
                ctypes.c_void_p, ctypes.c_void_p,     # hap_start, hap_index
                ctypes.c_void_p,                      # seed_base
                ctypes.c_void_p, ctypes.c_void_p,     # bases ptrs/lens
                ctypes.c_int32,                       # stride
                ctypes.c_void_p, ctypes.c_void_p,     # start/stop
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # cigar
                ctypes.c_void_p, ctypes.c_void_p,     # aligned string
                ctypes.c_void_p]                      # rc
        except AttributeError:
            pass  # stale library without the batched-stitch entry
        for fn in (lib.prefix_match_counts, lib.suffix_match_counts):
            fn.restype = None
            fn.argtypes = [ctypes.c_char_p, ctypes.c_int32, ctypes.c_char_p,
                           ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                           ctypes.c_void_p]
        for fn in (lib.adapter_trim_3p, lib.adapter_trim_5p):
            fn.restype = ctypes.c_int32
            fn.argtypes = [ctypes.c_char_p, ctypes.c_int32, ctypes.c_char_p,
                           ctypes.POINTER(ctypes.c_int32),
                           ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                           ctypes.c_int32, ctypes.c_double]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def nw_align_native(ref_seq: str, read_seq: str,
                    use_ref_end_penalty: bool
                    ) -> Optional[Tuple[str, str, float]]:
    """Returns (ref_al, read_al, score) or None when the library is absent."""
    lib = _load()
    if lib is None:
        return None
    cap = len(ref_seq) + len(read_seq) + 2
    ra = ctypes.create_string_buffer(cap)
    qa = ctypes.create_string_buffer(cap)
    out_len = ctypes.c_int32(0)
    score = lib.nw_align(ref_seq.encode("latin1"), len(ref_seq),
                         read_seq.encode("latin1"), len(read_seq),
                         1 if use_ref_end_penalty else 0, ra, qa,
                         ctypes.byref(out_len))
    n = out_len.value
    return (ra.raw[:n].decode("latin1"), qa.raw[:n].decode("latin1"),
            float(score))


def split_bam_records_native(data):
    """Split decompressed BAM bytes into record bodies (native
    split_bam_records).  Returns (n, tail_need, offs, lens): n >= 0 on
    success; n < 0 with tail_need > 0 when the final record extends past
    the buffer (caller appends the tail and retries); None to fall back."""
    lib = _load()
    if lib is None or not hasattr(lib, "split_bam_records"):
        return None
    import numpy as np
    ln = len(data)
    if ln == 0:
        return 0, 0, np.empty(0, np.int64), np.empty(0, np.int32)
    cap = ln // 36 + 8            # a record consumes >= 4 + 32 bytes
    offs = np.empty(cap, np.int64)
    lens = np.empty(cap, np.int32)
    tail = ctypes.c_int64(0)
    buf = np.frombuffer(data, np.uint8)
    n = lib.split_bam_records(buf.ctypes.data, ln, offs.ctypes.data,
                              lens.ctypes.data, cap, ctypes.byref(tail))
    if n < 0 and tail.value == 0:
        return None               # capacity overflow: python fallback
    return int(n), int(tail.value), offs, lens


def pair_filter_batch_native(blob: bytes, o, pass_one, chrom: str,
                             max_mate_dist: int, max_reads: int,
                             use_unpaired: bool):
    """Mate-pair one locus's cascade output in C++ (native/pair_reads.cpp;
    semantics fast_filter.py pairing loop + processor._valid_pairing,
    reference src/bam_processor.cpp:97-152,303-437).  Returns (pair_str,
    pair_mate, unpaired, too_many) row-index arrays or None."""
    lib = _load()
    if lib is None or not hasattr(lib, "pair_filter_batch"):
        return None
    import numpy as np
    n = len(o["status"])
    p1 = np.ascontiguousarray(pass_one, np.uint8)
    pair_str = np.empty(n, np.int32)
    pair_mate = np.empty(n, np.int32)
    unpaired = np.empty(n, np.int32)
    n_pairs = ctypes.c_int32(0)
    n_unp = ctypes.c_int32(0)
    too_many = np.zeros(1, np.uint8)
    rc = lib.pair_filter_batch(
        blob, n,
        o["name_off"].ctypes.data, o["name_len"].ctypes.data,
        o["status"].ctypes.data, o["overlaps"].ctypes.data,
        p1.ctypes.data, o["flag"].ctypes.data,
        o["pos"].ctypes.data, o["orig_pos"].ctypes.data,
        o["xa_off"].ctypes.data, o["xa_len"].ctypes.data,
        o["sa_off"].ctypes.data, o["sa_len"].ctypes.data,
        o["as_val"].ctypes.data, o["as_has"].ctypes.data,
        o["xs_val"].ctypes.data, o["xs_has"].ctypes.data,
        chrom.encode("latin1"), len(chrom),
        int(max_mate_dist), int(max_reads), 1 if use_unpaired else 0,
        pair_str.ctypes.data, pair_mate.ctypes.data, ctypes.byref(n_pairs),
        unpaired.ctypes.data, ctypes.byref(n_unp), too_many.ctypes.data)
    if rc != 0:
        return None
    return (pair_str[:n_pairs.value], pair_mate[:n_pairs.value],
            unpaired[:n_unp.value], bool(too_many[0]))


def convert_aln_batch_native(chrom_seq_b: bytes, reads):
    """Batch convertAlignment for reference-matching reads
    (native/left_align.cpp; semantics align/realign.py:convert_alignment,
    reference src/SeqAlignment/AlignmentOps.cpp:102-167).

    `reads` is a list of (pos, bases, cigar) with cigar a list of (n, op).
    Returns a list of (stop, aln_str, [(op, n), ...]) or None when the
    native entry is unavailable/overflowed (callers fall back per read).
    """
    lib = _load()
    if lib is None or not hasattr(lib, "convert_aln_batch"):
        return None
    import numpy as np
    n = len(reads)
    if n == 0:
        return []
    seq_parts = []
    seq_off = np.empty(n, np.int64)
    seq_len = np.empty(n, np.int32)
    pos_a = np.empty(n, np.int64)
    cig_off = np.empty(n, np.int64)
    cig_cnt = np.empty(n, np.int32)
    aln_off = np.empty(n, np.int64)
    oc_cap = np.empty(n, np.int32)
    oc_off = np.empty(n, np.int64)
    ops_parts = []
    lens_all = []
    so = co = ao = oo = 0
    for i, (pos, bases, cigar) in enumerate(reads):
        b = bases.encode("latin1")
        seq_parts.append(b)
        seq_off[i] = so
        seq_len[i] = len(b)
        so += len(b)
        pos_a[i] = pos
        cig_off[i] = co
        cig_cnt[i] = len(cigar)
        co += len(cigar)
        acap = 0
        for num, op in cigar:
            ops_parts.append(op)
            lens_all.append(num)
            if op not in "SH":
                acap += num
        aln_off[i] = ao
        ao += acap
        cap = acap + len(cigar) + 1
        oc_cap[i] = cap
        oc_off[i] = oo
        oo += cap
    seq_pool = b"".join(seq_parts)
    cig_ops = "".join(ops_parts).encode("latin1")
    cig_lens = np.asarray(lens_all, np.int32)
    out_stop = np.empty(n, np.int64)
    aln_pool = np.empty(max(ao, 1), np.uint8)
    aln_len = np.empty(n, np.int32)
    oc_ops = np.empty(max(oo, 1), np.uint8)
    oc_lens = np.empty(max(oo, 1), np.int32)
    oc_cnt = np.empty(n, np.int32)
    ok = np.empty(n, np.uint8)
    rc = lib.convert_aln_batch(
        chrom_seq_b, len(chrom_seq_b), n,
        seq_pool, seq_off.ctypes.data, seq_len.ctypes.data,
        pos_a.ctypes.data, cig_ops, cig_lens.ctypes.data,
        cig_off.ctypes.data, cig_cnt.ctypes.data,
        out_stop.ctypes.data, aln_pool.ctypes.data, aln_off.ctypes.data,
        aln_len.ctypes.data, oc_ops.ctypes.data, oc_lens.ctypes.data,
        oc_off.ctypes.data, oc_cap.ctypes.data, oc_cnt.ctypes.data,
        ok.ctypes.data)
    if rc != 0 or not ok.all():
        return None
    aln_all = aln_pool.tobytes().decode("latin1")
    ops_all = oc_ops.tobytes().decode("latin1")
    lens_l = oc_lens.tolist()
    stops = out_stop.tolist()
    alens = aln_len.tolist()
    aoffs = aln_off.tolist()
    ooffs = oc_off.tolist()
    cnts = oc_cnt.tolist()
    res = []
    for i in range(n):
        a0 = aoffs[i]
        o0 = ooffs[i]
        cig = [(ops_all[o0 + k], lens_l[o0 + k]) for k in range(cnts[i])]
        res.append((stops[i], aln_all[a0:a0 + alens[i]], cig))
    return res


def pool_columns(pooled):
    """Columnar marshal of pooled Alignment-like objects (one per locus,
    cached by the genotyper; shared by spec_scan/seed_scan)."""
    import numpy as np
    P = len(pooled)
    seq_parts = []
    seq_off = np.empty(P, np.int64)
    seq_len = np.empty(P, np.int32)
    p_start = np.empty(P, np.int64)
    p_stop = np.empty(P, np.int64)
    cig_off = np.empty(P, np.int64)
    cig_cnt = np.empty(P, np.int32)
    ops_parts = []
    lens_all = []
    so = co = 0
    for i, a in enumerate(pooled):
        b = a.sequence.encode("latin1")
        seq_parts.append(b)
        seq_off[i] = so
        seq_len[i] = len(b)
        so += len(b)
        p_start[i] = a.start
        p_stop[i] = a.stop
        cig = a.cigar
        cig_off[i] = co
        cig_cnt[i] = len(cig)
        co += len(cig)
        for el in cig:
            ops_parts.append(el.type)
            lens_all.append(el.num)
    return dict(P=P, seq_pool=b"".join(seq_parts), seq_off=seq_off,
                seq_len=seq_len, p_start=p_start, p_stop=p_stop,
                cig_ops="".join(ops_parts).encode("latin1"),
                cig_lens=np.asarray(lens_all, np.int32),
                cig_off=cig_off, cig_cnt=cig_cnt)


def seed_scan_native(cols, rep_starts, rep_ends, hap_start, hap_end,
                     min_seed_dist):
    """Batched seed-base selection (native seed_scan; semantics
    pipeline/genotyper.py calc_seed_base, reference HapAligner.cpp:238-318).
    Returns int64 seeds per pool (-2 invalid-seed, -3 bad CIGAR) or None."""
    lib = _load()
    if lib is None or not hasattr(lib, "seed_scan"):
        return None
    import numpy as np
    P = cols["P"]
    seeds = np.empty(P, np.int64)
    if P == 0:
        return seeds
    rs = np.asarray(rep_starts, np.int64)
    re_ = np.asarray(rep_ends, np.int64)
    rc = lib.seed_scan(
        P, cols["p_start"].ctypes.data, cols["seq_len"].ctypes.data,
        cols["cig_ops"], cols["cig_lens"].ctypes.data,
        cols["cig_off"].ctypes.data, cols["cig_cnt"].ctypes.data,
        len(rs), rs.ctypes.data, re_.ctypes.data,
        int(hap_start), int(hap_end), int(min_seed_dist),
        seeds.ctypes.data)
    if rc != 0:
        return None
    return seeds


def spec_scan_native(cols, ps_counts, repeat_blocks, flank_blocks):
    """One native call for a locus's speculative-candidate predictors
    (native/spec_scan.cpp; semantics pipeline/genotyper.py
    _build_speculative_haplotype/_predict_flank_candidates).

    cols: pool_columns() marshal of the pooled reads;
    ps_counts: [P, S] per-pool per-sample read weights;
    repeat_blocks: list of (block_index, start, end, period, option_seqs);
    flank_blocks: list of (block_index, start, ref_seq).

    Returns ({block_index: {cand: support}}, {block_index: {...}}) or None.
    """
    lib = _load()
    if lib is None or not hasattr(lib, "spec_scan"):
        return None
    import numpy as np
    P = cols["P"]
    S = ps_counts.shape[1] if P else 0
    if P == 0 or (not repeat_blocks and not flank_blocks):
        return {}, {}
    seq_pool = cols["seq_pool"]
    seq_off = cols["seq_off"]
    seq_len = cols["seq_len"]
    p_start = cols["p_start"]
    p_stop = cols["p_stop"]
    cig_ops = cols["cig_ops"]
    cig_lens = cols["cig_lens"]
    cig_off = cols["cig_off"]
    cig_cnt = cols["cig_cnt"]
    ps = np.ascontiguousarray(ps_counts, np.int64)

    NRB = len(repeat_blocks)
    rb_start = np.empty(max(NRB, 1), np.int64)
    rb_end = np.empty(max(NRB, 1), np.int64)
    rb_period = np.empty(max(NRB, 1), np.int32)
    rb_first = np.empty(max(NRB, 1), np.int32)
    opt_parts = []
    opt_off_l = []
    opt_len_l = []
    rb_cnt = np.empty(max(NRB, 1), np.int32)
    oo = 0
    for r, (_bi, start, end, period, seqs) in enumerate(repeat_blocks):
        rb_start[r] = start
        rb_end[r] = end
        rb_period[r] = period
        rb_first[r] = len(opt_off_l)
        rb_cnt[r] = len(seqs)
        for s in seqs:
            sb = s.encode("latin1")
            opt_parts.append(sb)
            opt_off_l.append(oo)
            opt_len_l.append(len(sb))
            oo += len(sb)
    rb_opts_pool = b"".join(opt_parts)
    rb_opt_off = np.asarray(opt_off_l or [0], np.int64)
    rb_opt_len = np.asarray(opt_len_l or [0], np.int32)

    NFB = len(flank_blocks)
    fb_start = np.empty(max(NFB, 1), np.int64)
    fb_len = np.empty(max(NFB, 1), np.int32)
    fb_parts = []
    fb_off = np.empty(max(NFB, 1), np.int64)
    fo = 0
    for f, (_bi, start, ref_seq) in enumerate(flank_blocks):
        fb_start[f] = start
        fb_len[f] = len(ref_seq)
        fb_parts.append(ref_seq.encode("latin1"))
        fb_off[f] = fo
        fo += len(ref_seq)
    fb_ref_pool = b"".join(fb_parts)

    out_max = 512
    out_pool = np.empty(1 << 18, np.uint8)
    out_blk = np.empty(out_max, np.int32)
    out_off = np.empty(out_max, np.int64)
    out_len = np.empty(out_max, np.int32)
    out_sup = np.empty(out_max, np.int64)
    out_cnt = ctypes.c_int32(0)
    rc = lib.spec_scan(
        P, S, seq_pool, seq_off.ctypes.data, seq_len.ctypes.data,
        p_start.ctypes.data, p_stop.ctypes.data,
        cig_ops, cig_lens.ctypes.data, cig_off.ctypes.data,
        cig_cnt.ctypes.data, ps.ctypes.data,
        NRB, rb_start.ctypes.data, rb_end.ctypes.data, rb_period.ctypes.data,
        rb_opts_pool, rb_opt_off.ctypes.data, rb_opt_len.ctypes.data,
        rb_first.ctypes.data, rb_cnt.ctypes.data,
        NFB, fb_start.ctypes.data, fb_len.ctypes.data,
        fb_ref_pool, fb_off.ctypes.data,
        out_pool.ctypes.data, out_pool.size,
        out_blk.ctypes.data, out_off.ctypes.data, out_len.ctypes.data,
        out_sup.ctypes.data, out_max, ctypes.byref(out_cnt))
    if rc != 0:
        return None
    n = out_cnt.value
    pool_s = out_pool[:int(out_off[n - 1] + out_len[n - 1])].tobytes() \
        .decode("latin1") if n else ""
    rep_support = {bi: {} for (bi, *_rest) in repeat_blocks}
    flank_support = {bi: {} for (bi, *_rest) in flank_blocks}
    blks = out_blk[:n].tolist()
    offs = out_off[:n].tolist()
    lens = out_len[:n].tolist()
    sups = out_sup[:n].tolist()
    for k in range(n):
        cand = pool_s[offs[k]:offs[k] + lens[k]]
        slot = blks[k]
        if slot < NRB:
            rep_support[repeat_blocks[slot][0]][cand] = sups[k]
        else:
            flank_support[flank_blocks[slot - NRB][0]][cand] = sups[k]
    return rep_support, flank_support


def hmm_fill_dp_native(seq_codes, blw, blc, meta, match, insert, delete,
                       best_art_size, best_art_pos):
    """Fill the per-(read, haplotype) DP matrices in C++.

    `meta` is the flat row/stutter metadata tuple built by
    align.hmm_reference.HaplotypeInstance.native_meta().  Returns left_prob
    or None when the library is absent.
    """
    lib = _load()
    if lib is None:
        return None
    # meta[-1] is the precomputed pointer/scalar argument block; the arrays
    # it points into are owned by the same meta tuple, so the raw addresses
    # stay valid for its lifetime (built in HaplotypeInstance.native_meta)
    out_lp = ctypes.c_double(0.0)
    rc = lib.hmm_fill_dp(
        seq_codes.ctypes.data, len(seq_codes), blw.ctypes.data,
        blc.ctypes.data, *meta[-1],
        match.ctypes.data, insert.ctypes.data, delete.ctypes.data,
        best_art_size.ctypes.data, best_art_pos.ctypes.data,
        ctypes.byref(out_lp))
    if rc != 0:
        return None
    return out_lp.value


def hmm_retrace_walk_native(seq_codes, blc, walk_meta, reversed_flag,
                            block_index, base_index, row, col,
                            M, I, D, bas, bap, min_snp_lpc, tol):
    """C traceback walk; returns the raw event arrays or None.

    walk_meta is HaplotypeInstance.walk_meta(): (n_blocks, bseq_pool,
    blk_off, blk_len, blk_is_stutter, blk_src_start, homop_pool, homop_off,
    m2m, m2i, m2d, i2i, i2m, d2d, d2m, ptr_block).
    """
    lib = _load()
    if lib is None:
        return None
    import numpy as np
    seg_len = len(seq_codes)
    n_rows = M.shape[0]
    cap = n_rows + seg_len + 8
    aln = np.empty(cap, dtype=np.uint8)
    aln_len = ctypes.c_int32(0)
    nb = walk_meta[0]
    frag_block = np.empty(nb + 2, dtype=np.int32)
    frag_end = np.empty(nb + 2, dtype=np.int32)
    n_frags = ctypes.c_int32(0)
    frag_pool = np.empty(seg_len + 2, dtype=np.uint8)
    str_block = np.empty(nb + 1, dtype=np.int32)
    str_size = np.empty(nb + 1, dtype=np.int32)
    str_end = np.empty(nb + 1, dtype=np.int32)
    n_str = ctypes.c_int32(0)
    str_pool = np.empty(seg_len + 2, dtype=np.uint8)
    snp_pos = np.empty(seg_len + 2, dtype=np.int32)
    snp_base = np.empty(seg_len + 2, dtype=np.uint8)
    n_snps = ctypes.c_int32(0)
    indel_pos = np.empty(cap, dtype=np.int64)
    indel_size = np.empty(cap, dtype=np.int64)
    n_indels = ctypes.c_int32(0)
    flank_ins = ctypes.c_int32(0)
    flank_del = ctypes.c_int32(0)
    i2i, i2m, d2d, d2m = walk_meta[11:15]
    rc = lib.hmm_retrace_walk(
        seq_codes.ctypes.data, seg_len, blc.ctypes.data,
        *walk_meta[15],
        int(reversed_flag), block_index, base_index, row, col,
        M.ctypes.data, I.ctypes.data, D.ctypes.data, M.shape[1],
        bas.ctypes.data, bap.ctypes.data,
        walk_meta[8].ctypes.data, walk_meta[9].ctypes.data,
        walk_meta[10].ctypes.data, i2i, i2m, d2d, d2m,
        min_snp_lpc, tol,
        aln.ctypes.data, ctypes.byref(aln_len),
        frag_block.ctypes.data, frag_end.ctypes.data, ctypes.byref(n_frags),
        frag_pool.ctypes.data,
        str_block.ctypes.data, str_size.ctypes.data, str_end.ctypes.data,
        ctypes.byref(n_str), str_pool.ctypes.data,
        snp_pos.ctypes.data, snp_base.ctypes.data, ctypes.byref(n_snps),
        indel_pos.ctypes.data, indel_size.ctypes.data, ctypes.byref(n_indels),
        ctypes.byref(flank_ins), ctypes.byref(flank_del))
    if rc != 0:
        return None
    return (aln[:aln_len.value], frag_block[:n_frags.value],
            frag_end[:n_frags.value], frag_pool,
            str_block[:n_str.value], str_size[:n_str.value],
            str_end[:n_str.value], str_pool,
            snp_pos[:n_snps.value], snp_base[:n_snps.value],
            indel_pos[:n_indels.value], indel_size[:n_indels.value],
            int(flank_ins.value), int(flank_del.value))


def stitch_ops_native(hap_aln: str, read_aln: str, h_index: int,
                      r_index: int, increment: int):
    """Op-string merge in C; None when unavailable or on bad op pairs."""
    lib = _load()
    if lib is None:
        return None
    cap = len(hap_aln) + len(read_aln) + 2
    out = ctypes.create_string_buffer(cap)
    n = lib.stitch_ops(hap_aln.encode("latin1"), len(hap_aln),
                       read_aln.encode("latin1"), len(read_aln),
                       h_index, r_index, increment, out)
    if n < 0:
        return None
    return out.raw[:n].decode("latin1")


def stitch_trace_native(hap_aln: str, read_aln: str, hap_start: int,
                        hap_index: int, seed_base: int, bases: str):
    """Full trace stitch in C (semantics of traceback.stitch_alignment_trace);
    returns (start, stop, cigar_ops_bytes, cigar_nums, aligned_str) or None
    when the library is absent / the op pairing is invalid."""
    lib = _load()
    if lib is None or not hasattr(lib, "stitch_trace"):
        return None
    import numpy as np
    cap = len(hap_aln) + len(read_aln) + 2
    start = ctypes.c_int64(0)
    stop = ctypes.c_int64(0)
    cig_ops = ctypes.create_string_buffer(cap)
    cig_num = np.empty(cap, dtype=np.int32)
    n_cig = ctypes.c_int32(0)
    aln_out = ctypes.create_string_buffer(cap)
    aln_len = ctypes.c_int32(0)
    rc = lib.stitch_trace(
        hap_aln.encode("latin1"), len(hap_aln),
        read_aln.encode("latin1"), len(read_aln),
        hap_start, hap_index, seed_base,
        bases.encode("latin1"), len(bases),
        ctypes.byref(start), ctypes.byref(stop),
        cig_ops, cig_num.ctypes.data, ctypes.byref(n_cig),
        aln_out, ctypes.byref(aln_len))
    if rc != 0:
        return None
    nc = n_cig.value
    return (int(start.value), int(stop.value), cig_ops.raw[:nc],
            cig_num[:nc], aln_out.raw[:aln_len.value].decode("latin1"))


def stitch_trace_batch_native(jobs):
    """N full trace stitches in ONE FFI call (native stitch_trace_batch).

    Each job is (hap_aln_bytes, read_aln_bytes, hap_start, hap_index,
    seed_base, bases_bytes).  Returns a list with one
    (start, stop, cigar_ops_bytes, cigar_nums, aligned_str) per job
    (None where the C side rejected the op pairing), or None when the
    library lacks the entry.
    """
    lib = _load()
    if lib is None or not hasattr(lib, "stitch_trace_batch"):
        return None
    import numpy as np
    n = len(jobs)
    if n == 0:
        return []
    VP = ctypes.c_void_p * n
    hap_p, read_p, bases_p = VP(), VP(), VP()
    hap_l = np.empty(n, dtype=np.int32)
    read_l = np.empty(n, dtype=np.int32)
    bases_l = np.empty(n, dtype=np.int32)
    hap_starts = np.empty(n, dtype=np.int64)
    hap_idx = np.empty(n, dtype=np.int32)
    seeds = np.empty(n, dtype=np.int32)
    stride = 0
    for i, (ha, ra, hs, hi_, sb, bs) in enumerate(jobs):
        hap_p[i] = ctypes.cast(ctypes.c_char_p(ha), ctypes.c_void_p)
        read_p[i] = ctypes.cast(ctypes.c_char_p(ra), ctypes.c_void_p)
        bases_p[i] = ctypes.cast(ctypes.c_char_p(bs), ctypes.c_void_p)
        hap_l[i] = len(ha)
        read_l[i] = len(ra)
        bases_l[i] = len(bs)
        hap_starts[i] = hs
        hap_idx[i] = hi_
        seeds[i] = sb
        stride = max(stride, len(ha) + len(ra) + 2)
    out_start = np.empty(n, dtype=np.int64)
    out_stop = np.empty(n, dtype=np.int64)
    cig_ops = np.empty((n, stride), dtype=np.uint8)
    cig_num = np.empty((n, stride), dtype=np.int32)
    n_cig = np.zeros(n, dtype=np.int32)
    aln_pool = np.empty((n, stride), dtype=np.uint8)
    aln_len = np.zeros(n, dtype=np.int32)
    out_rc = np.empty(n, dtype=np.int32)
    lib.stitch_trace_batch(
        n, hap_p, hap_l.ctypes.data, read_p, read_l.ctypes.data,
        hap_starts.ctypes.data, hap_idx.ctypes.data, seeds.ctypes.data,
        bases_p, bases_l.ctypes.data, stride,
        out_start.ctypes.data, out_stop.ctypes.data,
        cig_ops.ctypes.data, cig_num.ctypes.data, n_cig.ctypes.data,
        aln_pool.ctypes.data, aln_len.ctypes.data, out_rc.ctypes.data)
    out = []
    for i in range(n):
        if out_rc[i] != 0:
            out.append(None)
            continue
        nc = int(n_cig[i])
        # copy: cig_num[i, :nc] is a view into the shared (n, stride) pool;
        # a caller holding one result must not pin (or alias) the whole pool
        out.append((int(out_start[i]), int(out_stop[i]),
                    cig_ops[i, :nc].tobytes(), cig_num[i, :nc].copy(),
                    aln_pool[i, :aln_len[i]].tobytes().decode("latin1")))
    return out


def end_match_counts_native(s1: str, s2: str, lo: int, hi: int,
                            suffix: bool):
    """prefix/suffix end-match window scan in C; None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    import numpy as np
    n = hi - lo + 1
    if n <= 0:
        return []
    out = np.empty(n, dtype=np.int32)
    fn = lib.suffix_match_counts if suffix else lib.prefix_match_counts
    fn(s1.encode("latin1"), len(s1), s2.encode("latin1"), len(s2),
       lo, hi, out.ctypes.data)
    return out.tolist()


def adapter_trim_native(bases: str, adapters, min_overlap: int,
                        max_err: float, five_prime: bool) -> Optional[int]:
    """Adapter-overlap search in C; None when the library is absent."""
    lib = _load()
    if lib is None:
        return None
    blob = "".join(adapters).encode("latin1")
    offs = (ctypes.c_int32 * len(adapters))()
    lens = (ctypes.c_int32 * len(adapters))()
    o = 0
    for i, a in enumerate(adapters):
        offs[i] = o
        lens[i] = len(a)
        o += len(a)
    fn = lib.adapter_trim_5p if five_prime else lib.adapter_trim_3p
    return int(fn(bases.encode("latin1"), len(bases), blob, offs, lens,
                  len(adapters), min_overlap, max_err))


def bgzf_inflate_native(data: bytes, expected_cap: int) -> Optional[bytes]:
    lib = _load()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(expected_cap)
    n = lib.bgzf_inflate_all(data, len(data), out, expected_cap)
    if n < 0:
        return None
    return out.raw[:n]


# ---------------------------------------------------------------------------
# consolidated per-trace call (hmm_trace_full): both flank fills, the seed
# combination, and both walks in one FFI round trip.

class _TraceFillArgs(ctypes.Structure):
    _fields_ = [("H", ctypes.c_int32), ("n_blocks", ctypes.c_int32),
                ("row_kind", ctypes.c_void_p), ("row_char", ctypes.c_void_p),
                ("row_homop", ctypes.c_void_p), ("n_st", ctypes.c_int32),
                ("st_row", ctypes.c_void_p), ("st_block", ctypes.c_void_p),
                ("st_seq_pool", ctypes.c_void_p), ("st_off", ctypes.c_void_p),
                ("st_len", ctypes.c_void_p), ("st_period", ctypes.c_void_p),
                ("st_max_ins", ctypes.c_void_p),
                ("st_max_del", ctypes.c_void_p),
                ("st_left_align", ctypes.c_void_p),
                ("st_nD", ctypes.c_void_p), ("st_art_off", ctypes.c_void_p),
                ("art_sizes", ctypes.c_void_p), ("art_lpmf", ctypes.c_void_p),
                ("m2m", ctypes.c_void_p), ("m2i", ctypes.c_void_p),
                ("m2d", ctypes.c_void_p),
                ("i2i", ctypes.c_double), ("i2m", ctypes.c_double),
                ("d2d", ctypes.c_double), ("d2m", ctypes.c_double)]


class _TraceWalkArgs(ctypes.Structure):
    _fields_ = [("n_blocks", ctypes.c_int32),
                ("bseq_pool", ctypes.c_void_p), ("blk_off", ctypes.c_void_p),
                ("blk_len", ctypes.c_void_p),
                ("blk_is_stutter", ctypes.c_void_p),
                ("blk_src_start", ctypes.c_void_p),
                ("homop_pool", ctypes.c_void_p),
                ("homop_off", ctypes.c_void_p)]


class _TraceWalkOut(ctypes.Structure):
    _fields_ = [("aln_out", ctypes.c_void_p), ("aln_len", ctypes.c_void_p),
                ("frag_block", ctypes.c_void_p), ("frag_end", ctypes.c_void_p),
                ("n_frags", ctypes.c_void_p), ("frag_pool", ctypes.c_void_p),
                ("str_block", ctypes.c_void_p), ("str_size", ctypes.c_void_p),
                ("str_end", ctypes.c_void_p), ("n_str", ctypes.c_void_p),
                ("str_pool", ctypes.c_void_p),
                ("snp_pos", ctypes.c_void_p), ("snp_base", ctypes.c_void_p),
                ("n_snps", ctypes.c_void_p),
                ("indel_pos", ctypes.c_void_p),
                ("indel_size", ctypes.c_void_p),
                ("n_indels", ctypes.c_void_p),
                ("flank_ins", ctypes.c_void_p), ("flank_del", ctypes.c_void_p)]


def trace_structs_for(hap_instance):
    """Build (and cache on the instance) the packed TraceFillArgs +
    TraceWalkArgs the consolidated C trace call needs."""
    cached = getattr(hap_instance, "_trace_structs", None)
    if cached is not None:
        return cached
    pb = hap_instance.native_meta()[-1]
    fill = _TraceFillArgs(*pb)
    wb = hap_instance.walk_meta()[15]
    walk = _TraceWalkArgs(*wb)
    cached = (fill, walk)
    hap_instance._trace_structs = cached
    return cached


class _WalkBuffers:
    """Output buffers for one walk direction (layout of
    hmm_retrace_walk_native's internals)."""

    def __init__(self, n_rows: int, seg_len: int, nb: int):
        import numpy as np
        cap = n_rows + seg_len + 8
        self.aln = np.empty(cap, dtype=np.uint8)
        self.counts = np.zeros(6, dtype=np.int32)  # aln,frags,str,snps,indel,+
        self.frag_block = np.empty(nb + 2, dtype=np.int32)
        self.frag_end = np.empty(nb + 2, dtype=np.int32)
        self.frag_pool = np.empty(seg_len + 2, dtype=np.uint8)
        self.str_block = np.empty(nb + 1, dtype=np.int32)
        self.str_size = np.empty(nb + 1, dtype=np.int32)
        self.str_end = np.empty(nb + 1, dtype=np.int32)
        self.str_pool = np.empty(seg_len + 2, dtype=np.uint8)
        self.snp_pos = np.empty(seg_len + 2, dtype=np.int32)
        self.snp_base = np.empty(seg_len + 2, dtype=np.uint8)
        self.indel_pos = np.empty(cap, dtype=np.int64)
        self.indel_size = np.empty(cap, dtype=np.int64)
        self.flanks = np.zeros(2, dtype=np.int32)
        c = self.counts.ctypes.data
        self.struct = _TraceWalkOut(
            self.aln.ctypes.data, c,
            self.frag_block.ctypes.data, self.frag_end.ctypes.data, c + 4,
            self.frag_pool.ctypes.data,
            self.str_block.ctypes.data, self.str_size.ctypes.data,
            self.str_end.ctypes.data, c + 8, self.str_pool.ctypes.data,
            self.snp_pos.ctypes.data, self.snp_base.ctypes.data, c + 12,
            self.indel_pos.ctypes.data, self.indel_size.ctypes.data, c + 16,
            self.flanks.ctypes.data, self.flanks.ctypes.data + 4)

    def result(self):
        n_aln, n_frags, n_str, n_snps, n_indels = (int(x) for x in
                                                   self.counts[:5])
        return (self.aln[:n_aln], self.frag_block[:n_frags],
                self.frag_end[:n_frags], self.frag_pool,
                self.str_block[:n_str], self.str_size[:n_str],
                self.str_end[:n_str], self.str_pool,
                self.snp_pos[:n_snps], self.snp_base[:n_snps],
                self.indel_pos[:n_indels], self.indel_size[:n_indels],
                int(self.flanks[0]), int(self.flanks[1]))


_walk_buf_tls = threading.local()


def _tls_walk_buffers(n_rows: int, seed_base: int, rlen: int, nb: int):
    """Grow-only per-thread (left, right) walk-buffer pair: results are
    consumed into python objects before the next trace call, so the
    buffers (and their ctypes structs) can be reused."""
    pair = getattr(_walk_buf_tls, "pair", None)
    dims = getattr(_walk_buf_tls, "dims", None)
    seg = max(seed_base, rlen)
    if pair is None or dims[0] < n_rows or dims[1] < seg or dims[2] < nb:
        pair = (_WalkBuffers(n_rows, seg, nb), _WalkBuffers(n_rows, seg, nb))
        _walk_buf_tls.pair = pair
        _walk_buf_tls.dims = (n_rows, seg, nb)
    return pair


def hmm_trace_batch_native(jobs, min_snp_lpc: float, tol: float,
                           n_threads: int = 1):
    """N traces in ONE FFI call (native hmm_trace_batch).

    Each job is (seq_codes, blw, blc, seed_base, fw_instance, rev_instance,
    mid_rows, mid_chars, seed_log_prior, first_code, last_code) — the same
    per-trace inputs as hmm_trace_full_native.  Returns a list with one
    (LL, max_index, left_res|None, right_res|None) per job (None for a job
    the C side rejected), or None when the library lacks the entry.
    """
    lib = _load()
    if lib is None or not hasattr(lib, "hmm_trace_batch"):
        return None
    import numpy as np
    n = len(jobs)
    if n == 0:
        return []

    VP = ctypes.c_void_p * n
    seq_p, blw_p, blc_p = VP(), VP(), VP()
    ffp, fwp, rfp, rwp = VP(), VP(), VP(), VP()
    mrp, mcp = VP(), VP()
    Ls = np.empty(n, dtype=np.int32)
    seeds = np.empty(n, dtype=np.int32)
    nmids = np.empty(n, dtype=np.int32)
    slps = np.empty(n, dtype=np.float64)
    firsts = np.empty(n, dtype=np.int32)
    lasts = np.empty(n, dtype=np.int32)
    keep = []  # keep per-job arrays alive across the call
    max_rows = max_L = max_nb = 0
    for i, (seq, blw, blc, seed_base, fw, rev, mid_rows, mid_chars,
            slp, first, last) in enumerate(jobs):
        fw_fill, fw_walk = trace_structs_for(fw)
        rev_fill, rev_walk = trace_structs_for(rev)
        seq_p[i] = seq.ctypes.data
        blw_p[i] = blw.ctypes.data
        blc_p[i] = blc.ctypes.data
        ffp[i] = ctypes.addressof(fw_fill)
        fwp[i] = ctypes.addressof(fw_walk)
        rfp[i] = ctypes.addressof(rev_fill)
        rwp[i] = ctypes.addressof(rev_walk)
        mrp[i] = mid_rows.ctypes.data
        mcp[i] = mid_chars.ctypes.data
        Ls[i] = len(seq)
        seeds[i] = seed_base
        nmids[i] = len(mid_rows)
        slps[i] = slp
        firsts[i] = first
        lasts[i] = last
        keep.append((seq, blw, blc, mid_rows, mid_chars))
        max_rows = max(max_rows, fw_fill.H)
        max_L = max(max_L, len(seq))
        max_nb = max(max_nb, fw_walk.n_blocks)

    n2 = 2 * n
    aln_stride = max_rows + max_L + 8
    frag_stride = max_nb + 2
    seq_stride = max_L + 2
    out_LL = np.empty(n, dtype=np.float64)
    out_max = np.empty(n, dtype=np.int32)
    out_rc = np.empty(n, dtype=np.int32)
    out_valid = np.zeros(n2, dtype=np.uint8)
    aln_pool = np.empty((n2, aln_stride), dtype=np.uint8)
    aln_len = np.zeros(n2, dtype=np.int32)
    frag_block = np.empty((n2, frag_stride), dtype=np.int32)
    frag_end = np.empty((n2, frag_stride), dtype=np.int32)
    n_frags = np.zeros(n2, dtype=np.int32)
    fragp = np.empty((n2, seq_stride), dtype=np.uint8)
    str_block = np.empty((n2, frag_stride), dtype=np.int32)
    str_size = np.empty((n2, frag_stride), dtype=np.int32)
    str_end = np.empty((n2, frag_stride), dtype=np.int32)
    n_str = np.zeros(n2, dtype=np.int32)
    strp = np.empty((n2, seq_stride), dtype=np.uint8)
    snp_pos = np.empty((n2, seq_stride), dtype=np.int32)
    snp_base = np.empty((n2, seq_stride), dtype=np.uint8)
    n_snps = np.zeros(n2, dtype=np.int32)
    indel_pos = np.empty((n2, aln_stride), dtype=np.int64)
    indel_size = np.empty((n2, aln_stride), dtype=np.int64)
    n_indels = np.zeros(n2, dtype=np.int32)
    flank_ins = np.zeros(n2, dtype=np.int32)
    flank_del = np.zeros(n2, dtype=np.int32)

    rc = lib.hmm_trace_batch(
        n, seq_p, Ls.ctypes.data, blw_p, blc_p, seeds.ctypes.data,
        ffp, fwp, rfp, rwp, mrp, mcp, nmids.ctypes.data,
        slps.ctypes.data, firsts.ctypes.data, lasts.ctypes.data,
        min_snp_lpc, tol, n_threads,
        out_LL.ctypes.data, out_max.ctypes.data, out_rc.ctypes.data,
        out_valid.ctypes.data,
        aln_pool.ctypes.data, aln_stride, aln_len.ctypes.data,
        frag_block.ctypes.data, frag_end.ctypes.data, frag_stride,
        n_frags.ctypes.data, fragp.ctypes.data, seq_stride,
        str_block.ctypes.data, str_size.ctypes.data, str_end.ctypes.data,
        frag_stride, n_str.ctypes.data, strp.ctypes.data, seq_stride,
        snp_pos.ctypes.data, snp_base.ctypes.data, seq_stride,
        n_snps.ctypes.data,
        indel_pos.ctypes.data, indel_size.ctypes.data, aln_stride,
        n_indels.ctypes.data, flank_ins.ctypes.data, flank_del.ctypes.data)
    del keep
    if rc != 0:
        return None

    def slot(s):
        return (aln_pool[s, :aln_len[s]], frag_block[s, :n_frags[s]],
                frag_end[s, :n_frags[s]], fragp[s],
                str_block[s, :n_str[s]], str_size[s, :n_str[s]],
                str_end[s, :n_str[s]], strp[s],
                snp_pos[s, :n_snps[s]], snp_base[s, :n_snps[s]],
                indel_pos[s, :n_indels[s]], indel_size[s, :n_indels[s]],
                int(flank_ins[s]), int(flank_del[s]))

    results = []
    for i in range(n):
        if out_rc[i] != 0:
            results.append(None)
            continue
        results.append((float(out_LL[i]), int(out_max[i]),
                        slot(2 * i) if out_valid[2 * i] else None,
                        slot(2 * i + 1) if out_valid[2 * i + 1] else None))
    return results


def hmm_trace_full_native(seq_codes, blw, blc, seed_base: int,
                          fw_instance, rev_instance,
                          mid_rows, mid_chars, seed_log_prior: float,
                          first_code: int, last_code: int,
                          min_snp_lpc: float, tol: float):
    """One FFI call for a full trace; returns
    (LL, max_index, left_res|None, right_res|None) where each res has the
    hmm_retrace_walk_native layout, or None when the library is absent."""
    lib = _load()
    if lib is None or not hasattr(lib, "hmm_trace_full"):
        return None
    import numpy as np
    fw_fill, fw_walk = trace_structs_for(fw_instance)
    rev_fill, rev_walk = trace_structs_for(rev_instance)
    L = len(seq_codes)
    H = fw_fill.H
    nb = fw_walk.n_blocks
    left, right = _tls_walk_buffers(H, seed_base, L - 1 - seed_base, nb)
    out_max = ctypes.c_int32(-1)
    out_ll = ctypes.c_double(0.0)
    lv = ctypes.c_int32(0)
    rv = ctypes.c_int32(0)
    rc = lib.hmm_trace_full(
        seq_codes.ctypes.data, L, blw.ctypes.data, blc.ctypes.data,
        seed_base,
        ctypes.byref(fw_fill), ctypes.byref(fw_walk),
        ctypes.byref(rev_fill), ctypes.byref(rev_walk),
        mid_rows.ctypes.data, mid_chars.ctypes.data, len(mid_rows),
        seed_log_prior, first_code, last_code, min_snp_lpc, tol,
        ctypes.byref(out_max), ctypes.byref(out_ll),
        ctypes.byref(lv), ctypes.byref(left.struct),
        ctypes.byref(rv), ctypes.byref(right.struct))
    if rc != 0:
        return None
    return (float(out_ll.value), int(out_max.value),
            left.result() if lv.value else None,
            right.result() if rv.value else None)


def hmm_trace_summary_batch_native(jobs, hap_aln_infos, hap_start: int,
                                   min_snp_lpc: float, tol: float,
                                   n_threads: int = 1):
    """N trace SUMMARIES in one FFI call (native hmm_trace_summary_batch).

    Each job is the hmm_trace_batch_native tuple; `hap_aln_infos[i]` is the
    job's haplotype->reference op bytes (HapAlignInfo.aln_info_bytes).
    Returns a dict of columnar numpy arrays (one row per job) or None when
    the library lacks the entry:
      rc, LL, max_index, start, stop, flank_ins, flank_del,
      stut_size/stut_valid [n, NB], str_pool/str_off/str_len,
      flank_pool/flank_off/flank_len, cigar_ops/cigar_num/n_cigar,
      aln_pool/aln_len (+ the strides) — jobs with rc != 0 must be re-run
    through the object fallback.
    """
    lib = _load()
    if lib is None or not hasattr(lib, "hmm_trace_summary_batch"):
        return None
    import numpy as np
    n = len(jobs)
    if n == 0:
        return None

    VP = ctypes.c_void_p * n
    seq_p, blw_p, blc_p = VP(), VP(), VP()
    ffp, fwp, rfp, rwp = VP(), VP(), VP(), VP()
    mrp, mcp, hap_p = VP(), VP(), VP()
    Ls = np.empty(n, dtype=np.int32)
    seeds = np.empty(n, dtype=np.int32)
    nmids = np.empty(n, dtype=np.int32)
    slps = np.empty(n, dtype=np.float64)
    firsts = np.empty(n, dtype=np.int32)
    lasts = np.empty(n, dtype=np.int32)
    hap_lens = np.empty(n, dtype=np.int32)
    hap_starts = np.full(n, hap_start, dtype=np.int64)
    keep = []
    max_L = max_nb = max_hap = 0
    for i, (seq, blw, blc, seed_base, fw, rev, mid_rows, mid_chars,
            slp, first, last) in enumerate(jobs):
        fw_fill, fw_walk = trace_structs_for(fw)
        rev_fill, rev_walk = trace_structs_for(rev)
        seq_p[i] = seq.ctypes.data
        blw_p[i] = blw.ctypes.data
        blc_p[i] = blc.ctypes.data
        ffp[i] = ctypes.addressof(fw_fill)
        fwp[i] = ctypes.addressof(fw_walk)
        rfp[i] = ctypes.addressof(rev_fill)
        rwp[i] = ctypes.addressof(rev_walk)
        mrp[i] = mid_rows.ctypes.data
        mcp[i] = mid_chars.ctypes.data
        hb = hap_aln_infos[i]
        hap_p[i] = ctypes.cast(ctypes.c_char_p(hb), ctypes.c_void_p)
        Ls[i] = len(seq)
        seeds[i] = seed_base
        nmids[i] = len(mid_rows)
        slps[i] = slp
        firsts[i] = first
        lasts[i] = last
        hap_lens[i] = len(hb)
        keep.append((seq, blw, blc, mid_rows, mid_chars, hb))
        max_L = max(max_L, len(seq))
        max_nb = max(max_nb, fw_walk.n_blocks)
        max_hap = max(max_hap, len(hb))

    nb_stride = max_nb
    str_stride = max_L + 2
    flank_stride = max_L + 2
    cig_stride = max_hap + max_L + 4
    out = dict(
        rc=np.empty(n, dtype=np.int32),
        LL=np.empty(n, dtype=np.float64),
        max_index=np.empty(n, dtype=np.int32),
        start=np.empty(n, dtype=np.int64),
        stop=np.empty(n, dtype=np.int64),
        flank_ins=np.zeros(n, dtype=np.int32),
        flank_del=np.zeros(n, dtype=np.int32),
        stut_size=np.empty((n, nb_stride), dtype=np.int32),
        stut_valid=np.empty((n, nb_stride), dtype=np.uint8),
        str_pool=np.empty((n, str_stride), dtype=np.uint8),
        str_off=np.empty((n, nb_stride), dtype=np.int32),
        str_len=np.empty((n, nb_stride), dtype=np.int32),
        flank_pool=np.empty((n, flank_stride), dtype=np.uint8),
        flank_off=np.empty((n, nb_stride), dtype=np.int32),
        flank_len=np.empty((n, nb_stride), dtype=np.int32),
        cigar_ops=np.empty((n, cig_stride), dtype=np.uint8),
        cigar_num=np.empty((n, cig_stride), dtype=np.int32),
        n_cigar=np.zeros(n, dtype=np.int32),
        aln_pool=np.empty((n, cig_stride), dtype=np.uint8),
        aln_len=np.zeros(n, dtype=np.int32),
    )
    rc = lib.hmm_trace_summary_batch(
        n, seq_p, Ls.ctypes.data, blw_p, blc_p, seeds.ctypes.data,
        ffp, fwp, rfp, rwp, mrp, mcp, nmids.ctypes.data,
        slps.ctypes.data, firsts.ctypes.data, lasts.ctypes.data,
        hap_p, hap_lens.ctypes.data, hap_starts.ctypes.data,
        min_snp_lpc, tol, n_threads,
        out["rc"].ctypes.data, out["LL"].ctypes.data,
        out["max_index"].ctypes.data,
        out["start"].ctypes.data, out["stop"].ctypes.data,
        out["flank_ins"].ctypes.data, out["flank_del"].ctypes.data,
        nb_stride, out["stut_size"].ctypes.data,
        out["stut_valid"].ctypes.data,
        str_stride, out["str_pool"].ctypes.data,
        out["str_off"].ctypes.data, out["str_len"].ctypes.data,
        flank_stride, out["flank_pool"].ctypes.data,
        out["flank_off"].ctypes.data, out["flank_len"].ctypes.data,
        cig_stride, out["cigar_ops"].ctypes.data,
        out["cigar_num"].ctypes.data, out["n_cigar"].ctypes.data,
        out["aln_pool"].ctypes.data, out["aln_len"].ctypes.data)
    del keep
    if rc != 0:
        return None
    return out


def bam_filter_batch_native(blob: bytes, rec_off, rec_len,
                            f_start: int, f_end: int,
                            g_start: int, g_stop: int, target_rid: int,
                            qual_trim_ch: int,
                            trim2_min_start: int, trim2_max_stop: int,
                            chrom_seq_b: bytes,
                            min_flank: int, match_window: int,
                            min_end_match: int, min_bp_before_indel: int,
                            do_adapter_trim: bool,
                            adapters, min_overlap: int, max_err: float,
                            max_seq: int = 512, max_cig: int = 64):
    """Decode + filter-cascade one locus's BAM records in one call
    (native bam_filter_batch).  Returns a dict of columnar arrays or None
    when the entry is unavailable.  `adapters` is the 8-tuple
    (r1_fw0, r1_fw1, r2_fw0, r2_fw1, r1_rc0, r1_rc1, r2_rc0, r2_rc1) of
    equal-length adapter byte strings."""
    lib = _load()
    if lib is None or not hasattr(lib, "bam_filter_batch"):
        return None
    import numpy as np
    n = len(rec_off)
    if n == 0:
        return {}
    rec_off = np.ascontiguousarray(rec_off, dtype=np.int64)
    rec_len = np.ascontiguousarray(rec_len, dtype=np.int32)
    # grow-only per-thread output buffers: every field is written (or
    # defaulted) by the C side per record, and callers copy what they keep,
    # so reuse across calls is safe and saves multi-MB allocations
    _SPEC = (("status", np.uint8, 1), ("overlaps", np.uint8, 1),
             ("has_n", np.uint8, 1), ("p2_flank_ok", np.uint8, 1),
             ("p2_largest_ok", np.uint8, 1), ("p2_endmatch_ok", np.uint8, 1),
             ("p2_indel_ok", np.uint8, 1), ("rec_err", np.uint8, 1),
             ("flag", np.int32, 1), ("ref_id", np.int32, 1),
             ("mate_rid", np.int32, 1), ("pos", np.int64, 1),
             ("end_pos", np.int64, 1), ("orig_pos", np.int64, 1),
             ("mate_pos", np.int64, 1), ("name_off", np.int64, 1),
             ("name_len", np.int32, 1),
             ("seq_pool", np.uint8, "seq"), ("qual_pool", np.uint8, "seq"),
             ("seq_len", np.int32, 1),
             ("cig_op", np.uint8, "cig"), ("cig_n", np.int32, "cig"),
             ("n_cig", np.int32, 1), ("pos2", np.int64, 1),
             ("end2", np.int64, 1), ("l2", np.int32, 1), ("r2", np.int32, 1),
             ("cig2_op", np.uint8, "cig"), ("cig2_n", np.int32, "cig"),
             ("n_cig2", np.int32, 1), ("matches_ref", np.uint8, 1),
             ("rg_off", np.int32, 1), ("rg_len", np.int32, 1),
             ("xa_off", np.int32, 1), ("xa_len", np.int32, 1),
             ("sa_off", np.int32, 1), ("sa_len", np.int32, 1),
             ("as_val", np.int32, 1), ("as_has", np.uint8, 1),
             ("xs_val", np.int32, 1), ("xs_has", np.uint8, 1),
             ("hp_val", np.int32, 1), ("hp_has", np.uint8, 1),
             ("adapter_trim_bases", np.int32, 1),
             ("adapter_class", np.uint8, 1),
             ("qual_sum", np.float64, 1))
    tls = _filter_buf_tls
    cached = getattr(tls, "buf", None)
    dims = getattr(tls, "dims", None)
    if cached is None or dims[0] < n or dims[1] != max_seq \
            or dims[2] != max_cig:
        cap = max(n, dims[0] if cached else 0, 256)
        cached = {}
        for name, dt, kind in _SPEC:
            if kind == 1:
                cached[name] = np.empty(cap, dtype=dt)
            elif kind == "seq":
                cached[name] = np.empty((cap, max_seq), dtype=dt)
            else:
                cached[name] = np.empty((cap, max_cig), dtype=dt)
        tls.buf = cached
        tls.dims = (cap, max_seq, max_cig)
    out = {name: cached[name][:n] for name, _, _ in _SPEC}
    o = out
    rc = lib.bam_filter_batch(
        blob, len(blob), rec_off.ctypes.data, rec_len.ctypes.data, n,
        f_start, f_end,
        g_start, g_stop, target_rid, qual_trim_ch,
        trim2_min_start, trim2_max_stop,
        chrom_seq_b, len(chrom_seq_b),
        min_flank, match_window, min_end_match, min_bp_before_indel,
        1 if do_adapter_trim else 0,
        *adapters,
        len(adapters[0]), min_overlap, max_err,
        max_seq, max_cig,
        o["status"].ctypes.data, o["overlaps"].ctypes.data,
        o["has_n"].ctypes.data,
        o["p2_flank_ok"].ctypes.data, o["p2_largest_ok"].ctypes.data,
        o["p2_endmatch_ok"].ctypes.data, o["p2_indel_ok"].ctypes.data,
        o["rec_err"].ctypes.data,
        o["flag"].ctypes.data, o["ref_id"].ctypes.data,
        o["mate_rid"].ctypes.data,
        o["pos"].ctypes.data, o["end_pos"].ctypes.data,
        o["orig_pos"].ctypes.data, o["mate_pos"].ctypes.data,
        o["name_off"].ctypes.data, o["name_len"].ctypes.data,
        o["seq_pool"].ctypes.data, o["qual_pool"].ctypes.data,
        o["seq_len"].ctypes.data,
        o["cig_op"].ctypes.data, o["cig_n"].ctypes.data,
        o["n_cig"].ctypes.data,
        o["pos2"].ctypes.data, o["end2"].ctypes.data,
        o["l2"].ctypes.data, o["r2"].ctypes.data,
        o["cig2_op"].ctypes.data, o["cig2_n"].ctypes.data,
        o["n_cig2"].ctypes.data, o["matches_ref"].ctypes.data,
        o["rg_off"].ctypes.data, o["rg_len"].ctypes.data,
        o["xa_off"].ctypes.data, o["xa_len"].ctypes.data,
        o["sa_off"].ctypes.data, o["sa_len"].ctypes.data,
        o["as_val"].ctypes.data, o["as_has"].ctypes.data,
        o["xs_val"].ctypes.data, o["xs_has"].ctypes.data,
        o["hp_val"].ctypes.data, o["hp_has"].ctypes.data,
        o["adapter_trim_bases"].ctypes.data,
        o["adapter_class"].ctypes.data,
        _logc_table_ptr(), o["qual_sum"].ctypes.data)
    if rc != 0:
        return None
    return out


def _logc_table_ptr():
    from .models.base_quality import _LOG_CORRECT_BY_BYTE
    return _LOG_CORRECT_BY_BYTE.ctypes.data


_filter_buf_tls = threading.local()


def flank_assembly_batch_native(ref_seq: str, min_k: int, max_k: int,
                                strings_by_sample, call_skip,
                                min_edge_freq: float = 0.02,
                                prune_min_weight: int = 2,
                                min_path_weight: int = 2,
                                max_paths: int = 10):
    """Run every sample's de Bruijn flank assembly (k escalation, prune,
    acyclicity/source/sink checks, bottleneck-weight path enumeration) in
    one native call (native/debruijn.cpp).

    strings_by_sample: per sample, iterable of str flank segments.
    call_skip: per sample, truthy = skip (already filtered).
    Returns (ok[s] bool array, [per-sample list of (seq, weight)]) or None
    when the entry is unavailable or a sample overflowed (caller falls
    back to the python path wholesale).
    """
    lib = _load()
    if lib is None or not hasattr(lib, "flank_assembly_batch"):
        return None
    import numpy as np
    S = len(strings_by_sample)
    parts = []
    offs = []
    lens = []
    samps = []
    pos = 0
    for s, strs in enumerate(strings_by_sample):
        for q in strs:
            b = q if isinstance(q, bytes) else q.encode("latin1")
            parts.append(b)
            offs.append(pos)
            lens.append(len(b))
            samps.append(s)
            pos += len(b)
    blob = b"".join(parts)
    n_str = len(offs)
    off_a = np.asarray(offs, dtype=np.int64)
    len_a = np.asarray(lens, dtype=np.int32)
    samp_a = np.asarray(samps, dtype=np.int32)
    skip_a = np.asarray([1 if c else 0 for c in call_skip], dtype=np.uint8)
    seq_stride = len(ref_seq) + 96
    ok = np.zeros(S, dtype=np.uint8)
    n_paths = np.zeros(S, dtype=np.int32)
    seq_pool = np.empty((S, max_paths, seq_stride), dtype=np.uint8)
    seq_len = np.zeros((S, max_paths), dtype=np.int32)
    weight = np.zeros((S, max_paths), dtype=np.int32)
    rc = np.zeros(S, dtype=np.uint8)
    r = lib.flank_assembly_batch(
        ref_seq.encode("latin1"), len(ref_seq), min_k, max_k, S,
        blob, off_a.ctypes.data, len_a.ctypes.data, samp_a.ctypes.data,
        n_str, skip_a.ctypes.data, min_edge_freq, prune_min_weight,
        min_path_weight, max_paths, seq_stride,
        ok.ctypes.data, n_paths.ctypes.data, seq_pool.ctypes.data,
        seq_len.ctypes.data, weight.ctypes.data, rc.ctypes.data)
    if r != 0 or rc.any():
        return None
    out = []
    for s in range(S):
        ps = []
        for p in range(int(n_paths[s])):
            ps.append((seq_pool[s, p, :seq_len[s, p]].tobytes()
                       .decode("latin1"), int(weight[s, p])))
        out.append(ps)
    return ok.astype(bool), out


def cram_decode_container_native(body: bytes, n_blocks: int, version: int,
                                 refs, rg_ids):
    """Decode one CRAM container body to BAM record bodies (native
    cram_decode_container).  `refs` maps ref_id -> reference bytes for
    every chromosome the container may touch (one entry for single-ref
    containers; all candidates for multi-ref).  Returns (blob bytes,
    offsets, lengths) with the io/bam.py fetch_raw conventions (offsets
    point past each record's 4-byte block_size), or None when the entry is
    unavailable or the container needs the python fallback (unsupported
    codec, bz2/lzma blocks, missing reference)."""
    lib = _load()
    if lib is None or not hasattr(lib, "cram_decode_container"):
        return None
    import numpy as np
    rg_blob = b"".join(r.encode("latin1") for r in rg_ids)
    rg_offs = np.zeros(len(rg_ids) + 1, dtype=np.int32)
    off = 0
    for i, r in enumerate(rg_ids):
        rg_offs[i] = off
        off += len(r.encode("latin1"))
    rg_offs[len(rg_ids)] = off
    n_refs = (max(refs) + 1) if refs else 0
    refs_offs = np.zeros(n_refs + 1, dtype=np.int64)
    refs_avail = np.zeros(max(1, n_refs), dtype=np.uint8)
    parts = []
    off = 0
    for rid in range(n_refs):
        refs_offs[rid] = off
        b = refs.get(rid)
        if b is not None:
            refs_avail[rid] = 1
            parts.append(b)
            off += len(b)
    refs_offs[n_refs] = off
    refs_blob = b"".join(parts)
    cap = max(1 << 20, 8 * len(body))
    max_recs = max(1024, len(body) // 8)
    n_out = ctypes.c_int32(0)
    for _ in range(4):
        out_blob = np.empty(cap, dtype=np.uint8)
        offs = np.empty(max_recs, dtype=np.int64)
        lens = np.empty(max_recs, dtype=np.int32)
        rc = lib.cram_decode_container(
            body, len(body), n_blocks, version,
            refs_blob, refs_offs.ctypes.data, refs_avail.ctypes.data,
            n_refs, rg_blob, rg_offs.ctypes.data, len(rg_ids),
            out_blob.ctypes.data, cap, offs.ctypes.data, lens.ctypes.data,
            max_recs, ctypes.byref(n_out))
        if rc == -2:
            cap *= 4
            max_recs *= 4
            continue
        if rc < 0:
            return None
        n = int(n_out.value)
        return (out_blob[:rc].tobytes(), offs[:n].tolist(),
                lens[:n].tolist())
    return None


def hmm_trace_summary_batch_runner(haplotype, jobs, hap_info, hap_start: int,
                                   min_snp_lpc: float, tol: float,
                                   n_threads: int = 1):
    """Single-pass marshalling for the trace-summary batch: per-instance
    pointer blocks (fill/walk structs, seed metadata) and per-pool data
    pointers are cached, so each job costs a handful of int stores into
    numpy pointer tables instead of rebuilding ctypes argument arrays
    (was ~25us/job of host python at deep coverage).  Returns a callable
    that runs the native batch (the GIL released) and returns its `out`
    dict, or None where the native side refused the batch; None where the
    native entry is missing or there are no jobs.  Marshalling and the
    batch's output arrays stay on the calling thread, so the call alone
    may run on another.  Results identical to
    hmm_trace_summary_batch_native."""
    lib = _load()
    if lib is None or not hasattr(lib, "hmm_trace_summary_batch"):
        return None
    import numpy as np
    from .align.retrace import _instances_for
    from .align.hmm_reference import seed_meta as _seed_meta
    n = len(jobs)
    if n == 0:
        return None

    ptab = np.empty((10, n), dtype=np.uint64)
    Ls = np.empty(n, dtype=np.int32)
    seeds = np.empty(n, dtype=np.int32)
    nmids = np.empty(n, dtype=np.int32)
    slps = np.empty(n, dtype=np.float64)
    firsts = np.empty(n, dtype=np.int32)
    lasts = np.empty(n, dtype=np.int32)
    hap_lens = np.empty(n, dtype=np.int32)
    hap_starts = np.full(n, hap_start, dtype=np.int64)
    keep = []
    max_L = max_nb = max_hap = 0
    pt = ptab  # [seq, blw, blc, ff, fw, rf, rw, mr, mc, hap]
    for i, (h, aln, seed_base, blw, blc) in enumerate(jobs):
        fw, rev = _instances_for(haplotype, h)
        pc = getattr(fw, "_ptr_cache", None)
        if pc is None:
            fw_fill, fw_walk = trace_structs_for(fw)
            rev_fill, rev_walk = trace_structs_for(rev)
            mid_rows, mid_chars, slp, first, last = _seed_meta(fw)
            pc = fw._ptr_cache = (
                ctypes.addressof(fw_fill), ctypes.addressof(fw_walk),
                ctypes.addressof(rev_fill), ctypes.addressof(rev_walk),
                mid_rows.ctypes.data, mid_chars.ctypes.data, len(mid_rows),
                slp, first, last, fw_walk.n_blocks,
                (fw_fill, fw_walk, rev_fill, rev_walk, mid_rows, mid_chars))
        codes = getattr(aln, "_codes_np", None)
        if codes is None:
            codes = np.frombuffer(aln.sequence.encode("latin1"),
                                  dtype=np.uint8)
            aln._codes_np = codes
        hb_ptr, hb_len = hap_info.aln_info_ptr(h)
        L = len(codes)
        pt[0, i] = codes.ctypes.data
        pt[1, i] = blw.ctypes.data
        pt[2, i] = blc.ctypes.data
        pt[3, i] = pc[0]
        pt[4, i] = pc[1]
        pt[5, i] = pc[2]
        pt[6, i] = pc[3]
        pt[7, i] = pc[4]
        pt[8, i] = pc[5]
        pt[9, i] = hb_ptr
        Ls[i] = L
        seeds[i] = seed_base
        nmids[i] = pc[6]
        slps[i] = pc[7]
        firsts[i] = pc[8]
        lasts[i] = pc[9]
        hap_lens[i] = hb_len
        keep.append((codes, blw, blc, pc))
        if L > max_L:
            max_L = L
        if pc[10] > max_nb:
            max_nb = pc[10]
        if hb_len > max_hap:
            max_hap = hb_len

    nb_stride = max_nb
    str_stride = max_L + 2
    flank_stride = max_L + 2
    cig_stride = max_hap + max_L + 4
    out = dict(
        rc=np.empty(n, dtype=np.int32),
        LL=np.empty(n, dtype=np.float64),
        max_index=np.empty(n, dtype=np.int32),
        start=np.empty(n, dtype=np.int64),
        stop=np.empty(n, dtype=np.int64),
        flank_ins=np.zeros(n, dtype=np.int32),
        flank_del=np.zeros(n, dtype=np.int32),
        stut_size=np.empty((n, nb_stride), dtype=np.int32),
        stut_valid=np.empty((n, nb_stride), dtype=np.uint8),
        str_pool=np.empty((n, str_stride), dtype=np.uint8),
        str_off=np.empty((n, nb_stride), dtype=np.int32),
        str_len=np.empty((n, nb_stride), dtype=np.int32),
        flank_pool=np.empty((n, flank_stride), dtype=np.uint8),
        flank_off=np.empty((n, nb_stride), dtype=np.int32),
        flank_len=np.empty((n, nb_stride), dtype=np.int32),
        cigar_ops=np.empty((n, cig_stride), dtype=np.uint8),
        cigar_num=np.empty((n, cig_stride), dtype=np.int32),
        n_cigar=np.zeros(n, dtype=np.int32),
        aln_pool=np.empty((n, cig_stride), dtype=np.uint8),
        aln_len=np.zeros(n, dtype=np.int32),
    )
    args = (
        n, pt[0].ctypes.data, Ls.ctypes.data, pt[1].ctypes.data,
        pt[2].ctypes.data, seeds.ctypes.data,
        pt[3].ctypes.data, pt[4].ctypes.data, pt[5].ctypes.data,
        pt[6].ctypes.data, pt[7].ctypes.data, pt[8].ctypes.data,
        nmids.ctypes.data,
        slps.ctypes.data, firsts.ctypes.data, lasts.ctypes.data,
        pt[9].ctypes.data, hap_lens.ctypes.data, hap_starts.ctypes.data,
        min_snp_lpc, tol, n_threads,
        out["rc"].ctypes.data, out["LL"].ctypes.data,
        out["max_index"].ctypes.data,
        out["start"].ctypes.data, out["stop"].ctypes.data,
        out["flank_ins"].ctypes.data, out["flank_del"].ctypes.data,
        nb_stride, out["stut_size"].ctypes.data,
        out["stut_valid"].ctypes.data,
        str_stride, out["str_pool"].ctypes.data,
        out["str_off"].ctypes.data, out["str_len"].ctypes.data,
        flank_stride, out["flank_pool"].ctypes.data,
        out["flank_off"].ctypes.data, out["flank_len"].ctypes.data,
        cig_stride, out["cigar_ops"].ctypes.data,
        out["cigar_num"].ctypes.data, out["n_cigar"].ctypes.data,
        out["aln_pool"].ctypes.data, out["aln_len"].ctypes.data)
    return functools.partial(
        _run_summary_batch, lib.hmm_trace_summary_batch, args, out,
        (keep, ptab, Ls, seeds, nmids, slps, firsts, lasts, hap_lens,
         hap_starts))


def _run_summary_batch(fn, args, out, buffers):
    """Run a marshalled trace-summary batch: `out`, or None where the
    native side refused it.  `buffers` holds every array the pointer
    arguments address until the call has run."""
    return out if fn(*args) == 0 else None
