"""Copy of hipstr_tpu/align/trace_summary.py.

Columnar ML-trace summaries (the hot-path replacement for full traces).

The adaptive genotyping loop (stutter-candidate mining, unused-allele
pruning, flank reassembly, VCF per-sample stats) consumes only a small
fixed summary of each (read pool, haplotype) maximum-likelihood trace:
the traced reference span, per-block stutter size and STR sequence, the
flank sequences, and the flank indel totals (reference consumers:
src/seq_stutter_genotyper.cpp:229-315, :843-879, :40-217, :984-1540).
Building full AlignmentTrace objects per trace — walk-event decoding,
string assembly, CIGAR lists — was the single largest host cost per locus,
so the native layer computes everything (DP fill + seed combine + walks +
read->reference stitch) in ONE columnar call (native/hmm_kernel.cpp
hmm_trace_summary_batch) and this module wraps each row in a slot-only
TraceSummary.  The full traced alignment (CIGAR + aligned string) is still
carried in the columnar output and materialized lazily — only the
visualization path asks for it.

Fallback: without the native library, summaries are derived from the
existing object path (align/retrace.trace_optimal_aln), so consumers have
exactly one code path.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .alignment_data import Alignment, CigarElement
from .haplotype import Haplotype
from .retrace import (MIN_SNP_LOG_PROB_CORRECT, TRACE_LL_TOL, HapAlignInfo,
                      _instances_for, trace_optimal_aln, trace_threads)
from .traceback import AlignmentTrace


class TraceSummary:
    """One (pool, haplotype) ML-trace summary.

    Attribute parity with the AlignmentTrace fields the pipeline consumes;
    `traced_aln()` materializes the full read->reference Alignment lazily
    (visualization only).
    """

    __slots__ = ("LL", "start", "stop", "flank_ins", "flank_del",
                 "stut_size", "stut_valid", "str_bytes", "flank_bytes",
                 "_cig_ops", "_cig_num", "_aln_bytes", "_quals", "_seq",
                 "_traced")

    def __init__(self, LL, start, stop, flank_ins, flank_del, stut_size,
                 stut_valid, str_bytes, flank_bytes, cig_ops, cig_num,
                 aln_bytes, seq, quals):
        self.LL = LL
        self.start = start
        self.stop = stop
        self.flank_ins = flank_ins
        self.flank_del = flank_del
        self.stut_size = stut_size      # tuple[int] per block
        self.stut_valid = stut_valid    # tuple[bool] per block
        self.str_bytes = str_bytes      # tuple[bytes] per block
        self.flank_bytes = flank_bytes  # tuple[bytes] per block
        self._cig_ops = cig_ops
        self._cig_num = cig_num
        self._aln_bytes = aln_bytes
        self._seq = seq
        self._quals = quals
        self._traced = None

    # -- AlignmentTrace-compatible accessors --------------------------------
    def has_stutter(self) -> bool:
        return any(v and s != 0 for v, s in zip(self.stut_valid,
                                                self.stut_size))

    def total_stutter_size(self) -> int:
        return sum(s for v, s in zip(self.stut_valid, self.stut_size) if v)

    def stutter_size(self, block_index: int) -> int:
        assert self.stut_valid[block_index]
        return self.stut_size[block_index]

    def str_seq_bytes(self, block_index: int) -> bytes:
        assert self.stut_valid[block_index]
        return self.str_bytes[block_index]

    def str_seq(self, block_index: int) -> str:
        return self.str_seq_bytes(block_index).decode("latin1")

    def flank_seq(self, block_index: int) -> str:
        return self.flank_bytes[block_index].decode("latin1")

    def flank_seq_bytes(self, block_index: int) -> bytes:
        return self.flank_bytes[block_index]

    def has_flank_indel(self) -> bool:
        return self.flank_ins != 0 or self.flank_del != 0

    @property
    def flank_ins_size(self) -> int:
        return self.flank_ins

    @property
    def flank_del_size(self) -> int:
        return self.flank_del

    @property
    def traced_aln(self) -> Alignment:
        """Materialize the read->reference Alignment (viz path only)."""
        t = self._traced
        if t is None:
            aligned = self._aln_bytes.decode("latin1")
            t = Alignment(self.start, self.stop, False, "TRACE",
                          self._quals, self._seq, aligned)
            t.cigar = [CigarElement(chr(op), int(n)) for op, n in
                       zip(self._cig_ops, self._cig_num)]
            self._traced = t
        return t


def summary_from_trace(LL: float, trace: AlignmentTrace,
                       num_blocks: int) -> TraceSummary:
    """Fallback: derive a TraceSummary from a full AlignmentTrace."""
    stut_size = []
    stut_valid = []
    str_bytes = []
    for b in range(num_blocks):
        d = trace._str_data[b]
        stut_valid.append(d is not None)
        stut_size.append(d[0] if d is not None else 0)
        str_bytes.append(d[1].encode("latin1") if d is not None else b"")
    flank_bytes = tuple(s.encode("latin1") for s in trace.flank_seqs)
    ta = trace.traced_aln
    s = TraceSummary(LL, ta.start, ta.stop, trace.flank_ins_size,
                     trace.flank_del_size, tuple(stut_size),
                     tuple(stut_valid), tuple(str_bytes), flank_bytes,
                     None, None, None, ta.sequence, ta.base_qualities)
    s._traced = ta
    return s


def _prep_native_jobs(haplotype: Haplotype, jobs, hap_info: HapAlignInfo):
    """(native job tuples, per-job hap aln-info bytes) for the batch entry."""
    from .hmm_reference import seed_meta as _seed_meta
    njobs = []
    hap_infos = []
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
        hap_infos.append(hap_info.aln_info_bytes(h))
    return njobs, hap_infos


def compute_batch_columnar(haplotype: Haplotype, jobs,
                           hap_info: HapAlignInfo, n_threads: int = 0):
    """The native columnar batch output for many (h, pooled_aln, seed_base,
    blw, blc) jobs, WITHOUT materializing TraceSummary objects — the
    TraceStore keeps the columns and builds objects lazily.  Returns the
    native `out` dict (rows with rc != 0 must be re-run through the object
    path) or None when the native entry is unavailable."""
    run = batch_columnar_runner(haplotype, jobs, hap_info, n_threads)
    return None if run is None else run()


def batch_columnar_runner(haplotype: Haplotype, jobs,
                          hap_info: HapAlignInfo, n_threads: int = 0):
    """compute_batch_columnar in two halves: the jobs are marshalled here,
    and the callable returned runs the native batch (the GIL released) and
    returns its `out` dict or None; None when the native entry is
    unavailable."""
    from .. import native as _native
    if not jobs:
        return None
    lib_ok = _native.available() and hasattr(_native._load(),
                                             "hmm_trace_summary_batch")
    if not lib_ok:
        return None
    return _native.hmm_trace_summary_batch_runner(
        haplotype, jobs, hap_info, haplotype.blocks[0].start,
        MIN_SNP_LOG_PROB_CORRECT, TRACE_LL_TOL,
        n_threads or trace_threads())


def summary_from_batch_row(out, i: int, nb: int, aln) -> TraceSummary:
    """Materialize row `i` of a native columnar batch as a TraceSummary."""
    so = out["str_off"][i]
    sl = out["str_len"][i]
    fo = out["flank_off"][i]
    fl = out["flank_len"][i]
    srow = out["str_pool"][i]
    frow = out["flank_pool"][i]
    str_bytes = tuple(srow[so[b]:so[b] + sl[b]].tobytes() for b in range(nb))
    flank_bytes = tuple(frow[fo[b]:fo[b] + fl[b]].tobytes()
                        for b in range(nb))
    nc = int(out["n_cigar"][i])
    alen = int(out["aln_len"][i])
    return TraceSummary(
        float(out["LL"][i]), int(out["start"][i]), int(out["stop"][i]),
        int(out["flank_ins"][i]), int(out["flank_del"][i]),
        tuple(out["stut_size"][i, :nb].tolist()),
        tuple(bool(v) for v in out["stut_valid"][i, :nb].tolist()),
        str_bytes, flank_bytes,
        out["cigar_ops"][i, :nc], out["cigar_num"][i, :nc],
        out["aln_pool"][i, :alen].tobytes(),
        aln.sequence, aln.base_qualities)


def compute_summaries(haplotype: Haplotype, jobs,
                      hap_info: HapAlignInfo,
                      n_threads: int = 0) -> Optional[List[TraceSummary]]:
    """Compute TraceSummaries for many (h, pooled_aln, seed_base, blw, blc)
    jobs of one locus in one native call; job order preserved.  Jobs the
    native side rejects fall back to the object path; returns None when the
    native entry is unavailable (caller uses the object path wholesale).
    """
    out = compute_batch_columnar(haplotype, jobs, hap_info,
                                 n_threads=n_threads)
    if out is None:
        if not jobs:
            return []
        return None

    nb = haplotype.num_blocks()
    rcs = out["rc"]
    LLs = out["LL"]
    starts = out["start"]
    stops = out["stop"]
    fins = out["flank_ins"]
    fdels = out["flank_del"]
    ssz = out["stut_size"]
    sva = out["stut_valid"]
    spool = out["str_pool"]
    soff = out["str_off"]
    slen = out["str_len"]
    fpool = out["flank_pool"]
    foff = out["flank_off"]
    flen = out["flank_len"]
    cops = out["cigar_ops"]
    cnum = out["cigar_num"]
    ncig = out["n_cigar"]
    apool = out["aln_pool"]
    alen = out["aln_len"]
    ssz_l = ssz.tolist()
    sva_l = sva.tolist()
    soff_l = soff.tolist()
    slen_l = slen.tolist()
    foff_l = foff.tolist()
    flen_l = flen.tolist()
    rc_l = rcs.tolist()
    LL_l = LLs.tolist()
    start_l = starts.tolist()
    stop_l = stops.tolist()
    fin_l = fins.tolist()
    fdel_l = fdels.tolist()
    ncig_l = ncig.tolist()
    alen_l = alen.tolist()

    results: List[TraceSummary] = []
    for i, (h, aln, seed_base, blw, blc) in enumerate(jobs):
        if rc_l[i] != 0:
            LL, trace = trace_optimal_aln(haplotype, h, aln, seed_base,
                                          blw, blc, hap_info)
            results.append(summary_from_trace(LL, trace, nb))
            continue
        srow = spool[i]
        frow = fpool[i]
        so, sl = soff_l[i], slen_l[i]
        fo, fl = foff_l[i], flen_l[i]
        str_bytes = tuple(srow[so[b]:so[b] + sl[b]].tobytes()
                          for b in range(nb))
        flank_bytes = tuple(frow[fo[b]:fo[b] + fl[b]].tobytes()
                            for b in range(nb))
        nc = ncig_l[i]
        results.append(TraceSummary(
            LL_l[i], start_l[i], stop_l[i], fin_l[i], fdel_l[i],
            tuple(ssz_l[i][:nb]), tuple(bool(v) for v in sva_l[i][:nb]),
            str_bytes, flank_bytes,
            cops[i, :nc], cnum[i, :nc],
            apool[i, :alen_l[i]].tobytes(),
            aln.sequence, aln.base_qualities))
    return results


def summaries_via_objects(haplotype: Haplotype, jobs,
                          hap_info: HapAlignInfo,
                          n_threads: int = 0) -> List[TraceSummary]:
    """Object-path summaries (no native library): one trace at a time
    through trace_optimal_aln, converted to TraceSummaries."""
    from .retrace import trace_batch
    nb = haplotype.num_blocks()
    res = trace_batch(haplotype, jobs, hap_info, n_threads=n_threads)
    out: List[TraceSummary] = []
    if res is not None:
        for LL, trace in res:
            out.append(summary_from_trace(LL, trace, nb))
        return out
    for h, aln, seed_base, blw, blc in jobs:
        LL, trace = trace_optimal_aln(haplotype, h, aln, seed_base, blw,
                                      blc, hap_info)
        out.append(summary_from_trace(LL, trace, nb))
    return out


def trace_summaries(haplotype: Haplotype, jobs, hap_info: HapAlignInfo,
                    n_threads: int = 0) -> List[TraceSummary]:
    """Native columnar summaries with automatic object-path fallback."""
    res = compute_summaries(haplotype, jobs, hap_info, n_threads=n_threads)
    if res is None:
        res = summaries_via_objects(haplotype, jobs, hap_info,
                                    n_threads=n_threads)
    return res


def _narrowed(out: dict) -> dict:
    """A native batch's `out` with its cigar and alignment columns cut to
    its widest row: the batch sizes them for the longest alignment
    possible, ~1.2 KB a trace that a TraceStore would keep while its locus
    lives.  Rows are read only up to their own `n_cigar` / `aln_len`."""
    nc = int(out["n_cigar"].max(initial=0))
    al = int(out["aln_len"].max(initial=0))
    return dict(out, cigar_ops=out["cigar_ops"][:, :nc].copy(),
                cigar_num=out["cigar_num"][:, :nc].copy(),
                aln_pool=out["aln_pool"][:, :al].copy())


class TraceStore:
    """Columnar store of one locus's (pool, haplotype) ML-trace summaries.

    The adaptive loop's trace consumers (unused-allele pruning, stutter
    mining, flank assembly, VCF stats — reference
    src/seq_stutter_genotyper.cpp:229-315, :843-879, :40-217, :1102-1166)
    read per-trace SCALARS: span, per-block stutter size/validity, flank
    indel totals.  Boxing every native batch row into a TraceSummary and
    unboxing it per read cost ~5 ms/locus of host Python; the store instead
    keeps the batch columns as grow-in-place numpy arrays so consumers
    gather whole per-read vectors, and materializes a TraceSummary only on
    demand (string sequences for mining/assembly, traced alignments for
    viz).

    Rows are immutable and survive haplotype changes — the (pool, hap) key
    map `rows` is remapped by the caller exactly as the reference remaps
    its caches across allele additions/removals
    (seq_stutter_genotyper.cpp:324-415).
    """

    __slots__ = ("nb", "n", "_cap", "LL", "start", "stop", "fins", "fdel",
                 "stut", "svalid", "_batches", "_src", "_summ", "rows")

    def __init__(self, nb: int):
        self.nb = nb
        self.n = 0
        self._cap = 0
        self.LL = None       # float64 [cap]
        self.start = None    # int64 [cap]
        self.stop = None     # int64 [cap]
        self.fins = None     # int32 [cap]
        self.fdel = None     # int32 [cap]
        self.stut = None     # int64 [cap, nb]
        self.svalid = None   # bool [cap, nb]
        self._batches: list = []   # (native out dict, [aln per row])
        self._src: list = []       # per row: (batch_idx, i) | TraceSummary
        self._summ: dict = {}      # row -> lazy TraceSummary
        self.rows: Dict[Tuple[int, int], int] = {}

    def clear_all(self) -> None:
        """Drop every row (stutter model changed: all traces stale)."""
        self.n = 0
        self._cap = 0
        self.LL = self.start = self.stop = None
        self.fins = self.fdel = self.stut = self.svalid = None
        self._batches.clear()
        self._src.clear()
        self._summ.clear()
        self.rows.clear()

    def _grow(self, add: int) -> None:
        need = self.n + add
        if need <= self._cap:
            return
        cap = max(need, 2 * self._cap, 256)

        def g(a, dtype, cols=None):
            new = np.zeros((cap, cols) if cols else cap, dtype=dtype)
            if a is not None:
                new[:self.n] = a[:self.n]
            return new

        self.LL = g(self.LL, np.float64)
        self.start = g(self.start, np.int64)
        self.stop = g(self.stop, np.int64)
        self.fins = g(self.fins, np.int32)
        self.fdel = g(self.fdel, np.int32)
        self.stut = g(self.stut, np.int64, self.nb)
        self.svalid = g(self.svalid, bool, self.nb)
        self._cap = cap

    def add_batch(self, keys, out, jobs, haplotype, hap_info) -> None:
        """Install one native columnar batch; rows the native side rejected
        (rc != 0) are recomputed through the object path."""
        m = len(keys)
        self._grow(m)
        n0 = self.n
        sl = slice(n0, n0 + m)
        nb = self.nb
        self.LL[sl] = out["LL"][:m]
        self.start[sl] = out["start"][:m]
        self.stop[sl] = out["stop"][:m]
        self.fins[sl] = out["flank_ins"][:m]
        self.fdel[sl] = out["flank_del"][:m]
        self.stut[sl] = out["stut_size"][:m, :nb]
        self.svalid[sl] = out["stut_valid"][:m, :nb].astype(bool)
        bidx = len(self._batches)
        self._batches.append((_narrowed(out), [j[1] for j in jobs]))
        src = self._src
        for i in range(m):
            src.append((bidx, i))
        bad = np.nonzero(out["rc"][:m] != 0)[0]
        for i in bad.tolist():
            h, aln, seed_base, blw, blc = jobs[i]
            LL, trace = trace_optimal_aln(haplotype, h, aln, seed_base,
                                          blw, blc, hap_info)
            self._install_object(n0 + i, summary_from_trace(LL, trace, nb))
        for i, key in enumerate(keys):
            self.rows[key] = n0 + i
        self.n = n0 + m

    def add_objects(self, keys, summaries) -> None:
        """Install object-path summaries (native library unavailable)."""
        m = len(keys)
        self._grow(m)
        n0 = self.n
        self.n = n0 + m
        for i, (key, s) in enumerate(zip(keys, summaries)):
            self._src.append(None)
            self._install_object(n0 + i, s)
            self.rows[key] = n0 + i

    def _install_object(self, row: int, s: TraceSummary) -> None:
        self.LL[row] = s.LL
        self.start[row] = s.start
        self.stop[row] = s.stop
        self.fins[row] = s.flank_ins
        self.fdel[row] = s.flank_del
        self.stut[row] = s.stut_size
        self.svalid[row] = s.stut_valid
        self._src[row] = s

    def summary(self, row: int) -> TraceSummary:
        """The boxed TraceSummary for a row (lazy; cached)."""
        s = self._summ.get(row)
        if s is None:
            src = self._src[row]
            if isinstance(src, TraceSummary):
                s = src
            else:
                bidx, i = src
                out, alns = self._batches[bidx]
                s = summary_from_batch_row(out, i, self.nb, alns[i])
            self._summ[row] = s
        return s

    def str_seq_bytes(self, row: int, block_index: int) -> bytes:
        assert self.svalid[row, block_index]
        src = self._src[row]
        if isinstance(src, TraceSummary):
            return src.str_bytes[block_index]
        bidx, i = src
        out, _ = self._batches[bidx]
        o = out["str_off"][i, block_index]
        ln = out["str_len"][i, block_index]
        return out["str_pool"][i, o:o + ln].tobytes()

    def str_seq(self, row: int, block_index: int) -> str:
        return self.str_seq_bytes(row, block_index).decode("latin1")

    def flank_seq_bytes(self, row: int, block_index: int) -> bytes:
        src = self._src[row]
        if isinstance(src, TraceSummary):
            return src.flank_bytes[block_index]
        bidx, i = src
        out, _ = self._batches[bidx]
        o = out["flank_off"][i, block_index]
        ln = out["flank_len"][i, block_index]
        return out["flank_pool"][i, o:o + ln].tobytes()

    def flank_seq(self, row: int, block_index: int) -> str:
        return self.flank_seq_bytes(row, block_index).decode("latin1")
