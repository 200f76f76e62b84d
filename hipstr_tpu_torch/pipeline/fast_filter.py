"""Copy of hipstr_tpu/pipeline/fast_filter.py.

Columnar read filtering: native decode + cascade, Python state machine.

The per-record work of BamProcessor::read_and_filter_reads — BAM record
decode, quality-end trimming, adapter trimming, N/quality screens and the
haplotype-generation eligibility predicates (reference:
src/bam_processor.cpp:173-474, src/bam_io.cpp trims,
src/alignment_filters.cpp) — runs in ONE native call per (locus, BAM) via
native/bam_filter.cpp, which also precomputes the region±40 trim used by
left alignment.  This module replays the stateful mate-pairing machine over
the columnar verdicts and materializes lightweight FilterRead objects
(BamAlign-compatible surface) only for surviving records.

Falls back to the object path (processor.read_and_filter_reads) when the
native entry is unavailable, a record overflows the columnar strides, or
the --pass-bam/--filt-bam writers need full records.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .adapter_trimmer import (MAX_ERROR_RATE, MIN_OVERLAP, NEXTERA_R1,
                              NEXTERA_R2, TRUSEQ_R1, TRUSEQ_R2,
                              reverse_complement)

_ADAPTERS = tuple(
    a.encode() for a in
    (TRUSEQ_R1, NEXTERA_R1, TRUSEQ_R2, NEXTERA_R2,
     reverse_complement(TRUSEQ_R1), reverse_complement(NEXTERA_R1),
     reverse_complement(TRUSEQ_R2), reverse_complement(NEXTERA_R2)))


class _RecLite:
    """The .rec surface downstream consumers touch (original coords)."""

    __slots__ = ("pos", "mate_pos", "flag")

    def __init__(self, pos: int, mate_pos: int, flag: int):
        self.pos = pos
        self.mate_pos = mate_pos
        self.flag = flag

    @property
    def is_paired(self) -> bool:
        return bool(self.flag & 0x1)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & 0x10)

    @property
    def is_first_mate(self) -> bool:
        return bool(self.flag & 0x40)

    @property
    def is_second_mate(self) -> bool:
        return bool(self.flag & 0x80)


class FilterRead:
    """BamAlign-compatible read built from the columnar filter output.

    CIGARs and aux tags are LAZY: the constructor stores row indices into
    per-locus copies of the columnar pools (`_LocusPools`), and the
    `cigar` property / `get_tag` materialize python objects only when a
    consumer actually reads them (mate reads' cigars and most tags are
    never touched outside SNP-phasing mode)."""

    __slots__ = ("pos", "end_pos", "bases", "quals", "_cigar", "name",
                 "filename", "ref_name", "pass_two", "rec", "_tags",
                 "_trim2", "_matches_ref", "_qual_sum", "_pools", "_row",
                 "_samp", "_lib")

    def __init__(self, pos, end_pos, bases, quals, name, filename,
                 ref_name, rec, trim2, matches_ref, pools, row):
        self.pos = pos
        self.end_pos = end_pos
        self.bases = bases
        self.quals = quals
        self._cigar = None
        self.name = name
        self.filename = filename
        self.ref_name = ref_name
        self.rec = rec
        self._tags = None
        self._trim2 = trim2          # (pos2, end2, l2, r2) or None
        self._matches_ref = matches_ref
        self._qual_sum = None        # memoized sum_log_prob_correct
        self._pools = pools
        self._row = row
        self.pass_two = "0"

    @property
    def length(self) -> int:
        return len(self.bases)

    @property
    def cigar(self):
        c = self._cigar
        if c is None:
            p = self._pools
            i = self._row
            nc = p.n_cig[i]
            c = self._cigar = list(zip(
                p.cig_n[i, :nc].tolist(),
                p.cig_op[i, :nc].tobytes().decode("latin1")))
        return c

    @cigar.setter
    def cigar(self, value):
        self._cigar = value

    def get_tag(self, tag: str):
        t = self._tags
        if t is not None:
            return t.get(tag)
        # single-tag fast paths straight off the columnar pools: the hot
        # consumers (_get_rg/_get_library, XA uniqueness, AS/XS gap) each
        # read one tag per read, so building the full dict is wasted work
        p = self._pools
        i = self._row
        if tag == "RG":
            ro = p.rg_off[i]
            ln = p.rg_len[i]
            if ln or ro:
                return p.blob_s[ro:ro + ln]
            return None
        if tag == "XA":
            xo = p.xa_off[i]
            return p.blob_s[xo:xo + p.xa_len[i]] if xo else None
        if tag == "SA":
            so = p.sa_off[i]
            return p.blob_s[so:so + p.sa_len[i]] if so else None
        if tag == "AS":
            return int(p.as_val[i]) if p.as_has[i] else None
        if tag == "XS":
            return int(p.xs_val[i]) if p.xs_has[i] else None
        if tag == "HP":
            return int(p.hp_val[i]) if p.hp_has[i] else None
        t = self._tags = p.tags_for(i)
        return t.get(tag)

    def matches_reference(self) -> bool:
        return self._matches_ref

    def trim_alignment(self, min_read_start: int, max_read_stop: int,
                       min_base_qual: str = "~") -> None:
        """Swap in the precomputed region±40 trim (left_align_reads is the
        only caller on this class; the window is fixed per locus)."""
        t = self._trim2
        assert t is not None, "no precomputed trim for this read"
        pos2, end2, l2, r2 = t
        self.pos = pos2
        self.end_pos = end2
        if l2 or r2:
            self.bases = self.bases[l2:len(self.bases) - r2]
            self.quals = self.quals[l2:len(self.quals) - r2]
        p = self._pools
        i = self._row
        nc2 = p.n_cig2[i]
        self._cigar = list(zip(
            p.cig2_n[i, :nc2].tolist(),
            p.cig2_op[i, :nc2].tobytes().decode("latin1")))


class _LocusPools:
    """Per-(locus, BAM) copies of the columnar rows FilterReads reference
    lazily.  The native output buffers are thread-local and reused across
    calls, so the kept columns are snapshotted here once per locus (bulk
    numpy copies) instead of per read."""

    __slots__ = ("cig_op", "cig_n", "n_cig", "cig2_op", "cig2_n", "n_cig2",
                 "blob_s", "rg_off", "rg_len", "xa_off", "xa_len",
                 "sa_off", "sa_len", "as_val", "as_has", "xs_val", "xs_has",
                 "hp_val", "hp_has")

    def __init__(self, o, blob_s):
        self.cig_op = o["cig_op"].copy()
        self.cig_n = o["cig_n"].copy()
        self.n_cig = o["n_cig"].copy()
        self.cig2_op = o["cig2_op"].copy()
        self.cig2_n = o["cig2_n"].copy()
        self.n_cig2 = o["n_cig2"].copy()
        self.blob_s = blob_s
        self.rg_off = o["rg_off"].copy()
        self.rg_len = o["rg_len"].copy()
        self.xa_off = o["xa_off"].copy()
        self.xa_len = o["xa_len"].copy()
        self.sa_off = o["sa_off"].copy()
        self.sa_len = o["sa_len"].copy()
        self.as_val = o["as_val"].copy()
        self.as_has = o["as_has"].copy()
        self.xs_val = o["xs_val"].copy()
        self.xs_has = o["xs_has"].copy()
        self.hp_val = o["hp_val"].copy()
        self.hp_has = o["hp_has"].copy()

    def tags_for(self, i: int) -> dict:
        tags = {}
        blob_s = self.blob_s
        if self.rg_len[i] or self.rg_off[i]:
            ro = self.rg_off[i]
            tags["RG"] = blob_s[ro:ro + self.rg_len[i]]
        if self.xa_off[i]:
            xo = self.xa_off[i]
            tags["XA"] = blob_s[xo:xo + self.xa_len[i]]
        if self.sa_off[i]:
            so = self.sa_off[i]
            tags["SA"] = blob_s[so:so + self.sa_len[i]]
        if self.as_has[i]:
            tags["AS"] = int(self.as_val[i])
        if self.xs_has[i]:
            tags["XS"] = int(self.xs_val[i])
        if self.hp_has[i]:
            tags["HP"] = int(self.hp_val[i])
        return tags


def read_and_filter_reads_fast(pipeline, region, chrom_seq: str):
    """Columnar-native replacement for read_and_filter_reads; returns the
    same (rg_names, paired_by_rg, mates_by_rg, unpaired_by_rg, too_many)
    tuple, or None to signal the caller to use the object path."""
    from .. import native as _native
    opts = pipeline.opts
    if pipeline.pass_writer is not None or pipeline.filt_writer is not None:
        return None   # full-record writers need the object path
    lib = _native._load()
    if lib is None or not hasattr(lib, "bam_filter_batch"):
        return None

    chrom_b = getattr(pipeline, "_chrom_seq_bytes", None)
    if chrom_b is None or pipeline.__dict__.get("_chrom_seq_for") \
            is not chrom_seq:
        chrom_b = chrom_seq.encode("latin1")
        pipeline._chrom_seq_bytes = chrom_b
        pipeline._chrom_seq_for = chrom_seq

    g_start, g_stop = region.start, region.stop
    mate_dist = opts.max_mate_dist
    qual_trim = opts.base_qual_trim
    trim2_min = region.start - 40 if region.start > 40 else 1
    trim2_max = region.stop + 40

    paired_strs: List[FilterRead] = []
    mate_alns: List[FilterRead] = []
    unpaired_strs: List[FilterRead] = []
    potential_strs: Dict[str, FilterRead] = {}
    potential_mates: Dict[str, FilterRead] = {}
    too_many_reads = False
    trimmer = pipeline.adapter_trimmer

    for file_index, rdr in enumerate(pipeline.readers):
        raw = getattr(rdr, "fetch_raw", lambda *a: None)(
            region.chrom, max(0, g_start - mate_dist), g_stop + mate_dist)
        if raw is None:
            return None
        blob, offs, lens, rid = raw
        potential_mates.clear()
        label = f"{file_index + 1}_"
        if not offs:
            continue
        o = _native.bam_filter_batch_native(
            blob, offs, lens,
            max(0, g_start - mate_dist), g_stop + mate_dist,
            g_start, g_stop, rid,
            ord(qual_trim[0]) if qual_trim else 0,
            trim2_min, trim2_max, chrom_b,
            5, 15, 10, 7,                       # MIN_FLANK/WINDOW/END/INDEL
            trimmer.trim, _ADAPTERS, MIN_OVERLAP, MAX_ERROR_RATE)
        if o is None:
            return None
        if (o["rec_err"] == 1).any():
            return None                          # stride overflow: fallback
        status = o["status"]
        n = len(status)
        # adapter-trimming statistics (cosmetic summary parity)
        acls = o["adapter_class"]
        abases = o["adapter_trim_bases"]
        for cls, attr in ((1, "r1"), (2, "r2")):
            m = acls == cls
            setattr(trimmer, attr + "_total_reads",
                    getattr(trimmer, attr + "_total_reads") + int(m.sum()))
            setattr(trimmer, attr + "_trimmed_reads",
                    getattr(trimmer, attr + "_trimmed_reads")
                    + int((m & (abases > 0)).sum()))
            setattr(trimmer, attr + "_trimmed_bases",
                    getattr(trimmer, attr + "_trimmed_bases")
                    + int(abases[m].sum()))

        overlaps_a = o["overlaps"]
        has_n_a = o["has_n"]
        seq_pool = o["seq_pool"]
        qual_pool = o["qual_pool"]
        seq_len = o["seq_len"]
        # qual-sum screen: the native cascade computes per-read sums with
        # numpy's exact pairwise reduction tree (np_pairwise_sum in
        # native/bam_filter.cpp), so the values are bit-identical to the
        # old per-row np.sum and to BaseQuality.sum_log_prob_correct
        cand_mask = (status == 4) & (overlaps_a == 1) & (has_n_a == 0)
        qsum_native = o["qual_sum"]
        qsum_arr = np.where(cand_mask, qsum_native, np.nan)
        pass_one = cand_mask & (qsum_native >= -10.0)
        if ((o["rec_err"] == 2) & pass_one).any():
            raise AssertionError("improper CIGAR in end-match scan")
        pass_two_a = ((o["p2_flank_ok"] == 1) & (o["p2_largest_ok"] == 1)
                      & (o["p2_endmatch_ok"] == 1) & (o["p2_indel_ok"] == 1))

        # bulk-decode the string pools once: per-read str slicing beats a
        # tobytes().decode() pair per field per read
        blob_s = blob.decode("latin1")
        seq_stride = seq_pool.shape[1]
        seq_all = seq_pool.tobytes().decode("latin1")
        qual_all = qual_pool.tobytes().decode("latin1")
        pools = _LocusPools(o, blob_s)

        # convert the per-record scalar columns to python lists once (a
        # numpy scalar extraction per field per read costs more than the
        # whole bulk conversion)
        names = o["name_off"].tolist()
        name_lens = o["name_len"].tolist()
        flags = o["flag"].tolist()
        pos_l = o["pos"].tolist()
        end_l = o["end_pos"].tolist()
        opos_l = o["orig_pos"].tolist()
        mpos_l = o["mate_pos"].tolist()
        pos2_l = o["pos2"].tolist()
        end2_l = o["end2"].tolist()
        l2_l = o["l2"].tolist()
        r2_l = o["r2"].tolist()
        n_cig2 = o["n_cig2"].tolist()
        mref_l = o["matches_ref"].tolist()
        seq_len_l = seq_len.tolist()
        filename = rdr.path
        ref_name = region.chrom

        # per-read sample + library resolved ONCE per unique RG (vectorized
        # over the locus) instead of a tag slice + key concat per read
        samp_l = lib_l = None
        if pipeline.use_bam_rgs:
            # only candidate rows (status == 4) ever get built; other rows
            # may carry stale buffer values in the rg columns
            cand = status == 4
            ro64 = o["rg_off"].astype(np.int64)
            rl64 = o["rg_len"].astype(np.int64)
            sane = bool(((rl64 >= 0) & (rl64 < (1 << 20))
                         & (ro64 >= 0))[cand].all()) if cand.any() else True
            if sane:
                rg_keys = np.where(cand, (ro64 << 20) + rl64, -1)
                uniq_rg, inv_rg = np.unique(rg_keys, return_inverse=True)
                u_samp, u_lib = [], []
                ok = True
                for u in uniq_rg.tolist():
                    if u < 0:
                        u_samp.append("")   # masked rows are never built
                        u_lib.append("")
                        continue
                    off, ln = u >> 20, u & ((1 << 20) - 1)
                    if not (ln or off):
                        ok = False          # missing RG: per-read path raises
                        break
                    key = filename + blob_s[off:off + ln]
                    sm = pipeline.rg_to_sample.get(key)
                    if sm is None:
                        ok = False
                        break
                    u_samp.append(sm)
                    u_lib.append(pipeline.rg_to_library.get(key, ""))
                if ok:
                    samp_l = [u_samp[j] for j in inv_rg.tolist()]
                    lib_l = [u_lib[j] for j in inv_rg.tolist()]
        else:
            s0 = pipeline.rg_to_sample.get(filename)
            l0 = pipeline.rg_to_library.get(filename, "")
            if s0 is not None:
                samp_l = [s0] * n
                lib_l = [l0] * n

        def build(i: int) -> FilterRead:
            no = names[i]
            nm = blob_s[no:no + name_lens[i]]
            L = seq_len_l[i]
            base = i * seq_stride
            bases = seq_all[base:base + L]
            quals = qual_all[base:base + L]
            trim2 = None
            if n_cig2[i] >= 0:
                trim2 = (pos2_l[i], end2_l[i], l2_l[i], r2_l[i])
            rec = _RecLite(opos_l[i], mpos_l[i], flags[i])
            fr = FilterRead(pos_l[i], end_l[i], bases, quals,
                            nm, filename, ref_name, rec,
                            trim2, bool(mref_l[i]), pools, i)
            if samp_l is not None:
                fr._samp = samp_l[i]
                fr._lib = lib_l[i]
            q = qsum_arr[i]
            if q == q:                     # seed the PCR-dedup memo
                fr._qual_sum = float(q)
            return fr

        status_l = status.tolist()
        overlaps_l = overlaps_a.tolist()
        pass_one_l = pass_one.tolist()
        pass_two_l = pass_two_a.tolist()

        # single-BAM loci: the whole pairing state machine runs in ONE
        # native call (native/pair_reads.cpp); objects are built only for
        # the emitted rows, each row once (matching the Python loop's
        # object identities)
        pres = None
        if len(pipeline.readers) == 1:
            pres = _native.pair_filter_batch_native(
                blob, o, pass_one, region.chrom, opts.max_mate_dist,
                opts.max_reads, opts.use_unpaired)
        if pres is not None:
            ps, pm, unp, too_many_reads = pres
            built: Dict[int, FilterRead] = {}

            def row_obj(i: int) -> FilterRead:
                fr = built.get(i)
                if fr is None:
                    fr = built[i] = build(i)
                    if overlaps_l[i] and pass_one_l[i]:
                        fr.pass_two = "1" if pass_two_l[i] else "0"
                return fr

            paired_strs = [row_obj(i) for i in ps.tolist()]
            mate_alns = [row_obj(i) for i in pm.tolist()]
            unpaired_strs = [row_obj(i) for i in unp.tolist()]
            break

        trim_name = pipeline._trim_name
        valid_pairing = pipeline._valid_pairing
        for i in range(n):
            st = status_l[i]
            if st == 0:
                continue
            if len(paired_strs) > opts.max_reads:
                too_many_reads = True
                break
            if st != 4:
                continue   # silent skips and HARD_CLIPPED
            aln = build(i)
            aln_key = label + trim_name(aln.name)
            if overlaps_l[i]:
                p1 = pass_one_l[i]
                if p1:
                    aln.pass_two = "1" if pass_two_l[i] else "0"
                    mate = potential_mates.pop(aln_key, None)
                    if mate is not None:
                        if mate.rec.is_first_mate == aln.rec.is_first_mate:
                            potential_strs[aln_key] = aln
                            continue
                        if valid_pairing(aln, mate):
                            paired_strs.append(aln)
                            mate_alns.append(mate)
                    else:
                        other = potential_strs.get(aln_key)
                        if other is not None:
                            if other.rec.is_first_mate == aln.rec.is_first_mate:
                                continue
                            del potential_strs[aln_key]
                            if valid_pairing(aln, other):
                                paired_strs.append(aln)
                                mate_alns.append(other)
                                paired_strs.append(other)
                                mate_alns.append(aln)
                        else:
                            potential_strs[aln_key] = aln
                else:
                    potential_mates[aln_key] = aln
            else:
                other = potential_strs.get(aln_key)
                if other is not None:
                    if other.rec.is_first_mate == aln.rec.is_first_mate:
                        continue
                    del potential_strs[aln_key]
                    if valid_pairing(other, aln):
                        paired_strs.append(other)
                        mate_alns.append(aln)
                else:
                    prev = potential_mates.get(aln_key)
                    if prev is not None:
                        if prev.rec.is_first_mate != aln.rec.is_first_mate:
                            del potential_mates[aln_key]
                    else:
                        potential_mates[aln_key] = aln
        if too_many_reads:
            break

    # leftover unpaired reads in key-sorted order (reference std::map
    # semantics, bam_processor.cpp:183,408-425)
    for aln_key in sorted(potential_strs):
        aln = potential_strs[aln_key]
        if aln.get_tag("XA") is not None:
            continue
        if not opts.use_unpaired:
            continue
        unpaired_strs.append(aln)

    # group by read group / sample in reversed accumulation order
    # (reference pops off the back, bam_processor.cpp:440-470)
    rg_indices: Dict[str, int] = {}
    rg_names: List[str] = []
    paired_by_rg: List[List[FilterRead]] = []
    mates_by_rg: List[List[FilterRead]] = []
    unpaired_by_rg: List[List[FilterRead]] = []
    for kind, src, mates in ((0, paired_strs, mate_alns),
                             (1, unpaired_strs, None)):
        for i in range(len(src) - 1, -1, -1):
            aln = src[i]
            rg = pipeline._get_rg(aln)
            if rg not in rg_indices:
                rg_indices[rg] = len(rg_names)
                rg_names.append(rg)
                paired_by_rg.append([])
                mates_by_rg.append([])
                unpaired_by_rg.append([])
            k = rg_indices[rg]
            if kind == 0:
                paired_by_rg[k].append(aln)
                mates_by_rg[k].append(mates[i])
            else:
                unpaired_by_rg[k].append(aln)

    return (rg_names, paired_by_rg, mates_by_rg, unpaired_by_rg,
            too_many_reads)
