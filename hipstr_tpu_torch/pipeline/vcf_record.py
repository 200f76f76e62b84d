"""Copy of hipstr_tpu/pipeline/vcf_record.py.

Per-locus VCF record construction.

Port of SeqStutterGenotyper::write_vcf_record + get_alleles + reorder_alleles
(reference: src/seq_stutter_genotyper.cpp:673-769, :984-1540), producing the
record text with the reference's field set and %.2f float formatting.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..align.alignment_data import extract_cigar_bp_diff
from ..ops import posteriors as post_ops
from ..utils.mathops import LOG_ONE_HALF
from .special import allele_bias_pvalue, fisher_strand_pvalue

TOLERANCE = 1e-10
STRAND_TOLERANCE = 0.1


@dataclass
class OutputConfig:
    """Mirrors the Genotyper static output switches
    (reference: src/genotyper.cpp:336-343)."""

    output_gls: bool = False
    output_pls: bool = False
    output_phased_gls: bool = False
    output_allreads: bool = True
    output_mallreads: bool = True
    output_filters: bool = False
    output_haplotype_data: bool = False
    max_flank_indel_frac: float = 0.15
    viz_out: bool = False
    viz_left_alns: bool = False


def _order_key(seq: str):
    return (len(seq), seq)


def get_alleles(genotyper, region, block_index: int) -> Tuple[int, List[str], Tuple[int, int]]:
    """Trim block alleles to VCF coordinates; returns (pos_1based, alleles,
    (left_trim, right_trim)).  Reference: seq_stutter_genotyper.cpp:691-769."""
    block = genotyper.haplotype.blocks[block_index]
    chrom_seq = genotyper.chrom_seq
    alleles = [block.get_seq(i) for i in range(block.num_options())]

    left_trim = 0
    start = block.start
    while start + left_trim < region.start:
        trim = True
        for a in alleles:
            if left_trim + 1 >= len(a) or a[left_trim] != alleles[0][left_trim]:
                trim = False
                break
        if not trim:
            break
        left_trim += 1
    start += left_trim
    alleles = [a[left_trim:] for a in alleles]

    right_trim = 0
    end = block.end
    while end - right_trim > region.stop:
        trim = True
        ref_size = len(alleles[0])
        for a in alleles:
            if right_trim + 1 >= len(a) or \
                    a[len(a) - right_trim - 1] != alleles[0][ref_size - right_trim - 1]:
                trim = False
                break
        if not trim:
            break
        right_trim += 1
    end -= right_trim
    alleles = [a[:len(a) - right_trim] for a in alleles]

    left_flank = chrom_seq[region.start:start].upper() if start >= region.start else ""
    right_flank = chrom_seq[end:region.stop].upper() if end <= region.stop else ""
    pos = min(region.start, start)
    left_trim -= len(left_flank)
    right_trim -= len(right_flank)

    if not left_flank:
        pad_left = any((not a) or a[0] != alleles[0][0] for a in alleles[1:])
        if pad_left:
            pos -= 1
            left_trim -= 1
            left_flank = chrom_seq[pos:pos + 1].upper()

    alleles = [left_flank + a + right_flank for a in alleles]
    return pos + 1, alleles, (left_trim, right_trim)


def reorder_alleles(alleles: List[str]) -> Tuple[List[int], List[int]]:
    """Sort alts by (length, sequence); reference:
    seq_stutter_genotyper.cpp:673-689."""
    old_indices = {a: i for i, a in enumerate(alleles)}
    new_alleles = [alleles[0]] + sorted(alleles[1:], key=_order_key)
    old_to_new = [-1] * len(alleles)
    new_to_old = []
    for i, a in enumerate(new_alleles):
        oi = old_indices[a]
        new_to_old.append(oi)
        old_to_new[oi] = i
    return old_to_new, new_to_old


def _f(x: float) -> str:
    return f"{x:.2f}"


@dataclass
class RecordStats:
    filter_reasons: Dict[str, int] = field(default_factory=dict)
    num_alleles: int = 0
    viz_data: Optional[list] = None
    sample_gb: Dict[str, str] = field(default_factory=dict)


def build_vcf_record(g, sample_names: List[str],
                     cfg: OutputConfig) -> Tuple[str, int, str, RecordStats]:
    """Build the record for the (single) repeat block of genotyper `g`.

    Returns (chrom, pos_1based, record_text_without_chrom_pos_id?,...) —
    actually the full tab-joined record line, plus stats.
    """
    region = g.region
    block_index = next(i for i, b in enumerate(g.haplotype.blocks) if b.is_repeat)
    pos, alleles, trimmings = get_alleles(g, region, block_index)

    allele_bp_diffs = [len(a) - len(alleles[0]) for a in alleles]

    # --output-hap-fields: flank sequences adjusted for the bases moved
    # in/out of the repeat block by get_alleles trimming (reference:
    # seq_stutter_genotyper.cpp:1008-1041)
    lflank_seqs = rflank_seqs = None
    hap_to_lflank = hap_to_rflank = None
    if cfg.output_haplotype_data and len(g.haplotype.blocks) == 3:
        ref_str_seq = g.haplotype.blocks[block_index].get_seq(0)
        lt, rt = trimmings
        hap_to_lflank = g.haps_to_alleles(0)
        lb = g.haplotype.blocks[0]
        lflank_seqs = []
        for i in range(lb.num_options()):
            seq = lb.get_seq(i)
            lflank_seqs.append(seq[:len(seq) + lt] if lt < 0
                               else seq + ref_str_seq[:lt])
        hap_to_rflank = g.haps_to_alleles(2)
        rb = g.haplotype.blocks[2]
        rflank_seqs = []
        for i in range(rb.num_options()):
            seq = rb.get_seq(i)
            if rt < 0:
                rflank_seqs.append(seq[-rt:])
            elif rt > 0:
                rflank_seqs.append(ref_str_seq[len(ref_str_seq) - rt:] + seq)
            else:
                rflank_seqs.append(seq)

    hap_to_allele = g.haps_to_alleles(block_index)
    num_variants = g.haplotype.blocks[block_index].num_options()
    ext = post_ops.extract_genotypes(
        g.log_post, g.sample_total_LLs, hap_to_allele, num_variants,
        g.haploid, g.num_alleles, calc_gls=True, calc_pls=cfg.output_pls,
        calc_phased_gls=cfg.output_phased_gls)

    S = g.num_samples
    # per-read stats over reads with a valid alignment seed, vectorized
    # (reference per-read loop: seq_stutter_genotyper.cpp:1102-1166)
    seed_ok = np.asarray(g.seed_positions) >= 0
    ridx = np.nonzero(seed_ok)[0]
    samp = g.sample_label[ridx]
    LAP = g.log_aln_probs
    ha = ext.best_hap_a[samp].astype(np.int64)
    hb = ext.best_hap_b[samp].astype(np.int64)
    p1 = g.log_p1[ridx]
    p2 = g.log_p2[ridx]
    a1 = LAP[ridx, ha]
    a2 = LAP[ridx, hb]
    v1 = LOG_ONE_HALF + p1 + a1
    v2 = LOG_ONE_HALF + p2 + a2
    total = np.logaddexp(v1, v2)
    phase_vals = v1 - total

    num_aligned = np.bincount(samp, minlength=S)
    w_gap = (p1 + a1) - (p2 + a2)
    considered = ((not g.haploid)
                  & ((ha != hb) | (np.abs(p1 - p2) > TOLERANCE))
                  & (np.abs(w_gap) > STRAND_TOLERANCE))
    uniq1 = considered & (w_gap > 0)
    uniq2 = considered & ~(w_gap > 0)
    rev = g.rev_strand_flags()[ridx]
    uniq_hap_one = np.bincount(samp[uniq1], minlength=S)
    uniq_hap_two = np.bincount(samp[uniq2], minlength=S)
    rv_uniq_hap_one = np.bincount(samp[uniq1 & rev], minlength=S)
    rv_uniq_hap_two = np.bincount(samp[uniq2 & rev], minlength=S)
    read_strand = uniq2.astype(np.int8)
    best_hap = np.where(uniq2, hb, ha)

    snp_mask = np.abs(p1 - p2) > TOLERANCE
    num_with_snps = np.bincount(samp[snp_mask], minlength=S)
    num_strand_one = np.bincount(samp[snp_mask & (p1 > p2)], minlength=S)
    num_strand_two = np.bincount(samp[snp_mask & ~(p1 > p2)], minlength=S)

    # trace summaries per unique (pool, best_hap) pair
    (t_has_stut, t_flank, t_start, t_stop,
     t_totstut, t_rows) = g.summary_stats_for(ridx, best_hap)
    num_with_stutter = np.bincount(samp[t_has_stut], minlength=S)
    num_with_flank_indels = np.bincount(samp[t_flank], minlength=S)

    bps_per_sample: List[List[int]] = [[] for _ in range(S)]
    ml_bps_per_sample: List[List[int]] = [[] for _ in range(S)]
    lo_bound = region.start - 4 if region.start > 4 else 0
    span_ml = (t_start < lo_bound) & (t_stop > region.stop + 4)
    ml_vals = (np.asarray(allele_bp_diffs)[hap_to_allele[best_hap]]
               + t_totstut)
    for k in np.nonzero(span_ml)[0].tolist():
        ml_bps_per_sample[samp[k]].append(int(ml_vals[k]))
    for k, i in enumerate(ridx.tolist()):
        aln = g.alns[i]
        bp_diff = extract_cigar_bp_diff(
            aln.cigar, aln.start,
            region.start - region.period, region.stop + region.period)
        if bp_diff is not None:
            bps_per_sample[samp[k]].append(bp_diff)

    viz_alns: List[list] = None
    if cfg.viz_out:
        # --viz-left-alns renders the left-aligned input alignments
        # instead of the ML-traced ones (reference:
        # seq_stutter_genotyper.cpp:1129-1130, 1521-1527)
        viz_alns = [[] for _ in range(S)]
        for k, i in enumerate(ridx.tolist()):
            viz_alns[samp[k]].append(
                (int(read_strand[k]),
                 g.alns[i] if cfg.viz_left_alns
                 else g.trace_store.summary(int(t_rows[k])).traced_aln))

    # allele counts
    interest = set(sample_names)
    allele_counts = [0] * len(alleles)
    skip_count = filt_count = allele_number = 0
    for s in range(S):
        if g.sample_names[s] not in interest:
            continue
        if num_aligned[s] == 0:
            continue
        if num_aligned[s] > 0 and \
                num_with_flank_indels[s] > cfg.max_flank_indel_frac * num_aligned[s]:
            filt_count += 1
            continue
        if not g.call_sample[s]:
            ga, gb = int(ext.best_gt_a[s]), int(ext.best_gt_b[s])
            if g.haploid:
                allele_counts[ga] += 1
                allele_number += 1
            else:
                allele_counts[ga] += 1
                allele_counts[gb] += 1
                allele_number += 2
        else:
            skip_count += 1

    old_to_new, new_to_old = reorder_alleles(alleles)

    out = []
    out.append(f"{region.chrom}\t{pos}\t{region.name or '.'}")
    out.append("\t" + alleles[new_to_old[0]] + "\t")
    if len(alleles) == 1:
        out.append(".")
    else:
        out.append(",".join(alleles[new_to_old[i]] for i in range(1, len(alleles))))
    out.append("\t.\t.")

    sm = g.haplotype.blocks[block_index].repeat_info.stutter_model
    info = (f"\tINFRAME_PGEOM={_f(sm.in_geom)};INFRAME_UP={_f(sm.in_up)};"
            f"INFRAME_DOWN={_f(sm.in_down)};OUTFRAME_PGEOM={_f(sm.out_geom)};"
            f"OUTFRAME_UP={_f(sm.out_up)};OUTFRAME_DOWN={_f(sm.out_down)};"
            f"START={region.start + 1};END={region.stop};PERIOD={region.period};"
            f"NSKIP={skip_count};NFILT={filt_count};")
    if len(alleles) > 1:
        info += "BPDIFFS=" + ",".join(
            str(allele_bp_diffs[new_to_old[i]]) for i in range(1, len(alleles))) + ";"

    tot_dp = tot_dsnp = tot_dstutter = tot_dflank = 0
    for name in sample_names:
        s = g.sample_indices.get(name)
        if s is None or g.call_sample[s]:
            continue
        if num_aligned[s] > 0 and \
                num_with_flank_indels[s] > num_aligned[s] * cfg.max_flank_indel_frac:
            continue
        tot_dp += num_aligned[s]
        tot_dsnp += num_with_snps[s]
        tot_dstutter += num_with_stutter[s]
        tot_dflank += num_with_flank_indels[s]
    info += (f"DP={tot_dp};DSNP={tot_dsnp};DSTUTTER={tot_dstutter};"
             f"DFLANKINDEL={tot_dflank};")
    info += f"AN={allele_number};REFAC={allele_counts[0]}"
    if len(allele_counts) > 1:
        info += ";AC=" + ",".join(
            str(allele_counts[new_to_old[i]]) for i in range(1, len(allele_counts)))

    # LFLANKS/RFLANKS only when a non-ref flank exists (reference:
    # seq_stutter_genotyper.cpp:1269-1286)
    output_lflanks = lflank_seqs is not None and len(lflank_seqs) > 1
    output_rflanks = rflank_seqs is not None and len(rflank_seqs) > 1
    if output_lflanks:
        info += ";LFLANKS=" + ",".join(lflank_seqs)
    if output_rflanks:
        info += ";RFLANKS=" + ",".join(rflank_seqs)
    out.append(info)

    output_allele_bias = (not g.haploid) and g.reassemble_flanks
    output_strand_bias = (not g.haploid) and g.reassemble_flanks

    if not g.haploid:
        fmt = "GT:GB:Q:PQ:DP:DSNP:DSTUTTER:DFLANKINDEL:PDP:PSNP:GLDIFF"
        num_fields = 11
    else:
        fmt = "GT:GB:Q:DP:DSTUTTER:DFLANKINDEL:GLDIFF"
        num_fields = 7
    if output_allele_bias:
        fmt += ":AB:DAB"
    if output_strand_bias:
        fmt += ":FS"
    if cfg.output_allreads:
        fmt += ":ALLREADS"
    if cfg.output_mallreads:
        fmt += ":MALLREADS"
    if cfg.output_gls:
        fmt += ":GL"
    if cfg.output_pls:
        fmt += ":PL"
    if not g.haploid and cfg.output_phased_gls:
        fmt += ":PHASEDGL"
    if cfg.output_haplotype_data:
        if output_lflanks or output_rflanks:
            fmt += ":HQ:PHQ"
        if output_lflanks:
            fmt += ":LFGT"
        if output_rflanks:
            fmt += ":RFGT"
    if cfg.output_filters:
        fmt += ":FILTER"
    out.append("\t" + fmt)

    num_fields += ((2 if output_allele_bias else 0)
                   + (1 if output_strand_bias else 0)
                   + (1 if (not g.haploid and cfg.output_phased_gls) else 0))
    num_fields += (int(cfg.output_allreads) + int(cfg.output_mallreads)
                   + int(cfg.output_gls) + int(cfg.output_pls)
                   + (2 if (output_lflanks or output_rflanks) else 0)
                   + int(output_lflanks) + int(output_rflanks))
    empty_str = ".:" * num_fields

    stats = RecordStats(num_alleles=len(alleles))
    V = len(alleles)

    def condense(diffs: List[int]) -> str:
        if not diffs:
            return "."
        counts: Dict[int, int] = {}
        for d in diffs:
            counts[d] = counts.get(d, 0) + 1
        return ";".join(f"{k}|{v}" for k, v in sorted(counts.items()))

    for name in sample_names:
        out.append("\t")
        s = g.sample_indices.get(name)
        if s is None:
            out.append("." if not cfg.output_filters else empty_str + "NO_READS")
            continue
        if num_aligned[s] == 0:
            stats.filter_reasons["NO_READS"] = stats.filter_reasons.get("NO_READS", 0) + 1
            out.append("." if not cfg.output_filters else empty_str + "NO_READS")
            continue
        if g.call_sample[s]:
            r = g.call_sample[s]
            stats.filter_reasons[r] = stats.filter_reasons.get(r, 0) + 1
            out.append("." if not cfg.output_filters else empty_str + r)
            continue
        if num_aligned[s] > 0 and \
                num_with_flank_indels[s] > num_aligned[s] * cfg.max_flank_indel_frac:
            g.call_sample[s] = "FLANK_INDEL_FRAC"
            stats.filter_reasons["FLANK_INDEL_FRAC"] = \
                stats.filter_reasons.get("FLANK_INDEL_FRAC", 0) + 1
            out.append("." if not cfg.output_filters else empty_str + "FLANK_INDEL_FRAC")
            continue

        phase1_reads = (0.0 if num_aligned[s] == 0 else
                        float(np.exp(_lse(phase_vals[samp == s]))))
        phase2_reads = num_aligned[s] - phase1_reads

        ga, gb = int(ext.best_gt_a[s]), int(ext.best_gt_b[s])
        ha, hb = int(ext.best_hap_a[s]), int(ext.best_hap_b[s])
        stats.sample_gb[name] = f"{allele_bp_diffs[ga]}|{allele_bp_diffs[gb]}"

        ab = 1.01
        fs = 1.01
        if not g.haploid and ha != hb:
            ab = allele_bias_pvalue(int(uniq_hap_one[s]), int(uniq_hap_two[s]))
            fs = fisher_strand_pvalue(
                int(uniq_hap_one[s] - rv_uniq_hap_one[s]), int(rv_uniq_hap_one[s]),
                int(uniq_hap_two[s] - rv_uniq_hap_two[s]), int(rv_uniq_hap_two[s]))

        parts = []
        if not g.haploid:
            parts.append(f"{old_to_new[ga]}|{old_to_new[gb]}")
            parts.append(f"{allele_bp_diffs[ga]}|{allele_bp_diffs[gb]}")
            parts.append(_f(math.exp(ext.log_unphased_post[s])))
            parts.append(_f(math.exp(ext.log_phased_post[s])))
            parts.append(str(num_aligned[s]))
            parts.append(str(num_with_snps[s]))
            parts.append(str(num_with_stutter[s]))
            parts.append(str(num_with_flank_indels[s]))
            parts.append(f"{_f(phase1_reads)}|{_f(phase2_reads)}")
            parts.append(f"{num_strand_one[s]}|{num_strand_two[s]}")
            parts.append("." if V == 1 else _f(ext.gl_diffs[s]))
        else:
            parts.append(str(old_to_new[ga]))
            parts.append(str(allele_bp_diffs[ga]))
            parts.append(_f(math.exp(ext.log_unphased_post[s])))
            parts.append(str(num_aligned[s]))
            parts.append(str(num_with_stutter[s]))
            parts.append(str(num_with_flank_indels[s]))
            parts.append("." if V == 1 else _f(ext.gl_diffs[s]))

        if output_allele_bias:
            if ab > 1:
                parts.append("0")
                parts.append(".")
            else:
                parts.append(_f(ab))
                parts.append(str(int(uniq_hap_one[s] + uniq_hap_two[s])))
        if output_strand_bias:
            parts.append("0" if fs > 1 else _f(fs))
        if cfg.output_allreads:
            parts.append(condense(bps_per_sample[s]))
        if cfg.output_mallreads:
            parts.append(condense(ml_bps_per_sample[s]))

        if g.haploid:
            if cfg.output_gls:
                vals = [ext.gls[s][0]] + [ext.gls[s][new_to_old[i]]
                                          for i in range(1, V)]
                parts.append(",".join(_f(v) for v in vals))
            if cfg.output_pls:
                vals = [ext.pls[s][0]] + [ext.pls[s][new_to_old[i]]
                                          for i in range(1, V)]
                parts.append(",".join(str(int(v)) for v in vals))
        else:
            if cfg.output_gls:
                vals = [ext.gls[s][0]]
                for i in range(1, V):
                    for j in range(0, i + 1):
                        a = min(new_to_old[i], new_to_old[j])
                        b = max(new_to_old[i], new_to_old[j])
                        vals.append(ext.gls[s][b * (b + 1) // 2 + a])
                parts.append(",".join(_f(v) for v in vals))
            if cfg.output_pls:
                vals = [ext.pls[s][0]]
                for i in range(1, V):
                    for j in range(0, i + 1):
                        a = min(new_to_old[i], new_to_old[j])
                        b = max(new_to_old[i], new_to_old[j])
                        vals.append(ext.pls[s][b * (b + 1) // 2 + a])
                parts.append(",".join(str(int(v)) for v in vals))
            if cfg.output_phased_gls:
                vals = [ext.phased_gls[s][0]]
                for i in range(V):
                    for j in range(V):
                        if i == 0 and j == 0:
                            continue
                        vals.append(ext.phased_gls[s][new_to_old[i] * V + new_to_old[j]])
                parts.append(",".join(_f(v) for v in vals))
        if cfg.output_haplotype_data and (output_lflanks or output_rflanks):
            # HQ/PHQ + per-flank genotypes (reference:
            # seq_stutter_genotyper.cpp:1485-1499)
            parts.append(_f(math.exp(ext.hap_log_unphased_post[s])))
            parts.append(_f(math.exp(ext.hap_log_phased_post[s])))
            if not g.haploid:
                if output_lflanks:
                    parts.append(f"{hap_to_lflank[ha]}|{hap_to_lflank[hb]}")
                if output_rflanks:
                    parts.append(f"{hap_to_rflank[ha]}|{hap_to_rflank[hb]}")
            else:
                if output_lflanks:
                    parts.append(str(hap_to_lflank[ha]))
                if output_rflanks:
                    parts.append(str(hap_to_rflank[ha]))
        if cfg.output_filters:
            parts.append("PASS")
        out.append(":".join(parts))

    if viz_alns is not None:
        stats.viz_data = viz_alns
    return region.chrom, pos, "".join(out), stats


def _lse(vals) -> float:
    arr = np.asarray(vals)
    if arr.size == 0:
        return -np.inf
    m = arr.max()
    return float(m + np.log(np.sum(np.exp(arr - m))))
