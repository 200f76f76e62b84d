"""Copy of hipstr_tpu/scripts/filter_vcf.py.

Post-hoc call-level filtering of STR VCFs.

Capability parity with the reference's scripts/filter_vcf.py and
scripts/filter_haploid_vcf.py (reference: README.md:199-221): per-call
filters on depth, quality, allele depth/ratio, flank-indel and stutter
fractions, allele/strand bias and spanning depth; per-locus filters on total
depth and call count.  Filtered calls are blanked; AN/AC/REFAC/NFILT INFO
fields are recomputed.  Works on plain or bgzipped VCFs without external
dependencies.
"""

from __future__ import annotations

import argparse
import sys

from ..io.bgzf import BgzfWriter
from ..io.vcf_read import VCFReader


def build_parser():
    ap = argparse.ArgumentParser(prog="filter-vcf")
    ap.add_argument("--vcf", required=True)
    ap.add_argument("--out", default="-")
    ap.add_argument("--haploid", action="store_true",
                    help="Expect haploid GT/GB fields")
    ap.add_argument("--min-loc-depth", type=int, default=0)
    ap.add_argument("--max-loc-depth", type=int, default=1000000000)
    ap.add_argument("--min-loc-calls", type=int, default=0)
    ap.add_argument("--min-call-depth", type=int, default=0)
    ap.add_argument("--min-call-qual", type=float, default=0.0)
    ap.add_argument("--min-call-allele-depth", type=float, default=0.0)
    ap.add_argument("--min-call-allele-ratio", type=float, default=0.0)
    ap.add_argument("--max-call-flank-indel", type=float, default=1.0)
    ap.add_argument("--max-call-stutter", type=float, default=1.0)
    ap.add_argument("--min-call-allele-bias", type=float, default=-100.0)
    ap.add_argument("--min-call-strand-bias", type=float, default=-100.0)
    ap.add_argument("--min-call-spanning-depth", type=int, default=0)
    return ap


def filter_call(fields: dict, args, haploid: bool):
    """Returns the failing filter name or None (reference:
    scripts/filter_vcf.py filter_call)."""
    try:
        if int(fields["DP"]) < args.min_call_depth:
            return "DEPTH"
        if float(fields["Q"]) < args.min_call_qual:
            return "QUALITY"
        if not haploid:
            d1, d2 = (float(x) for x in fields["PDP"].split("|"))
            if d1 == 0 or d2 == 0:
                return "ALLELE_DEPTH"
            if min(d1, d2) < args.min_call_allele_depth:
                return "ALLELE_DEPTH"
            if min(d1 / d2, d2 / d1) < args.min_call_allele_ratio:
                return "ALLELE_RATIO"
        dp = int(fields["DP"])
        if args.max_call_flank_indel < 1 and \
                int(fields["DFLANKINDEL"]) / dp > args.max_call_flank_indel:
            return "FLANK_INDELS"
        if args.max_call_stutter < 1 and \
                int(fields["DSTUTTER"]) / dp > args.max_call_stutter:
            return "STUTTER_FRACTION"
        if args.min_call_allele_bias > -100 and "AB" in fields and \
                fields["AB"] not in (".", "") and \
                float(fields["AB"]) < args.min_call_allele_bias:
            return "ALLELE_BIAS"
        if args.min_call_strand_bias > -100 and "FS" in fields and \
                fields["FS"] not in (".", "") and \
                float(fields["FS"]) < args.min_call_strand_bias:
            return "STRAND_BIAS"
        if args.min_call_spanning_depth > 0:
            mall = fields.get("MALLREADS", ".")
            if mall in (".", ""):
                return "SPANNING_DEPTH"
            gb = [int(x) for x in fields["GB"].split("|")]
            depth = {}
            for kv in mall.split(";"):
                k, v = kv.split("|")
                depth[int(k)] = int(v)
            if min(depth.get(g, 0) for g in gb) < args.min_call_spanning_depth:
                return "SPANNING_DEPTH"
    except (KeyError, ValueError):
        return None
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    reader = VCFReader(args.vcf)
    if args.out == "-":
        out = sys.stdout
        write = out.write
        closer = lambda: None
    elif args.out.endswith(".gz"):
        w = BgzfWriter(args.out)
        write = lambda s: w.write(s.encode())
        closer = w.close
    else:
        out = open(args.out, "w")
        write = out.write
        closer = out.close

    for line in reader._lines[:reader._header_end]:
        write(line + "\n")

    for variant in reader:
        info = dict(variant.info)
        dp = int(info.get("DP", "0"))
        if dp < args.min_loc_depth or dp > args.max_loc_depth:
            continue

        fmt = variant.format_keys
        n_alleles = variant.num_alleles()
        allele_counts = [0] * n_alleles
        an = 0
        nfilt = 0
        new_samples = []
        kept = 0
        for sf in variant.sample_fields:
            if len(sf) <= 1 or sf[0].startswith("."):
                new_samples.append(":".join(sf))
                continue
            fields = dict(zip(fmt, sf))
            reason = filter_call(fields, args, args.haploid)
            if reason is not None:
                nfilt += 1
                new_samples.append(".")
                continue
            kept += 1
            gts = [int(x) for x in
                   fields["GT"].replace("|", "/").split("/")]
            for g in gts:
                allele_counts[g] += 1
                an += 1
            new_samples.append(":".join(sf))

        if kept < args.min_loc_calls:
            continue

        info["AN"] = str(an)
        info["REFAC"] = str(allele_counts[0])
        if n_alleles > 1:
            info["AC"] = ",".join(str(c) for c in allele_counts[1:])
        info["NFILT"] = str(int(info.get("NFILT", "0")) + nfilt)
        info_str = ";".join(f"{k}={v}" for k, v in info.items())
        cols = [variant.chrom, str(variant.pos + 1), variant.vid,
                variant.alleles[0],
                ",".join(variant.alleles[1:]) if n_alleles > 1 else ".",
                variant.qual, variant.vfilter, info_str,
                ":".join(fmt)] + new_samples
        write("\t".join(cols) + "\n")
    closer()
    return 0


if __name__ == "__main__":
    sys.exit(main())
