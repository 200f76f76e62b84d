"""Copy of hipstr_tpu/scripts/annotate_denovo.py.

Join DenovoFinder likelihoods back onto a HipSTR genotype VCF.

Capability parity with the reference annotate_vcf_with_denovo_lls.py
(reference: src/denovos/annotate_vcf_with_denovo_lls.py): matching records by
CHROM/POS/alleles, the de novo FORMAT fields are appended to each shared
sample's entry (optionally dropping GL/PL/PHASEDGL).
"""

from __future__ import annotations

import argparse
import sys

from ..io.vcf_read import VCFReader

DROP_FIELDS = {"GL", "PL", "PHASEDGL"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="annotate-denovo")
    ap.add_argument("--vcf", required=True, help="HipSTR genotype VCF")
    ap.add_argument("--denovo-ll-vcf", required=True,
                    help="DenovoFinder output VCF (trio scan)")
    ap.add_argument("--keep-gls", action="store_true")
    ap.add_argument("--out", default="-")
    args = ap.parse_args(argv)

    gt = VCFReader(args.vcf)
    ll = VCFReader(args.denovo_ll_vcf)
    shared = set(gt.samples) & set(ll.samples)
    if not shared:
        print("ERROR: no shared samples between the two VCFs", file=sys.stderr)
        return 1

    out = sys.stdout if args.out == "-" else open(args.out, "w")
    for line in gt._lines[:gt._header_end]:
        if line.startswith("#CHROM"):
            for extra in ll._lines[:ll._header_end]:
                if extra.startswith("##FORMAT"):
                    out.write(extra + "\n")
        out.write(line + "\n")

    ll_by_key = {}
    for v in ll:
        ll_by_key[(v.chrom, v.pos, tuple(v.alleles))] = v

    for v in gt:
        llv = ll_by_key.get((v.chrom, v.pos, tuple(v.alleles)))
        fmt = list(v.format_keys)
        keep_idx = [i for i, k in enumerate(fmt)
                    if args.keep_gls or k not in DROP_FIELDS]
        new_fmt = [fmt[i] for i in keep_idx]
        denovo_fmt = llv.format_keys if llv is not None else []
        cols = [v.chrom, str(v.pos + 1), v.vid, v.alleles[0],
                ",".join(v.alleles[1:]) if v.num_alleles() > 1 else ".",
                v.qual, v.vfilter,
                ";".join(f"{k}={val}" if val else k
                         for k, val in v.info.items()),
                ":".join(new_fmt + denovo_fmt)]
        for s in gt.samples:
            si = v._sample_index[s]
            parts = v.sample_fields[si]
            base = [parts[i] if i < len(parts) else "."
                    for i in keep_idx] if len(parts) > 1 or parts[0] != "." \
                else ["."] * len(new_fmt)
            if llv is not None and s in llv._sample_index:
                lparts = llv.sample_fields[llv._sample_index[s]]
                if len(lparts) == 1 and lparts[0] == ".":
                    lparts = ["."] * len(denovo_fmt)
                base += lparts
            else:
                base += ["."] * len(denovo_fmt)
            cols.append(":".join(base))
        out.write("\t".join(cols) + "\n")
    if out is not sys.stdout:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
