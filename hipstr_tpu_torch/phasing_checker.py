"""Copy of hipstr_tpu/phasing_checker.py.

PhasingChecker command line interface.

Capability parity with the reference PhasingChecker (reference:
src/check_phasing.cpp:27-226): per BED region, advance the family SNP
haplotype tracker and write child<->parent haplotype edit distances with a
PASS/FAIL inheritance-confidence verdict.
"""

from __future__ import annotations

import argparse
import sys

from .io.bgzf import BgzfWriter
from .io.regions import read_regions
from .io.vcf_read import VCFReader
from .phasing.haplotype_tracker import HaplotypeTracker
from .phasing.pedigree import extract_pedigree_nuclear_families

MAX_BEST_SCORE = 10
MIN_SECOND_BEST_SCORE = 100
WINDOW_SIZE = 500000


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="phasing-checker-tpu",
        description="Compute SNP-haplotype edit distances within families")
    ap.add_argument("--fam", required=True)
    ap.add_argument("--snp-vcf", required=True)
    ap.add_argument("--regions", required=True)
    ap.add_argument("--out", required=True, help="Output path (.gz -> bgzf)")
    args = ap.parse_args(argv)

    snp_vcf = VCFReader(args.snp_vcf)
    families = extract_pedigree_nuclear_families(args.fam,
                                                 set(snp_vcf.samples))
    regions = read_regions(args.regions)
    tracker = HaplotypeTracker(families, snp_vcf, WINDOW_SIZE)

    if args.out.endswith(".gz"):
        sink = BgzfWriter(args.out)
        write = lambda s: sink.write(s.encode())
    else:
        sink = open(args.out, "w")
        write = sink.write

    header = ["#CHROM", "POS"]
    for fam in families:
        header.extend(fam.children)
    write("\t".join(header) + "\n")

    def min2(d):
        flat = sorted(range(4), key=lambda i: (d.reshape(-1)[i], i))
        v = d.reshape(-1)
        return int(v[flat[0]]), flat[0], int(v[flat[1]])

    for region in regions:
        parts = [region.chrom, str(region.start)]
        tracker.advance(region.chrom, region.start)
        for fam in families:
            all_pass = True
            dists = []
            for child in fam.children:
                md = tracker.edit_distances(child, fam.mother)
                pd = tracker.edit_distances(child, fam.father)
                dists.append((md, pd))
                mn_m, mi_m, sec_m = min2(md)
                if mn_m > MAX_BEST_SCORE or sec_m < MIN_SECOND_BEST_SCORE:
                    all_pass = False
                mn_p, mi_p, sec_p = min2(pd)
                if mn_p > MAX_BEST_SCORE or sec_p < MIN_SECOND_BEST_SCORE:
                    all_pass = False
                if mi_m in (0, 1):
                    if mi_p not in (2, 3):
                        all_pass = False
                elif mi_p not in (0, 1):
                    all_pass = False
            for md, pd in dists:
                parts.append(
                    ("PASS" if all_pass else "FAIL")
                    + f":{md[0,0]},{md[0,1]},{md[1,0]},{md[1,1]}"
                    + f":{pd[0,0]},{pd[0,1]},{pd[1,0]},{pd[1,1]}")
        write("\t".join(parts) + "\n")

    sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
