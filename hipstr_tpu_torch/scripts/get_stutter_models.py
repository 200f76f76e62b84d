"""Copy of hipstr_tpu/scripts/get_stutter_models.py.

Extract per-locus stutter model parameters from a HipSTR VCF into the
--stutter-in file format.

Capability parity with the reference scripts/GetStutterModels (reference:
scripts/GetStutterModels:1-29, a vcftools pipeline).
"""

from __future__ import annotations

import argparse
import sys

from ..io.vcf_read import VCFReader


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="get-stutter-models")
    ap.add_argument("--vcf", required=True)
    ap.add_argument("--out", default="-")
    args = ap.parse_args(argv)

    out = sys.stdout if args.out == "-" else open(args.out, "w")
    for variant in VCFReader(args.vcf):
        info = variant.info
        required = ["INFRAME_PGEOM", "INFRAME_DOWN", "INFRAME_UP",
                    "OUTFRAME_PGEOM", "OUTFRAME_DOWN", "OUTFRAME_UP",
                    "START", "END", "PERIOD"]
        if any(k not in info for k in required):
            continue
        out.write("\t".join([
            variant.chrom, str(int(info["START"]) - 1), info["END"],
            info["INFRAME_PGEOM"], info["INFRAME_DOWN"], info["INFRAME_UP"],
            info["OUTFRAME_PGEOM"], info["OUTFRAME_DOWN"],
            info["OUTFRAME_UP"], info["PERIOD"]]) + "\n")
    if out is not sys.stdout:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
