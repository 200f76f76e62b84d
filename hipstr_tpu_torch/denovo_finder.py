"""DenovoFinder command line interface of the PyTorch port:
`python -m hipstr_tpu_torch.denovo_finder`.

The JAX package's DenovoFinder (hipstr_tpu/denovo_finder.py) with
`--platform` replaced by `--device cuda|cpu` (default cuda, resolved by
`device.resolve_device`: `cuda` without a visible card is an error, and
nothing falls back to the CPU).  Capability parity with the reference
DenovoFinder (reference: src/denovos/denovo_main.cpp): loads a FAM pedigree
+ HipSTR STR VCF (+SNP VCF), runs the family scan (phased GLs + SNP
transmission) or the trio scan (unphased GLs), and writes a
per-family/per-child VCF of mutation log-likelihoods.
"""

from __future__ import annotations

import argparse
import sys

from .denovo.scanner import DenovoScanner, TrioDenovoScanner
from .device import resolve_device
from .io.vcf_read import VCFReader
from .phasing.pedigree import extract_pedigree_nuclear_families


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="denovo-finder-torch",
        description="Scan HipSTR VCFs + pedigrees for de novo STR mutations")
    ap.add_argument("--fam", required=True, help="FAM pedigree file")
    ap.add_argument("--str-vcf", required=True,
                    help="HipSTR STR VCF with GL/PHASEDGL fields")
    ap.add_argument("--snp-vcf",
                    help="Phased SNP VCF (enables the family scan; without "
                         "it the unphased trio scan runs)")
    ap.add_argument("--denovo-vcf", required=True, help="Output VCF path")
    ap.add_argument("--uniform-prior", action="store_true",
                    help="Use uniform parental allele priors instead of the "
                         "default founder-frequency priors (reference: "
                         "denovo_main.cpp:170 — population priors are the "
                         "default, --uniform-prior opts out)")
    ap.add_argument("--device-batch", type=int, default=-1,
                    help="Evaluate N (record, family) likelihood jobs per "
                         "batched dispatch on --device (0 = per-family host "
                         "path; default: 256 on cuda, 0 on cpu)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="Torch device of the batched jobs (default cuda; "
                         "never falls back to the CPU)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    str_vcf = VCFReader(args.str_vcf)
    families = extract_pedigree_nuclear_families(args.fam,
                                                 set(str_vcf.samples))
    if not families:
        print("ERROR: no usable nuclear families in pedigree", file=sys.stderr)
        return 1

    device_batch = args.device_batch
    if device_batch < 0:
        device_batch = 256 if device.type == "cuda" else 0

    out = open(args.denovo_vcf, "w")
    cmd = " ".join(sys.argv)
    use_pop = not args.uniform_prior
    if args.snp_vcf:
        scanner = DenovoScanner(families, out, use_pop, device)
        scanner.write_vcf_header(cmd)
        scanner.scan(VCFReader(args.snp_vcf), str_vcf,
                     device_batch=device_batch)
    else:
        scanner = TrioDenovoScanner(families, out, use_pop, device)
        scanner.write_vcf_header(cmd)
        scanner.scan(str_vcf, device_batch=device_batch)
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
