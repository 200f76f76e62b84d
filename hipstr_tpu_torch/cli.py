"""hipstr-tpu-torch command line: `python -m hipstr_tpu_torch.cli`.

The JAX package's flag table (hipstr_tpu.cli.build_parser) plus
`--device cuda|cpu` (default cuda; `cuda` without a visible card is an
error).  The batched in-process run (`--batch-loci N`, N > 0, with a
stutter model) and the sequential run (`--batch-loci 0`, with a model or
the host stutter EM) are ported; the options whose paths are not ported
yet stop with a "not yet ported" error and a non-zero exit rather than
fall back.
"""

from __future__ import annotations

import sys

from .device import resolve
from .host import (GenotyperPipeline, Logger, OutputConfig, PipelineOptions,
                   StutterModel, build_parser)


def _parser():
    ap = build_parser()
    ap.prog = "hipstr-tpu-torch"
    ap.description = "STR genotyper (HipSTR-compatible), PyTorch/CUDA port"
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="Torch device for the alignment kernels "
                         "(default cuda; never falls back to the CPU)")
    return ap


def not_ported(args) -> str:
    """The first requested option whose path is not ported, or ''."""
    batched = args.batch_loci > 0
    if args.workers > 1:
        return "--workers"
    if args.host_workers > 1 and batched:
        # the JAX CLI pools host workers only for batched runs
        return "--host-workers > 1"
    if args.distributed:
        return "--distributed"
    if args.profile:
        return "--profile"
    if args.platform:
        return "--platform (use --device)"
    if batched and not args.def_stutter_model and not args.stutter_in:
        return ("the batched stutter EM (pass --def-stutter-model or "
                "--stutter-in, or run sequentially with --batch-loci 0)")
    return ""


class UsageError(Exception):
    """A command line the port refuses; main() prints it and exits 1."""


def run(argv=None):
    """Parse `argv` and run the batched or (`--batch-loci 0`) sequential
    pipeline; returns (pipeline, counters).  Raises UsageError for a refused command line; device and
    kernel errors propagate."""
    args = _parser().parse_args(argv)
    missing = not_ported(args)
    if missing:
        raise UsageError(f"{missing} is not yet ported to hipstr_tpu_torch")
    device, _ = resolve(args.device, args.dtype)

    if args.bams:
        bam_paths = args.bams.split(",")
    elif args.bam_files:
        with open(args.bam_files) as fh:
            bam_paths = [l.strip() for l in fh if l.strip()]
    else:
        raise UsageError("--bams or --bam-files is required")
    if not args.str_vcf and not args.skip_genotyping:
        raise UsageError("--str-vcf option required (or use "
                         "--skip-genotyping)")

    cfg = OutputConfig(
        output_gls=args.output_gls, output_pls=args.output_pls,
        output_phased_gls=args.output_phased_gls,
        output_filters=args.output_filters,
        output_haplotype_data=args.output_hap_fields,
        output_allreads=not args.hide_allreads,
        output_mallreads=not args.hide_mallreads,
        viz_left_alns=args.viz_left_alns,
        max_flank_indel_frac=args.max_flank_indel)

    def_model = None
    if args.def_stutter_model:
        def_model = StutterModel(0.95, 0.05, 0.05, 0.95, 0.01, 0.01, 2)

    haploid_chroms = [c for c in args.haploid_chrs.split(",") if c]
    if args.hap_chr_file:
        with open(args.hap_chr_file) as fh:
            haploid_chroms.extend(l.strip() for l in fh if l.strip())

    opts = PipelineOptions(
        min_reads=args.min_reads, max_reads=args.max_reads,
        max_str_len=args.max_str_len, use_unpaired=args.use_unpaired,
        remove_pcr_dups=not args.no_rmdup, def_stutter_model=def_model,
        stutter_in=args.stutter_in, stutter_out=args.stutter_out,
        haploid_chroms=tuple(haploid_chroms),
        max_haps=args.max_haps, max_hap_flanks=args.max_hap_flanks,
        min_flank_freq=args.min_flank_freq, chrom=args.chrom,
        max_regions=args.max_regions, dtype=args.dtype,
        snp_vcf=args.snp_vcf, ref_vcf=args.ref_vcf, fam_file=args.fam,
        viz_out=args.viz_out,
        locus_shard=(tuple(int(x) for x in args.locus_shard.split("/"))
                     if args.locus_shard else None),
        max_mate_dist=args.max_mate_dist,
        base_qual_trim=args.read_qual_trim,
        sample_set=(tuple(args.sample_list.split(","))
                    if args.sample_list else None),
        pass_bam=args.pass_bam, filt_bam=args.filt_bam,
        skip_genotyping=args.skip_genotyping,
        bams_from_10x=args.bams_from_10x, output=cfg)

    log_stream = open(args.log, "w") if args.log else sys.stderr
    logger = Logger(log_stream, quiet=args.quiet or args.silent)
    bam_samps = args.bam_samps.split(",") if args.bam_samps else None
    bam_libs = args.bam_libs.split(",") if args.bam_libs else None

    pipeline = GenotyperPipeline(bam_paths, args.fasta, opts, logger,
                                 bam_samps, bam_libs,
                                 lib_field=args.lib_field)
    if args.batch_loci > 0:
        from .parallel.executor import run_batched
        counters = run_batched(pipeline, args.regions, args.str_vcf, device,
                               batch_size=args.batch_loci,
                               full_command=" ".join(sys.argv))
    else:
        from .pipeline.sequential import run_sequential
        counters = run_sequential(pipeline, args.regions, args.str_vcf,
                                  device, full_command=" ".join(sys.argv))
    logger.quiet = args.silent
    logger.log(pipeline.timer.summary())
    logger.log(
        f"Summary: success={counters.genotype_success} "
        f"fail={counters.genotype_fail} "
        f"too_few_reads={counters.too_few_reads} "
        f"too_many_reads={counters.too_many_reads} "
        f"too_long={counters.too_long} em_fail={counters.em_fail} "
        f"missing_model={counters.missing_model}")
    if args.log:
        log_stream.close()
    return pipeline, counters


def main(argv=None) -> int:
    try:
        run(argv)
    except UsageError as exc:
        print(f"ERROR: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
